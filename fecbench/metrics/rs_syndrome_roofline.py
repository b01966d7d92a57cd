"""rs_syndrome_roofline: the RS syndrome kernel's share of its
roofline, the least time of a launch (fecbench/roofline.py) over its mean
device time in the profiled stretch."""

from fecbench import roofline


def read(ctx):
    ref = ctx.reference
    return roofline.kernel_share(ctx, "rs_syndrome_kernel", [
        roofline.rs_syndrome_bound(len(launch["ok"]), ref.fs, ref.nr)
        for launch in ctx.launches])
