"""rs_decode_roofline: the RS decode kernel's share of its roofline,
the least time of a launch from the reference's corrections a row
(fecbench/roofline.py) over its mean device time in the profiled
stretch."""

from fecbench import roofline


def read(ctx):
    ref = ctx.reference
    return roofline.kernel_share(ctx, "rs_decode_kernel", [
        roofline.rs_decode_bound(ref.fs, ref.nr, ref.fs, launch["corrected"])
        for launch in ctx.launches])
