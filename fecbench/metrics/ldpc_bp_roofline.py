"""ldpc_bp_roofline: the LDPC BP kernel's share of its roofline, the
least time of a launch from the reference's verdicts and iterations a
row (fecbench/roofline.py) over its mean device time in the profiled
stretch, launches on every card together."""

from fecbench import roofline


def read(ctx):
    ref = ctx.reference
    return roofline.kernel_share(ctx, "ldpc_bp_kernel", [
        roofline.ldpc_bp_bound(ref.E, ref.codeword_bits, launch["ok"], launch["corrected"])
        for launch in ctx.launches])
