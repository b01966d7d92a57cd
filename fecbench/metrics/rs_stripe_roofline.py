"""rs_stripe_roofline: the RS stripe kernel's share of its roofline, the
least time of a launch, its bytes over the card's memory rate
(fecbench/roofline.py), over the kernel's mean device time in the
profiled stretch.  The counting function is `stripe_bytes`."""

from fecbench import roofline


def stripe_bytes(cells: int, lost: int, columns: int) -> int:
    """A stripe launch's bytes: the surviving cells read once ((n - e) L:
    the lost cells' contents are ignored, so no decoder need read them),
    the e rebuilt cells, ok and corrected written ((e + 2) L), and the
    4-byte count of failed columns."""
    return (cells - lost) * columns + (lost + 2) * columns + 4


def read(ctx):
    return roofline.kernel_share(ctx, "rs_stripe_kernel", [
        roofline.bound(stripe_bytes(x["cells"], x["lost"], x["columns"]), 0)
        for x in ctx.launches])
