"""rs544_decode_roofline: the RS decode kernel's share of its roofline
at ten-bit symbols, the least time of a launch from the reference's
corrections a row over the mean device time of `rs_decode_kernel` in the
profiled stretch.  Bytes (`decode_bytes`) at 2 a symbol; operations
`roofline.rs_ops` with Chien counted over the n locations of the
shortened codeword, not all 2^m - 1 points, so that a decoder that sweeps
only the word reads no more than its work."""

from fecbench import roofline

KERNEL = "rs_decode_kernel"


def decode_bytes(rows: int, n: int, nr: int) -> int:
    """A launch from syndromes: each row's n symbols read and written, 2
    bytes a symbol, its nr int32 log-form syndromes read, a verdict and a
    count written."""
    return rows * (2 * n + 4 * nr + 2 * n + 1 + 4)


def read(ctx):
    n = int(ctx.config["data_symbols"]) + ctx.reference.nr
    nr = ctx.reference.nr
    return roofline.kernel_share(ctx, KERNEL, [
        roofline.bound(decode_bytes(len(x["corrected"]), n, nr),
                       roofline.rs_ops(nr, n, n, x["corrected"], syndromes=False))
        for x in ctx.launches])
