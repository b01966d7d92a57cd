"""rs544_syndrome_roofline: the ten-bit RS syndrome kernel's share of its
roofline, the least time of a launch (fecbench/roofline.py `bound`) over
the mean device time of `rs_syndrome_wide_kernel` in the profiled
stretch.  Counted from the inputs: `syndrome_bytes` and `syndrome_ops`."""

from fecbench import roofline

KERNEL = "rs_syndrome_wide_kernel"


def syndrome_bytes(rows: int, n: int, nr: int) -> int:
    """A launch's bytes: each row's n symbols read, 2 bytes a symbol, and
    its nr int32 log-form syndromes written."""
    return rows * (2 * n + 4 * nr)


def syndrome_ops(rows: int, n: int, nr: int) -> float:
    """A launch's operations: nr n / 2 a row.  The product of symbol j by
    the fixed powers of all nr syndromes is one lookup in a table of
    position j, and one 32-bit XOR sums two 16-bit syndromes (the byte
    kernel's count, `roofline.syndrome_ops`, at two symbols a word)."""
    return rows * nr * n / 2


def read(ctx):
    n = int(ctx.config["data_symbols"]) + ctx.reference.nr
    nr = ctx.reference.nr
    return roofline.kernel_share(ctx, KERNEL, [
        roofline.bound(syndrome_bytes(len(x["ok"]), n, nr), syndrome_ops(len(x["ok"]), n, nr))
        for x in ctx.launches])
