"""bch_decode_roofline: the BCH decode kernel's share of its roofline, the
least time of a launch (fecbench/roofline.py `bound`) over the mean
device time of `bch_decode_kernel` in the profiled stretch.  Counted from
the inputs and the reference's corrections a row: `decode_bytes` and
`decode_ops`."""

from fecbench import roofline

KERNEL = "bch_decode_kernel"
# The highest locator degree whose roots a decode finds by formula, with
# no search: degree 1 is a logarithm, 2 and 3 a lookup each in a table of
# the roots of y^2 + y = c and y^3 + y = c.
SOLVED_DEGREE = 3


def decode_bytes(rows: int, data_bytes: int, parity_bytes: int) -> int:
    """A launch's bytes: each row's stored bytes read, its data written,
    a verdict and a count written."""
    return rows * (data_bytes + parity_bytes + data_bytes + 1 + 4)


def decode_ops(n: int, parity_bits: int, t: int, errors) -> float:
    """A launch's operations, errors[i] the bits corrected in row i (L):
    a row's division by g(x) a byte a step, ceil(n / 8) steps of
    ceil(deg g / 32) words, and the remainder's values at the t odd
    roots, a lookup a nibble (t ceil(deg g / 4)); for a row with L > 0,
    Berlekamp-Massey 2t (L + 1) and the verify 4 t L; and a Chien search
    over the word's n positions, 2 n L, only where the locator's degree
    passes SOLVED_DEGREE: up to it the roots come from a formula's few
    lookups, which go uncounted.  A search that stops at its last root is
    not credited (where that root lies is not counted from).  A GF
    product or sum is one operation."""
    L = errors.double()
    per_row = -(-n // 8) * -(-parity_bits // 32) + t * -(-parity_bits // 4)
    chien = (L > SOLVED_DEGREE).double() * 2 * n * L
    return float(L.numel() * per_row
                 + ((L > 0).double() * (2 * t * (L + 1) + 4 * t * L) + chien).sum())


def read(ctx):
    ref = ctx.reference
    return roofline.kernel_share(ctx, KERNEL, [
        roofline.bound(decode_bytes(len(x["corrected"]), ref.info_bytes, ref.parity_bytes),
                       decode_ops(ref.n, ref.pb, ref.t, x["corrected"]))
        for x in ctx.launches])
