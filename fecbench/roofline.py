"""The least time a kernel launch could take on one H100 SXM, and the work
it counts.

A launch's bound is the larger of its bytes over the memory rate and its
integer operations over the INT32 rate; the share of a roofline is that
bound over the launch's measured device time.  Bytes count each input
byte read once and each output byte written once.  Operations are
counted from the run's inputs and from the reference's per-row results
(errors corrected, iterations run, verdicts), never from the program's
outputs or counters, so that the same work reads the same whatever
implements it.  The counting functions are copies of those the port's
smoke test used (`bound`, `syndrome_ops`, `rs_ops`, `ldpc_ops`).
"""

from __future__ import annotations

import torch

# Device memory: NVIDIA's H100 SXM data sheet, 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# INT32 operations: not a published figure.  Derived as 132 SMs x 64 INT32
# lanes a clock (four partitions of 16) x the 1.98 GHz boost clock.
INT_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float) -> dict:
    """The least time of a launch in ms, and which rate binds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def syndrome_ops(nr: int, n: int) -> float:
    """Integer operations of one row's syndromes: nr n / 4.  The product of
    symbol j by the fixed powers of all nr syndromes is one lookup in a
    table of position j, and one 32-bit XOR sums four syndrome bytes."""
    return nr * n / 4


def rs_ops(nr: int, n: int, fs: int, errors: torch.Tensor, erasures: int = 0,
           syndromes: bool = True) -> float:
    """Operations of RS decodes with errors[i] corrections in row i (L, the
    locator's degree): the syndromes unless left out; for rows with errors
    the erasure locator (erasures^2), BM, Chien over all fs points, Omega,
    Forney and the verify of every syndrome, a GF product or sum one
    operation each.  BM needs the discrepancy over L + 1 terms on each of
    its nr - erasures trips, and the update of L + 1 slots of the locator
    and of the b polynomial on the trips whose discrepancy is not zero: at
    most 2 (L - erasures) of them, and no more than the trips BM runs."""
    L = errors.double()
    trips = nr - erasures
    bm = 2 * trips * (L + 1) + 4 * (L + 1) * (2 * (L - erasures)).clamp(0, trips)
    per_row = (syndrome_ops(nr, n) if syndromes else 0) + 2 * fs * L + 5 * L * L + 2 * nr * L
    return float((per_row + (L > 0).double() * (erasures ** 2 + bm)).sum())


def ldpc_ops(E: int, V: int, ok: torch.Tensor, iters: torch.Tensor) -> float:
    """Operations of BP decodes whose row i ran iters[i] iterations and
    ended clean where ok[i]: per row the unpack and v2c fill (V + E) and
    the output (V); per iteration the check update (9 per edge) and the
    var update (4 per edge, 2 per variable); one syndrome (1 per edge) per
    clean verdict."""
    return float(iters.numel() * (2 * V + E) + ok.double().sum() * E
                 + iters.double().sum() * (13 * E + 2 * V))


def rs_syndrome_bound(rows: int, n: int, nr: int) -> dict:
    """The syndrome launch: reads the rows, writes nr int32 logs a row."""
    return bound(rows * (n + 4 * nr), rows * syndrome_ops(nr, n))


def rs_decode_bound(n: int, nr: int, fs: int, errors: torch.Tensor) -> dict:
    """The decode launch from syndromes: reads the rows and their logs,
    writes the rows, a verdict and a count."""
    rows = errors.numel()
    return bound(rows * (n + 4 * nr + n + 1 + 4), rs_ops(nr, n, fs, errors, syndromes=False))


def ldpc_bp_bound(E: int, V: int, ok: torch.Tensor, iters: torch.Tensor) -> dict:
    """A soft BP launch: reads V int8 LLRs a row and the graph (an index
    an edge), writes the packed codeword, a verdict and a count."""
    rows = iters.numel()
    return bound(rows * (V + V // 8 + 1 + 4) + 4 * E, ldpc_ops(E, V, ok, iters))


def kernel_share(ctx, kernel: str, bounds: list[dict]):
    """A kernel's share of its roofline in %: the mean bound of the launches
    the cell cycles through over the mean device time of the launches of
    `kernel` (a substring of the name) in the profiled stretch, with the
    rate that binds and the card's power limit beside it.  None where the
    trace has no such launch."""
    if ctx.trace is None or not bounds:
        return None
    us = [float(e["dur"]) for e in ctx.trace.device
          if e["cat"] == "kernel" and kernel in e["name"]]
    if not us:
        return None
    bound_ms = sum(b["bound_ms"] for b in bounds) / len(bounds)
    by = [b["bound_by"] for b in bounds]
    return {"value": 100 * bound_ms / (sum(us) / len(us) / 1e3),
            "bound_by": max(set(by), key=by.count), "bound_ms": bound_ms,
            "launches": len(us), "power_limit": ctx.power_limit}
