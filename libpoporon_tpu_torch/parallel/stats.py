"""Collective statistics: the only cross-device traffic of the port
(counterpart of libpoporon_tpu/parallel/stats.py).

BER and iteration statistics are summed over a process group with
`torch.distributed.all_reduce`; codeword payloads never cross devices.

Contract, the JAX package's: the default scope is the default process
group (`WORLD`), and it MUST be open, or the call raises; it is never
silently turned into a local reduction, which would report one process's
statistics as global ones.  A group passed as `group=` reduces over that
group; `group=None` reduces locally.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _World:
    """The default process group, looked up at call time."""

    def __repr__(self) -> str:
        return "WORLD"


WORLD = _World()


def _resolve_group(group):
    """The process group `group` names: None for a local reduction, the
    default group for WORLD (which raises when no group is open), or the
    group itself."""
    if group is WORLD:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("statistics over WORLD, but no process group is open: "
                               "call distributed_init first, or pass group=None to "
                               "reduce locally")
        return dist.group.WORLD
    return group


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    group = _resolve_group(group)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def ber_stats(bits_ref, bits_out, group=WORLD) -> dict:
    """Bit-error rate over a batch, summed over `group`.

    Returns dict(errors, total, ber): errors and total int64 scalars (one
    all-reduce of the two), ber = errors / max(total, 1) in float32, the
    JAX package's values.
    """
    err = (bits_ref != bits_out).sum()
    counts = _reduce(torch.stack([err, torch.full_like(err, bits_ref.numel())]), group)
    err, tot = counts[0], counts[1]
    return dict(errors=err, total=tot,
                ber=err.to(torch.float32) / tot.clamp(min=1).to(torch.float32))


def iteration_histogram(iters, max_iterations: int, group=WORLD) -> torch.Tensor:
    """int64 [max_iterations + 1]: how many of iters [B] took each count
    0..max_iterations, summed over `group` (scopes as in ber_stats).
    Counts outside that range are dropped, as JAX's one_hot drops them."""
    if iters.ndim != 1:
        raise ValueError(f"iters must be [B], got shape {tuple(iters.shape)}")
    it = iters.to(torch.int64)
    bins = max_iterations + 1
    slot = torch.where((it >= 0) & (it < bins), it, bins)      # bins: the dropped ones
    hist = torch.zeros(bins + 1, dtype=torch.int64, device=it.device)
    hist.scatter_add_(0, slot, torch.ones_like(slot))
    return _reduce(hist[:bins].contiguous(), group)
