"""Device mesh and sharding helpers (counterpart of
libpoporon_tpu/parallel/mesh.py).

The scaling model is the JAX package's: a 1-D mesh over all devices with
the codeword batch split across it.  Codewords are independent, so the
data path moves nothing between devices; the only collectives are the
statistics reductions of `stats.py`, through `torch.distributed`.

Here a mesh is a tuple of torch devices, one per shard, and a process
drives every device of its mesh itself.  Across processes (one per host,
or one per card) `distributed_init` opens the process group that the
statistics reduce over.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one torch device per shard, on the single axis
    "batch".  `devices`, `axis_names` and `shape["batch"]` read as a JAX
    mesh's do."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (BATCH_AXIS,)

    @property
    def shape(self) -> dict[str, int]:
        return {BATCH_AXIS: len(self.devices)}


def canonical_device(device) -> torch.device:
    """torch.device(device), with "cuda" resolved to the current card's
    index so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str = "nccl",
                     timeout: datetime.timedelta = datetime.timedelta(minutes=10)) -> None:
    """Open the process group of a multi-process run: one call per
    process, before the statistics reduce across processes.

    No-op unless num_processes > 1, as in the JAX package.  coordinator
    is "host:port" of rank 0; the group rendezvous there over TCP.  The
    default backend is NCCL, for tensors on the card; pass "gloo" for
    CPU tensors.
    """
    if num_processes is not None and num_processes > 1:
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id, timeout=timeout)


def batch_mesh(devices=None) -> Mesh:
    """1-D mesh with a single "batch" axis over every visible card
    (cuda:0 .. cuda:{device_count() - 1}) or over `devices`.

    Without a card the default raises; the CPU runs only when asked for
    (devices=["cpu"] * 8 is the counterpart of the JAX tests' 8 virtual
    CPU devices).  A device may appear more than once: that is how one
    card, or the CPU, runs several shards.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("batch_mesh() spans the visible cards, and torch sees no "
                               "CUDA device; pass devices=[...] to ask for others")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


# batch_sharding and replicated (the JAX module's XLA sharding annotations)
# have no PyTorch counterpart: shards here are tensors placed explicitly.


def shard_batch(x, mesh: Mesh) -> list[torch.Tensor]:
    """A [B, ...] array or tensor as n contiguous equal shards, shard i on
    mesh.devices[i].  B must divide by n, as JAX's device_put requires.
    An array is copied; a tensor's shards on its own device are views."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    n = len(mesh.devices)
    if x.ndim == 0 or x.shape[0] % n:
        raise ValueError(f"batch of shape {tuple(x.shape)} does not split into {n} "
                         "equal shards")
    return [s.to(d) for s, d in zip(x.tensor_split(n), mesh.devices)]


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad the batch axis with zero rows so it divides the mesh; returns
    (padded, orig_len).  A tensor is padded on its device; anything else
    as a NumPy array."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = rem
        return torch.cat([x, x.new_zeros(shape)], dim=axis), n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(np.asarray(x), pad_width), n
