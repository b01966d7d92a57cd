"""Sharded end-to-end codec pipelines (counterpart of
libpoporon_tpu/parallel/pipeline.py).

`ShardedCodec` wraps a facade `Codec` and runs it with the codeword batch
split over a mesh: the batch is padded with zero rows to a multiple of
the mesh, shard i runs on mesh device i through a `Codec` of the same
config on that device, and the shards' outputs are joined on the mesh's
first device and trimmed to the caller's batch.  Every shard is issued
before any is joined, so shards on different cards run at once.

`ldpc_decode_step` also sums the decode's statistics over the mesh and,
given a process group, across processes: the only collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FecType
from ..erasure import Erasure
from ..facade import Codec, DecodeResult, EncodeResult
from ..utils.profiling import span
from .mesh import BATCH_AXIS, batch_mesh, canonical_device, pad_to_multiple, shard_batch
from .stats import _reduce


def _rows(x):
    """x as a tensor (an array-like is copied), or None."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x))


class ShardedCodec:
    def __init__(self, codec: Codec, mesh=None, group=None):
        """codec: the facade codec to shard; mesh: a `batch_mesh` (default
        every visible card); group: the process group ldpc_decode_step
        sums its statistics over (None: this process's mesh alone)."""
        self.codec = codec
        self.mesh = mesh if mesh is not None else batch_mesh()
        self.n_devices = self.mesh.shape[BATCH_AXIS]
        self.group = group
        # one codec per distinct device; the caller's where its device is
        # in the mesh (the host tables are shared through the models' caches)
        own = canonical_device(codec.device)
        self.codecs = {}
        for d in self.mesh.devices:
            if d not in self.codecs:
                self.codecs[d] = codec if d == own else Codec(codec.config, device=d)

    def _pad(self, x):
        return pad_to_multiple(_rows(x), self.n_devices)

    def _run(self, fn, shards):
        """fn(codec, *shard_args) on each device's codec, every shard
        issued before any result is read."""
        return [fn(self.codecs[d], *args) for d, args in zip(self.mesh.devices, shards)]

    def _join(self, parts, n):
        """Each field of the shards' results concatenated on the mesh's
        first device, trimmed to the caller's n rows."""
        dev = self.mesh.devices[0]
        return [torch.cat([t.to(dev) for t in field])[:n] for field in zip(*parts)]

    def _per_row(self, name, value, B, n):
        """A keyword's value for each shard: per-row arrays ([B, ...], or
        the arrays of a tuple such as erasures=(positions, counts)) split
        with the rows, anything else shared.  A per-row array cannot meet a
        padded batch, and raises there as the JAX package does."""
        if value is None or isinstance(value, Erasure):
            return [value] * self.n_devices
        if not isinstance(value, tuple) and _rows(value).ndim < 2:
            return [value] * self.n_devices
        parts = [_rows(p) for p in (value if isinstance(value, tuple) else (value,))]
        for p in parts:
            if p.ndim == 0 or p.shape[0] != n or n != B:
                raise ValueError(
                    f"{name}: a per-row array of shape {tuple(p.shape)} against a batch "
                    f"of {n} rows padded to {B} (Incompatible shapes for broadcasting)")
        split = [shard_batch(p, self.mesh) for p in parts]
        if isinstance(value, tuple):
            return [tuple(s) for s in zip(*split)]
        return split[0]

    def encode(self, data) -> EncodeResult:
        data, n = self._pad(data)
        parts = self._run(lambda c, x: c.encode(x), zip(shard_batch(data, self.mesh)))
        return EncodeResult(*self._join(parts, n))

    def decode(self, data, parity, **kw) -> DecodeResult:
        """The facade's decode, sharded: data, parity and soft_llr are
        padded and split; every other keyword goes to each shard (see
        _per_row)."""
        with span("poporon.shard.decode"):
            with span("poporon.shard.split"):
                data, n = self._pad(data)
                parity, _ = self._pad(parity)
                B = data.shape[0]
                columns = [shard_batch(data, self.mesh), shard_batch(parity, self.mesh)]
                names = []
                for name, value in kw.items():
                    if name == "soft_llr" and value is not None:
                        columns.append(shard_batch(self._pad(value)[0], self.mesh))
                    else:
                        columns.append(self._per_row(name, value, B, n))
                    names.append(name)
            parts = self._run(lambda c, d, p, *rest: c.decode(d, p, **dict(zip(names, rest))),
                              zip(*columns))
            with span("poporon.shard.join"):
                return DecodeResult(*self._join(parts, n))

    def ldpc_decode_step(self, codeword, reference_bits=None):
        """One LDPC hard-decode step over the mesh with summed statistics.

        codeword: uint8 [B, codeword_bytes].  Each shard runs
        `LDPCCodec.decode_hard` at the config's max_iterations.  Returns
        (ok, codeword_out, iters, stats): stats = dict(converged,
        iterations_total), ints summed over the padded batch as the JAX
        package's psum sums them (a zero pad row is a codeword: ok at 0
        iterations), over every shard and, with a group, every process.
        reference_bits is accepted and unused, as in the JAX package.
        """
        if self.codec.fec_type != FecType.LDPC:
            raise ValueError(f"ldpc_decode_step needs an LDPC codec, got {self.codec.fec_type}")
        max_it = self.codec._ldpc.max_iterations
        cw, n = self._pad(codeword)
        parts = self._run(lambda c, x: c._ldpc.decode_hard(x, max_it),
                          zip(shard_batch(cw, self.mesh)))
        dev = self.mesh.devices[0]
        sums = torch.stack([torch.stack([ok.sum(), it.to(torch.int64).sum()]).to(dev)
                            for ok, _, it in parts]).sum(dim=0)
        n_ok, it_sum = _reduce(sums, self.group).tolist()
        ok, out, iters = self._join(parts, n)
        return ok, out, iters, dict(converged=int(n_ok), iterations_total=int(it_sum))
