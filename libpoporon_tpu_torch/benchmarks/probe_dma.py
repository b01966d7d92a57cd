"""Row-gather and contiguous-copy throughput, device memory -> shared
memory, on the card.

Counterpart of benchmarks/probe_dma.py, the design probe for an LDPC BP
kernel whose messages live in device memory: can row-granular bulk copies
of [sub, 128] int32 rows (4/8/16 KB at sub 8/16/32) sustain a useful share
of the card's memory rate?  The three probes, each a hand-written CUDA
kernel (csrc/probe_dma.cu) with the JAX function's name and arguments:

  * gather_flood: `rows` rows by `idx`, one barrier, wait once per wave
  * gather_ring:  the same gather with a depth-D ring (start k, wait k-D)
  * plane_copy:   the contiguous bound, src[0 : rows*sub]

Each returns (out, checksum, landed): out is the [8, 128] int32 block the
JAX function returns (the first 8 sublanes of the first gathered row, or
src[0:8]), checksum a 0-d int64 tensor holding the wrapping uint32 sum of
every word one repeat gathers, landed a 0-d int64 tensor holding the bytes
that arrived over all repeats.  For CPU tensors a wrapper runs its plain
PyTorch version (`gather_plain`, `plane_plain`, which the tests and
chip_smoke.py use); for CUDA tensors it launches the kernel or raises.
`launches` counts kernel launches by probe.

Run on the card (prints one JSON line per measurement, the card's name
and power limit in each):

    python -m libpoporon_tpu_torch.benchmarks.probe_dma

It measures the JAX probe's shapes (65536 source rows of 8 sublanes, 2048
rows gathered, 50 repeats: a gathered set of 8 to 32 MB, which stays in
the 50 MB L2 after the first repeat) and, for each sub, 1 GB gathered from
a 4 GB source, about 18 times the L2, so that repeats read device memory.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils import build
from ..utils.profiling import ThroughputMeter, card_info

LANES = 128
SUBLANE_BYTES = LANES * 4
MODE_FLOOD, MODE_RING, MODE_PLANE = 0, 1, 2
SLOT_BYTES = 192 * 1024     # a block's slot memory (csrc/probe_dma.cu)
MAX_DEPTH = 32
MAX_SUB = SLOT_BYTES // SUBLANE_BYTES

# The JAX probe's shapes (benchmarks/probe_dma.py:184-186).
SOURCE_UNITS = 65536        # source rows of 8 sublanes; 256 MB at every sub
JAX_ROWS, REPEAT = 2048, 50
# The device-memory shapes: a 4 GB source, and rows whose gathered set is
# 1 GB by sub (about 0.9 GB of distinct rows).
HBM_SOURCE_UNITS = 1 << 20
HBM_ROWS = {sub: 2**30 // (sub * SUBLANE_BYTES) for sub in (8, 16, 32)}
L2_BYTES = 50 * 2**20       # the H100's L2

# Kernel launches by probe.
launches = {"gather_flood": 0, "gather_ring": 0, "plane_copy": 0}


def _wrapsum(x: torch.Tensor) -> torch.Tensor:
    """The wrapping uint32 sum of int32 words, as a 0-d int64 tensor."""
    return x.to(torch.int64).sum() & 0xFFFFFFFF


def _landed(rows, sub, repeat):
    return torch.tensor(repeat * rows * sub * SUBLANE_BYTES, dtype=torch.int64)


def gather_plain(idx, src, sub, repeat):
    """Plain version of gather_flood and gather_ring."""
    i = idx.long()
    return (src.view(-1, sub, LANES)[i[0], :8].clone(),
            _wrapsum(src.view(-1, sub * LANES)[i]), _landed(len(i), sub, repeat).to(src.device))


def plane_plain(src, rows, sub, repeat):
    """Plain version of plane_copy."""
    return src[:8].clone(), _wrapsum(src[: rows * sub]), _landed(rows, sub, repeat).to(src.device)


def _check(idx, src, rows, sub, repeat, depth=1):
    if src.dtype != torch.int32 or src.ndim != 2 or src.shape[1] != LANES:
        raise ValueError(f"src must be int32 [N, {LANES}], got {src.dtype} {tuple(src.shape)}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if sub < 8 or sub % 8 or sub > MAX_SUB:
        raise ValueError(f"sub must be a multiple of 8 in 8..{MAX_SUB}, got {sub}")
    if src.shape[0] % sub or src.shape[0] < sub:
        raise ValueError(f"src's {src.shape[0]} sublanes are not whole rows of {sub}")
    if rows < 1 or repeat < 1:
        raise ValueError(f"rows and repeat must be >= 1, got {rows} and {repeat}")
    if not 1 <= depth <= MAX_DEPTH or depth * sub * SUBLANE_BYTES > SLOT_BYTES:
        raise ValueError(f"depth {depth} of {sub}-sublane rows does not fit a block's "
                         f"{SLOT_BYTES} bytes of slots (or exceeds {MAX_DEPTH})")
    if idx is None:
        if rows * sub > src.shape[0]:
            raise ValueError(f"plane of {rows} rows of {sub} exceeds src")
        return
    if idx.dtype != torch.int32 or tuple(idx.shape) != (rows,) or not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous int32 [{rows}], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != src.device:
        raise ValueError(f"idx on {idx.device}, src on {src.device}")


def _launch(name, mode, idx, src, rows, sub, repeat, depth):
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got {dev}")
    if src.data_ptr() % 16:
        raise ValueError("src must be 16-byte aligned for bulk copies")
    out = torch.empty(8, LANES, dtype=torch.int32, device=dev)
    # the kernel adds into the low 32 bits, so the int64 holds the uint32 sum
    checksum = torch.zeros((), dtype=torch.int64, device=dev)
    landed = torch.zeros((), dtype=torch.int64, device=dev)
    build.launch("pp_probe_dma", dev, mode, idx, src, out, checksum, landed,
                 src.shape[0] // sub, rows, sub, repeat, depth)
    launches[name] += 1
    return out, checksum, landed


def gather_flood(idx, src, rows, sub, repeat):
    """Gather `rows` rows of height `sub` (idx: int32 [rows] in [0, N/sub);
    src: int32 [N, 128]), `repeat` times, in waves on one barrier."""
    _check(idx, src, rows, sub, repeat)
    if src.device.type == "cpu":
        return gather_plain(idx, src, sub, repeat)
    return _launch("gather_flood", MODE_FLOOD, idx, src, rows, sub, repeat, 1)


def gather_ring(idx, src, rows, sub, repeat, depth=8):
    """The same gather through a ring of `depth` slots per block."""
    _check(idx, src, rows, sub, repeat, depth)
    if src.device.type == "cpu":
        return gather_plain(idx, src, sub, repeat)
    return _launch("gather_ring", MODE_RING, idx, src, rows, sub, repeat, depth)


def plane_copy(src, rows, sub, repeat):
    """Copy src[0 : rows*sub], `repeat` times, in large contiguous pieces."""
    _check(None, src, rows, sub, repeat)
    if src.device.type == "cpu":
        return plane_plain(src, rows, sub, repeat)
    return _launch("plane_copy", MODE_PLANE, None, src, rows, sub, repeat, 1)


# ------------------------------------------------------------- measure


def source(rng, units, device):
    """src int32 [units*8, 128] in [0, 2^30), made on `device` from a seed
    that rng draws."""
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    return torch.randint(0, 1 << 30, (units * 8, LANES), generator=g, dtype=torch.int32,
                         device=device)


def index(rng, nsrc, rows, device):
    """idx int32 [rows] drawn with replacement from nsrc source rows, as
    the JAX probe draws it."""
    return torch.from_numpy(rng.integers(0, nsrc, (rows,), dtype=np.int32)).to(device)


def run(seed=0, warmup=3, iters=20):
    """Times every probe on the card, for each sub at the JAX shape and at
    the 1 GB gathered set; yields one dict per measurement (probe, shape,
    distinct bytes, ms, Mrows/s, GB/s, ns/row, the card).  Raises where
    torch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_dma measures the card, and torch sees no CUDA device")
    rng = np.random.default_rng(seed)
    card = card_info()
    for sub in (8, 16, 32):
        for units, rows in ((SOURCE_UNITS, JAX_ROWS), (HBM_SOURCE_UNITS, HBM_ROWS[sub])):
            src = None        # free the last source first
            src = source(rng, units, "cuda")
            idx = index(rng, src.shape[0] // sub, rows, "cuda")
            row_bytes = sub * SUBLANE_BYTES
            gathered = rows * row_bytes
            distinct = {"gather": int(torch.unique(idx).numel()) * row_bytes,
                        "plane": gathered}
            probes = [("gather_flood", 0, lambda: gather_flood(idx, src, rows, sub, REPEAT)),
                      ("gather_ring", 8, lambda: gather_ring(idx, src, rows, sub, REPEAT, 8)),
                      ("plane_copy", 0, lambda: plane_copy(src, rows, sub, REPEAT))]
            if sub == 8:
                probes.insert(2, ("gather_ring", 1,
                                  lambda: gather_ring(idx, src, rows, sub, REPEAT, 1)))
            for name, depth, fn in probes:
                meter = ThroughputMeter(rows * REPEAT)
                dt = meter.measure(fn, warmup, iters)["seconds_per_call"]
                d = distinct["plane" if name == "plane_copy" else "gather"]
                yield {"probe": name, "depth": depth, "sub": sub, "row_kb": row_bytes // 1024,
                       "rows": rows, "repeat": REPEAT, "source_mib": src.numel() * 4 / 2**20,
                       "gathered_mib": gathered / 2**20, "distinct_bytes": d,
                       "l2_resident": d <= L2_BYTES, "ms": dt * 1e3,
                       "mrows_per_s": rows * REPEAT / dt / 1e6,
                       "gb_per_s": gathered * REPEAT / dt / 1e9,
                       "ns_per_row": dt / (rows * REPEAT) * 1e9, "card": card}


def main():
    for line in run():
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
