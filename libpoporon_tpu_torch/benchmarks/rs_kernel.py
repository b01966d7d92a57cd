"""Time the RS decode kernels on the RS main path's inputs.

    python -m libpoporon_tpu_torch.benchmarks.rs_kernel [ENTRY ...]

At B = 131072 codewords of RS(255,223) (`rs_config_default()`), made
from a seed: the plain decode of rows with 2 symbol errors (`k1_plain`),
the erasure decode of rows with the same 32 erased positions
(`k2_erasure_32`), the external-syndrome decode from their log-form
syndromes (`k3_ext`), the syndrome kernel alone (`syndromes`) and the
facade's decode of the 2-error rows (`facade`); all of them, or the
ENTRY names given.  Each is first checked (the decodes recover every row,
the syndromes equal their plain version), then timed twice with CUDA
events (3 warm-up and 10 timed calls each).  Each line is one JSON
object carrying the card's name and power limit and the package it
imported, so that two trees can be timed against each other in one call
on one card: run this file by path with `PYTHONPATH` set to each tree in
turns (one package of a name per process).  Needs a card and nvcc.

chip_smoke.py's RS timing (phase 4) takes its inputs (`two_errors`,
`erasures_32`), its calls (`calls`) and its timer (`time_in_turns`) from
here, adding the plain versions' times and the bounds.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

import libpoporon_tpu_torch as pt
from libpoporon_tpu_torch.utils import build
from libpoporon_tpu_torch.utils.profiling import card_info, time_ms

BATCH = 131072

# entry -> its kernel call and its plain version, of (facade codec, models.rs.RSCodec)
ENTRIES = {
    "k1_plain": lambda c, rs: (rs.kernel.decode_plain, rs._decode_plain),
    "k2_erasure_32": lambda c, rs: (rs.kernel.decode_erasure, rs._decode_erasure),
    "k3_ext": lambda c, rs: (rs.kernel.decode_ext, rs._decode_ext_syndrome),
    "syndromes": lambda c, rs: (rs.kernel.syndromes, lambda d, p: plain_syndromes(rs, d, p)),
    "facade": lambda c, rs: (c.decode, None),
}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def two_errors(rng, data):
    """data with 2 symbol errors a row at distinct data positions
    (bench.py:152-158)."""
    B, size = data.shape
    rows = np.arange(B)
    pos0 = rng.integers(0, size, B)
    pos1 = (pos0 + rng.integers(1, size, B)) % size   # distinct from pos0
    bad = data.copy()
    bad[rows, pos0] ^= 0x55
    bad[rows, pos1] ^= 0xAA
    return bad


def erasures_32(rng, data):
    """data with the same 32 positions erased in every row
    (bench.py:179-192), and those positions, int32 [32]."""
    epos = np.sort(rng.choice(data.shape[1], 32, replace=False)).astype(np.int32)
    eras = data.copy()
    eras[:, epos] ^= 0xFF
    return eras, epos


def plain_syndromes(rs, d, p):
    """The syndrome kernel's plain version: log-form syndromes int32 [B, nr]."""
    return rs.exp2log[rs._syndrome(d, p).long()]


def calls(codec, bad, parity, eras, epos, names=tuple(ENTRIES)):
    """name -> (kernel call, plain call or None, args) for the entries
    `names`, on parity's device: bad the 2-error rows (`two_errors`),
    parity the originals' (CUDA tensor), eras and epos the 32-erasure rows
    and their positions (`erasures_32`)."""
    rs = codec._rs
    dev = parity.device
    B = parity.shape[0]
    d = torch.as_tensor(bad, device=dev)
    args = {
        "k1_plain": (d, parity),
        "k2_erasure_32": (torch.as_tensor(eras, device=dev), parity,
                          torch.as_tensor(epos, device=dev).expand(B, len(epos)).contiguous(),
                          torch.full((B,), len(epos), dtype=torch.int32, device=dev)),
        "k3_ext": (d, parity, plain_syndromes(rs, d, parity)),
        "syndromes": (d, parity),
        "facade": (d, parity),
    }
    return {name: (*ENTRIES[name](codec, rs), args[name]) for name in names}


def time_in_turns(kernel_fn, plain_fn, args):
    """The call's ms twice, between two of its plain version's where it
    has one (plain, kernel, kernel, plain): (kernel runs, plain runs)."""
    t_plain = [] if plain_fn is None else [time_ms(plain_fn, *args)]
    t_kern = [time_ms(kernel_fn, *args), time_ms(kernel_fn, *args)]
    if plain_fn is not None:
        t_plain.append(time_ms(plain_fn, *args))
    return t_kern, t_plain


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(ENTRIES)
    unknown = set(names) - set(ENTRIES)
    if unknown:
        raise SystemExit(f"unknown entries {sorted(unknown)}; known: {list(ENTRIES)}")
    if not torch.cuda.is_available():
        raise RuntimeError("rs_kernel measures the card, and torch sees no CUDA device")
    dev = torch.device("cuda")
    common = {"card": card_info(), "package": str(build.PACKAGE_DIR), "batch": BATCH}
    rng = np.random.default_rng(0)
    codec = pt.create(pt.rs_config_default(), device="cuda")
    data = rng.integers(0, 256, (BATCH, 223), dtype=np.uint8)
    bad = two_errors(rng, data)
    eras, epos = erasures_32(rng, data)
    parity = codec.encode(torch.as_tensor(data, device=dev)).parity
    want = torch.as_tensor(data, device=dev)

    for name, (fn, plain_fn, args) in calls(codec, bad, parity, eras, epos, names).items():
        got = fn(*args)
        if name == "syndromes":
            good = torch.equal(got, plain_fn(*args))
        else:
            ok, out = (got.ok, got.data) if name == "facade" else got[:2]
            good = bool(ok.all()) and torch.equal(out, want)
        if not good:
            raise RuntimeError(f"{name}: wrong result")
        t, _ = time_in_turns(fn, None, args)
        ms = sum(t) / len(t)
        log({"bench": f"rs_{name}", "ms": ms, "runs_ms": t,
             "codewords_per_s": BATCH / ms * 1e3, **common})
    return 0


if __name__ == "__main__":
    sys.exit(main())
