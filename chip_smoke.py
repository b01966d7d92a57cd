#!/usr/bin/env python3
"""On-card smoke test of libpoporon_tpu_torch, the PyTorch and CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (at first use), drives the
RS(255,223) main path through the public facade at B = 131072 codewords
(encode, flip 2 symbols per row, decode), checks that the decode went
through the kernel, holds the kernel against its plain PyTorch version on
the card in all three decode modes, and times both.  Every phase raises on
failure, and the script then exits non-zero.  It exits non-zero without a
result when torch sees no CUDA device.  It never imports jax.

Output: `# {json}` lines with the timings (card name and power limit in
each), then one line `{"kernels": [...]}`, and as the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BATCH = 131072          # bench.py's headline batch
WARMUP, ITERS = 3, 10   # CUDA-event timing


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(obj) -> None:
    print("# " + json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *args) -> float:
    """Mean milliseconds per call, by CUDA events over ITERS calls."""
    import torch
    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def corrupt(rng, data, parity, nerr, junk_rows=0, parity_only_rows=0):
    """Flip nerr[i] random symbols of codeword i (data and parity), then
    make the last junk_rows rows random and give the parity_only_rows rows
    after the first three parity errors and nothing else."""
    data, parity = data.copy(), parity.copy()
    B, size = data.shape
    n = size + parity.shape[1]
    for i in range(B):
        for q in rng.choice(n, min(int(nerr[i]), n), replace=False):
            v = int(rng.integers(1, 256))
            if q < size:
                data[i, q] ^= v
            else:
                parity[i, q - size] ^= v
    if junk_rows:
        data[-junk_rows:] = rng.integers(0, 256, (junk_rows, size), dtype=np.uint8)
    for i in range(parity_only_rows):
        parity[i, rng.choice(parity.shape[1], 3, replace=False)] ^= 0x5A
    return data, parity


def erasure_case(rng, data, E, extra):
    """E erasure positions per row, all corrupted, plus `extra` random
    errors outside them; the position array is exactly E wide."""
    B, size = data.shape
    bad = data.copy()
    pos = np.zeros((B, E), np.int32)
    for i in range(B):
        p = rng.choice(size, min(E + extra, size), replace=False)
        pos[i, : min(E, len(p))] = p[:E]
        bad[i, p] ^= rng.integers(1, 256, len(p)).astype(np.uint8)
    return bad, pos, np.full(B, E, np.int32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import libpoporon_tpu_torch as pt
    from libpoporon_tpu_torch.models.rs import RSCodec, _encode_np
    from libpoporon_tpu_torch.utils import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_info()
    print(card, flush=True)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0], "card": card})

    # ---- phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log({"phase": "build", "seconds": build_s, "library": so.name, "ptxas": ptxas})

    # ---- phase 2: the main path through the facade, B = 131072
    rng = np.random.default_rng(0)
    codec = pt.create(pt.rs_config_default(), device="cuda")
    kern = codec._rs.kernel
    check(kern is not None, "default RS config has no kernel")
    data = rng.integers(0, 256, (BATCH, 223), dtype=np.uint8)
    rows = np.arange(BATCH)
    pos0 = rng.integers(0, 223, BATCH)
    pos1 = (pos0 + rng.integers(1, 223, BATCH)) % 223   # distinct from pos0
    bad = data.copy()
    bad[rows, pos0] ^= 0x55
    bad[rows, pos1] ^= 0xAA

    kern.launches = 0
    t0 = time.perf_counter()
    enc = codec.encode(data)
    res = codec.decode(bad, enc.parity)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = kern.launches
    check(launches >= 1, "the main path's decode did not launch the kernel")
    check(res.ok.device.type == "cuda", "result not on the card")
    check(tuple(res.data.shape) == (BATCH, 223), f"data shape {tuple(res.data.shape)}")
    check(bool(res.ok.all()), f"{int((~res.ok).sum())} rows not recovered")
    check(np.array_equal(res.data.cpu().numpy(), data), "decoded data != original")
    check(torch.equal(res.parity, enc.parity), "decoded parity != encoded parity")
    check(bool((res.corrected == 2).all()), "corrected != 2")
    rs = codec._rs
    ref = _encode_np(rs.gf, rs.genlog, rs.num_roots, data[:256].astype(np.int64))
    check(np.array_equal(enc.parity[:256].cpu().numpy(), ref),
          "encode != NumPy LFSR reference")
    log({"phase": "main_path", "batch": BATCH, "seconds_with_transfers": main_s,
         "launches": launches, "all_ok": True, "corrected": 2})

    # ---- phase 3: kernel against its plain version, on the card
    max_err = 0
    cases = 0

    def compare(tag, rs_, mode, d, p, *extra):
        nonlocal max_err, cases
        k = rs_.kernel
        args = [torch.as_tensor(a, device=dev) for a in (d, p, *extra)]
        if mode == "plain":
            got, want = k.decode_plain(*args), rs_._decode_plain(*args)
        elif mode == "erasure":
            got, want = k.decode_erasure(*args), rs_._decode_erasure(*args)
        else:
            got, want = k.decode_ext(*args), rs_._decode_ext_syndrome(*args)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  if a.numel() else 0 for a, b in zip(got, want))
        max_err = max(max_err, err)
        cases += 1
        check(err == 0, f"kernel != plain in {tag} (max abs err {err})")

    configs = [
        ("default", pt.rs_config_default()),
        ("fcr0", pt.RSConfig(first_consecutive_root=0)),
        ("prim2", pt.RSConfig(primitive_element=2)),
        ("nr16", pt.RSConfig(num_roots=16)),
        ("nr64", pt.RSConfig(num_roots=64)),
    ]
    for name, cfg in configs:
        rs_ = RSCodec(cfg, dev)
        check(rs_.kernel is not None, f"{name}: no kernel")
        nr, k = rs_.num_roots, rs_.k
        shapes = [(4096, k)] + ([(1, k), (1000, k), (1000, 1), (1000, 100),
                                 (1000, 222)] if name == "default" else [])
        for B, size in shapes:
            d = rng.integers(0, 256, (B, size), dtype=np.uint8)
            p = rs_.encode(d).cpu().numpy()
            nerr = rng.integers(0, nr // 2 + 1, B)       # clean .. t errors
            nerr[: B // 8] = 0
            junk = B // 16
            parity_only = B // 16
            nerr[:parity_only] = 0
            bd, bp = corrupt(rng, d, p, nerr, junk, parity_only)
            compare(f"{name} plain B={B} size={size}", rs_, "plain", bd, bp)
            sl = rs_.exp2log[rs_._syndrome(torch.as_tensor(bd, device=dev),
                                           torch.as_tensor(bp, device=dev)).long()]
            compare(f"{name} ext B={B} size={size}", rs_, "ext", bd, bp,
                    sl.to(torch.int32).cpu().numpy())
            if size < 8:
                continue
            for E, extra in ((min(32, nr), 0), (7, 3)):   # (7, 3): the F1 input
                be, pos, cnt = erasure_case(rng, d, E, extra)
                compare(f"{name} erasure E={E}+{extra} B={B} size={size}",
                        rs_, "erasure", be, p, pos, cnt)
    log({"phase": "kernel_vs_plain", "cases": cases, "max_abs_err": max_err})

    # ---- phase 4: timing at B = 131072 on the card
    common = {"batch": BATCH, "card": card, "warmup": WARMUP, "iters": ITERS}

    def kernel_vs_plain(bench, kernel_fn, plain_fn, *args):
        """Times both in the order plain, kernel, kernel, plain; checks
        that they agree and that every row decoded to the original."""
        got, want = kernel_fn(*args), plain_fn(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{bench}: kernel != plain")
        check(bool(got[0].all()) and torch.equal(got[1], data_dev),
              f"{bench}: rows not recovered")
        t_plain = [time_ms(plain_fn, *args)]
        t_kern = [time_ms(kernel_fn, *args), time_ms(kernel_fn, *args)]
        t_plain.append(time_ms(plain_fn, *args))
        ms, plain_ms = sum(t_kern) / 2, sum(t_plain) / 2
        log({"bench": bench, "kernel_ms": ms, "plain_ms": plain_ms,
             "kernel_runs_ms": t_kern, "plain_runs_ms": t_plain,
             "kernel_codewords_per_s": BATCH / ms * 1e3,
             "plain_codewords_per_s": BATCH / plain_ms * 1e3, **common})
        return ms, plain_ms

    data_dev = torch.as_tensor(data, device=dev)
    d_dev, p_dev = torch.as_tensor(bad, device=dev), enc.parity
    ms, plain_ms = kernel_vs_plain("rs_decode_2err", kern.decode_plain,
                                   rs._decode_plain, d_dev, p_dev)
    # 32 erasures at the same positions in every row, as bench.py does
    epos = np.sort(rng.choice(223, 32, replace=False)).astype(np.int32)
    eras = data.copy()
    eras[:, epos] ^= 0xFF
    kernel_vs_plain("rs_erasure_32", kern.decode_erasure, rs._decode_erasure,
                    torch.as_tensor(eras, device=dev), p_dev,
                    torch.as_tensor(epos, device=dev).expand(BATCH, 32).contiguous(),
                    torch.full((BATCH,), 32, dtype=torch.int32, device=dev))
    s_log = rs.exp2log[rs._syndrome(d_dev, p_dev).long()]
    kernel_vs_plain("rs_ext_syndrome", kern.decode_ext, rs._decode_ext_syndrome,
                    d_dev, p_dev, s_log)

    off = pt.create(pt.RSConfig(use_kernel="off"), device="cuda")
    check(off._rs.kernel is None, "use_kernel='off' still has a kernel")
    for name, c in (("auto", codec), ("off", off)):
        t = time_ms(c.decode, d_dev, p_dev)
        log({"bench": "rs_decode_2err_facade", "use_kernel": name, "ms": t,
             "codewords_per_s": BATCH / t * 1e3, **common})
    t = time_ms(codec.encode, data_dev)
    log({"bench": "rs_encode_facade", "ms": t,
         "codewords_per_s": BATCH / t * 1e3, **common})

    print(json.dumps({"kernels": [{
        "name": "rs_decode",
        "route": "cuda",
        "source": "libpoporon_tpu_torch/csrc/rs_decode.cu",
        "replaces": "libpoporon_tpu/models/rs_pallas.py:158",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
