#!/usr/bin/env python3
"""On-card smoke test of libpoporon_tpu_torch, the PyTorch and CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (at first use), then for
each slice of the port:

- RS(255,223): drives the main path through the public facade at
  B = 131072 codewords (encode, flip 2 symbols per row, decode), checks
  that the decode went through the kernel, holds the kernel against its
  plain PyTorch version on the card in all three decode modes, and times
  both.
- LDPC 128-byte rate-1/2: drives the facade at B = 131072 in both
  configurations users run, hard (`LdpcConfig(128, RATE_1_2)`, 4 flipped
  bits a row) and soft (`ldpc_config_default(128, RATE_1_2)`, int8 LLRs
  at about 1e-2 channel BER), checks that both decodes went through the
  BP kernel, holds the kernel's three entries against the plain version
  over six configs, and times kernel, plain version, facade, adaptive
  cascade and encode.

Every phase raises on failure, and the script then exits non-zero.  It
exits non-zero without a result when torch sees no CUDA device.  It never
imports jax.

Output: `# {json}` lines with the timings (card name and power limit in
each), then one line `{"kernels": [...]}`, and as the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
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


def time_ms(fn, *args, warmup=WARMUP, iters=ITERS) -> float:
    """Mean milliseconds per call, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> int:
    """Largest |a - b| over the paired tensors of two results."""
    import torch
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


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


# ------------------------------------------------------------ LDPC slice

LDPC_MI = 50        # the reference's default iteration budget (ldpc.c:23)
LDPC_CASE_BATCHES = (1, 1000, 4097)     # phase 6: one row, ragged, > 4 * 1024


def distinct_positions(rng, rows, n, k):
    """[rows, k] positions in [0, n), distinct within each row (rows with a
    repeat are drawn again): uniform, like bench.py's argsort draw
    (bench.py:235), without its [rows, n] array of floats."""
    pos = rng.integers(0, n, (rows, k))
    while True:
        s = np.sort(pos, axis=1)
        dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup.any():
            return pos
        pos[dup] = rng.integers(0, n, (int(dup.sum()), k))


def flip_bits(word, pos, count=None):
    """A copy of word (uint8 [B, bytes], bits MSB-first) with the bits at
    pos [B, k] flipped; only the first count[i] of row i where given."""
    word = word.copy()
    use = (np.ones(pos.shape, bool) if count is None
           else np.arange(pos.shape[1]) < count[:, None])
    rows, p = np.nonzero(use)[0], pos[use]
    np.bitwise_xor.at(word, (rows, p // 8), (1 << (7 - p % 8)).astype(np.uint8))
    return word


def channel_llr(word, nbits, sigma, seed):
    """int8 channel LLRs of a transmitted word (uint8 tensor [B, bytes]):
    +-90 by bit (negative = 1) plus N(0, sigma), rounded and clipped, as
    bench.py:265-268 makes them, with the noise drawn on the word's device
    from a seeded generator.  sigma 38.6 gives about 1e-2 channel BER."""
    import torch
    from libpoporon_tpu_torch.utils import bits
    g = torch.Generator(device=word.device).manual_seed(seed)
    sign = 1 - 2 * bits.unpack(word, nbits).to(torch.float32)
    noise = torch.randn(sign.shape, generator=g, device=word.device) * sigma
    return (sign * 90 + noise).round().clamp(-127, 127).to(torch.int8)


def ldpc_main_path(pt, dev, rng):
    """Phase 5: the LDPC main path through the facade at B = BATCH, hard
    and soft, with the kernels' counts read around it; the decoded rows
    are checked against the original info and, for the first rows, against
    the facade on CPU tensors (the plain version).  Returns the codecs and
    the inputs for the timing phase."""
    import torch
    from libpoporon_tpu_torch.utils import bits
    hard = pt.create(pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), device="cuda")
    soft = pt.create(pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), device="cuda")
    kernels = [hard._ldpc.kernel, soft._ldpc.kernel]
    check(all(k is not None for k in kernels), "an LDPC main-path config has no kernel")
    info = rng.integers(0, 256, (BATCH, 128), dtype=np.uint8)
    pos = distinct_positions(rng, BATCH, 2048, 4)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    enc_h = hard.encode(info)
    word = np.concatenate([enc_h.data.cpu().numpy(), enc_h.parity.cpu().numpy()], axis=1)
    bad = flip_bits(word, pos)
    res_h = hard.decode(bad[:, :128], bad[:, 128:])
    enc_s = soft.encode(info)
    tx = torch.cat([enc_s.data, enc_s.parity], dim=1)
    llr = channel_llr(tx, 2048, 38.6, seed=1)
    res_s = soft.decode(enc_s.data, enc_s.parity, soft_llr=llr)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    check(min(launches) >= 1, f"an LDPC main-path decode launched no kernel: {launches}")

    check(bool(hard._ldpc.check(word).all()), "LDPC hard encode: a codeword fails its checks")
    check(bool(soft._ldpc.check(soft._ldpc.deinterleave(tx)).all()),
          "LDPC soft encode: a deinterleaved codeword fails its checks")
    n = 256
    inputs = {"hard": (bad[:, :128], bad[:, 128:], {}),
              "soft": (enc_s.data.cpu().numpy(), enc_s.parity.cpu().numpy(),
                       {"soft_llr": llr[:n].cpu()})}
    for kind, codec, enc, res in (("hard", hard, enc_h, res_h), ("soft", soft, enc_s, res_s)):
        data_in, parity_in, kw = inputs[kind]
        check(all(t.device.type == "cuda" for t in res), f"LDPC {kind}: result not on the card")
        check(tuple(res.data.shape) == (BATCH, 128), f"LDPC {kind}: data shape {tuple(res.data.shape)}")
        check(codec.iterations_used is res.corrected, f"LDPC {kind}: iterations_used")
        ok, got = res.ok.cpu().numpy(), res.data.cpu().numpy()
        check(np.array_equal(got[ok], info[ok]), f"LDPC {kind}: an ok row's data != original")
        check(np.array_equal(got[~ok], data_in[~ok]), f"LDPC {kind}: a failed row's data != input")
        check(ok.mean() > 0.99, f"LDPC {kind}: ok share {ok.mean()}")
        # the first rows again through the facade on CPU tensors
        ref = pt.create(codec.config)
        ref_enc = ref.encode(info[:n])
        check(torch.equal(enc.data[:n].cpu(), ref_enc.data)
              and torch.equal(enc.parity[:n].cpu(), ref_enc.parity),
              f"LDPC {kind}: encode on the card != on CPU")
        want = ref.decode(data_in[:n], parity_in[:n], **kw)
        check(all(torch.equal(a[:n].cpu(), b) for a, b in zip(res, want)),
              f"LDPC {kind}: facade on the card != facade on CPU over the first {n} rows")
        log({"phase": "ldpc_main_path", "kind": kind, "config": repr(codec.config),
             "batch": BATCH, "ok_share": float(ok.mean()),
             "mean_iterations": float(res.corrected.double().mean()),
             "max_iterations": int(res.corrected.max()),
             "launches": codec._ldpc.kernel.launches})
    sent = bits.unpack(tx, 2048) == 1
    log({"phase": "ldpc_main_path", "seconds_with_transfers": main_s,
         "soft_channel_ber": float(((llr < 0) != sent).double().mean())})
    return {"hard": hard, "soft": soft, "launches": sum(launches),
            "x": torch.as_tensor(bad, device=dev), "llr": llr,
            "info": torch.as_tensor(info, device=dev),
            "soft_data": enc_s.data, "soft_parity": enc_s.parity}


def ldpc_kernel_vs_plain(pt, dev, rng):
    """Phase 6: the BP kernel's three entries (packed hard, int8 soft, the
    expanded-LLR `bp` in hard and soft mode) against the plain version on
    the card, exact on ok, output and iterations, over six configs and
    LDPC_CASE_BATCHES rows mixing clean, noisy and junk rows, at
    the full budget and at 1 iteration.  Returns the max_abs_err."""
    import torch
    from libpoporon_tpu_torch.models.ldpc import LLR_INFINITY, LLR_MAX, LDPCCodec
    from libpoporon_tpu_torch.utils import bits

    r12 = pt.LdpcRate.RATE_1_2
    configs = {
        "128B-r12": pt.LdpcConfig(128, r12),
        "default": pt.ldpc_config_default(128, r12),
        "burst-cw7": pt.ldpc_config_burst_resistant(128, r12),
        "128B-qc": pt.LdpcConfig(128, r12, matrix_type=pt.LdpcMatrixType.QC_RANDOM),
        "64B-r13": pt.LdpcConfig(64, pt.LdpcRate.RATE_1_3),
        # V = 1365 (V % 8 != 0), and the inner deinterleave leaves gaps
        "128B-r34": pt.LdpcConfig(128, pt.LdpcRate.RATE_3_4, use_inner_interleave=True,
                                  use_outer_interleave=True),
    }
    cases = max_err = 0
    for name, cfg in configs.items():
        c = LDPCCodec(cfg, dev)
        k = c.kernel
        check(k is not None, f"LDPC {name}: no kernel")
        V = c.codeword_bits
        oks = {}
        for B in LDPC_CASE_BATCHES:
            info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
            word = c.interleave(torch.cat([torch.as_tensor(info, device=dev), c.encode(info)], 1))
            word = word.cpu().numpy()
            junk = B // 16
            nerr = rng.integers(1, 12, B)
            nerr[: B // 8] = 0
            hard_in = flip_bits(word, distinct_positions(rng, B, V, 11), nerr)
            sign = np.where(bits.unpack_np(word, V) == 1, -1.0, 1.0)
            soft_in = sign * 90 + rng.normal(0, 45, sign.shape)
            soft_in[: B // 8] = sign[: B // 8] * 100
            if junk:
                hard_in[-junk:] = rng.integers(0, 256, (junk, word.shape[1]), dtype=np.uint8)
                soft_in[-junk:] = rng.integers(-127, 128, (junk, V))
            x = torch.as_tensor(hard_in, device=dev)
            w = torch.as_tensor(np.clip(np.round(soft_in), -127, 127).astype(np.int8), device=dev)
            # the bp entry (var-major, no interleaver): hard from the
            # deinterleaved noisy word, soft from the deinterleaved LLRs,
            # with the fake row V at +LLR_MAX
            fake = torch.full((1, B), LLR_MAX, dtype=torch.int32, device=dev)
            hb = bits.unpack(c.deinterleave(x), V).T
            llr_h = torch.cat([torch.where(hb == 1, -LLR_INFINITY, LLR_INFINITY), fake])
            llr_h = llr_h.to(torch.int16)
            w256 = torch.cat([c.deinterleave_bits_T(w.T.to(torch.int32)) * 256, fake])
            llr_s, chan_s = w256.clamp(-LLR_MAX, LLR_MAX).to(torch.int16), w256.to(torch.int16)
            for mi in (LDPC_MI, 1):
                for entry, got, want in (
                        ("packed hard", k.bp_packed_hard(x, mi), c._plain("hard", x, mi)),
                        ("int8 soft", k.bp_llr8_soft(w, mi), c._plain("soft", w, mi)),
                        ("bp hard", k.bp(llr_h, None, mi), c._bp_plain(llr_h, None, mi)),
                        ("bp soft", k.bp(llr_s, chan_s, mi), c._bp_plain(llr_s, chan_s, mi))):
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    max_err = max(max_err, err)
                    cases += 1
                    check(err == 0, f"LDPC {name} {entry} B={B} mi={mi}: kernel != plain "
                                    f"(max abs err {err})")
                    oks[f"{entry} B={B} mi={mi}"] = float(want[0].double().mean())
        log({"phase": "ldpc_kernel_vs_plain", "config": name, "V": V,
             "edges": c.structure.num_edges_used, "ok_share": oks})
    log({"phase": "ldpc_kernel_vs_plain", "cases": cases, "max_abs_err": max_err})
    return max_err


def ldpc_timing(pt, dev, main, common):
    """Phase 7: at B = BATCH on the main path's inputs, the kernel against
    the plain version (equal, then timed plain, kernel, kernel, plain), the
    adaptive cascade with the kernel as its body against the one launch
    that decode_*_adaptive makes, the facade with the kernel and with
    use_kernel="off" (the plain version under the cascade), and encode.
    Returns the `ldpc_bp` entry of the kernels line."""
    import torch

    hard, soft = main["hard"], main["soft"]
    x, llr = main["x"], main["llr"]
    mbit = BATCH * 2048 / 1e6           # Mbit per call
    entry = {"name": "ldpc_bp", "route": "cuda",
             "source": "libpoporon_tpu_torch/csrc/ldpc_bp.cu",
             "replaces": "libpoporon_tpu/models/ldpc_pallas.py:191", "max_abs_err": 0}
    facade_args = {"hard": (x[:, :128], x[:, 128:]),
                   "soft": (main["soft_data"], main["soft_parity"])}
    facade_kw = {"hard": {}, "soft": {"soft_llr": llr}}

    def plain_runs(fn, arg):
        """Plain-version timing: one call where a call takes over a second."""
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        slow = time.perf_counter() - t0 > 1.0
        return {"warmup": 0 if slow else WARMUP, "iters": 1 if slow else ITERS}

    for kind, facade, inp in (("hard", hard, x), ("soft", soft, llr)):
        c = facade._ldpc
        kern = c.kernel.bp_packed_hard if kind == "hard" else c.kernel.bp_llr8_soft

        def k_fn(t, kern=kern):
            return kern(t, LDPC_MI)

        def p_fn(t, c=c, kind=kind):
            return c._plain(kind, t, LDPC_MI)

        got = k_fn(inp)
        err = max_abs_err(got, p_fn(inp))
        check(err == 0, f"LDPC {kind} B={BATCH}: kernel != plain (max abs err {err})")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        reps = plain_runs(p_fn, inp)
        t_plain = [time_ms(p_fn, inp, **reps)]
        t_kern = [time_ms(k_fn, inp), time_ms(k_fn, inp)]
        t_plain.append(time_ms(p_fn, inp, **reps))
        ms, plain_ms = sum(t_kern) / 2, sum(t_plain) / 2
        log({"bench": f"ldpc_{kind}_kernel", "kernel_ms": ms, "plain_ms": plain_ms,
             "kernel_runs_ms": t_kern, "plain_runs_ms": t_plain,
             "plain_warmup": reps["warmup"], "plain_iters": reps["iters"],
             "kernel_mbit_per_s": mbit / ms * 1e3, "plain_mbit_per_s": mbit / plain_ms * 1e3,
             "kernel_codewords_per_s": BATCH / ms * 1e3,
             "plain_codewords_per_s": BATCH / plain_ms * 1e3,
             "mean_iterations": float(got[2].double().mean()), **common})
        if kind == "hard":
            entry.update(ms=ms, plain_ms=plain_ms)
        else:
            entry.update(soft_ms=ms, soft_plain_ms=plain_ms)

        def cascade(t, c=c, kind=kind):
            return c.cascade(lambda y, mi: c._decode(kind, y, mi), t, LDPC_MI)

        check(all(torch.equal(a, b) for a, b in zip(cascade(inp), got)),
              f"LDPC {kind}: cascade over the kernel != one launch")
        fn = c.decode_hard_adaptive if kind == "hard" else c.decode_soft_adaptive
        t_one, t_casc = time_ms(fn, inp), time_ms(cascade, inp)
        log({"bench": f"ldpc_{kind}_adaptive", "one_launch_ms": t_one,
             "cascade_over_kernel_ms": t_casc, "stage1_iters": c.STAGE1_ITERS,
             "straggler_slots": c.STRAGGLER_SLOTS,
             "one_launch_mbit_per_s": mbit / t_one * 1e3,
             "cascade_mbit_per_s": mbit / t_casc * 1e3, **common})

        args, kw = facade_args[kind], facade_kw[kind]
        off = pt.create(dataclasses.replace(facade.config, use_kernel="off"), device="cuda")
        check(off._ldpc.kernel is None, "use_kernel='off' still has a kernel")
        want = facade.decode(*args, **kw)
        check(all(torch.equal(a, b) for a, b in zip(off.decode(*args, **kw), want)),
              f"LDPC {kind}: facade with use_kernel='off' != with the kernel")
        for name, f in (("auto", facade), ("off", off)):
            reps = {} if name == "auto" else plain_runs(lambda t: f.decode(*args, **kw), None)
            t = time_ms(lambda: f.decode(*args, **kw), **reps)
            log({"bench": f"ldpc_{kind}_facade", "use_kernel": name, "ms": t,
                 "mbit_per_s": mbit / t * 1e3, "codewords_per_s": BATCH / t * 1e3,
                 **common, **reps})
        t = time_ms(facade.encode, main["info"])
        log({"bench": f"ldpc_{kind}_encode_facade", "config": repr(facade.config), "ms": t,
             "codewords_per_s": BATCH / t * 1e3, **common})
    return entry


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
        err = max_abs_err(got, want)
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
    rs_entry = {
        "name": "rs_decode",
        "route": "cuda",
        "source": "libpoporon_tpu_torch/csrc/rs_decode.cu",
        "replaces": "libpoporon_tpu/models/rs_pallas.py:158",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }

    # ---- phases 5 to 7: the LDPC slice
    main = ldpc_main_path(pt, dev, rng)
    max_err = ldpc_kernel_vs_plain(pt, dev, rng)
    ldpc_entry = ldpc_timing(pt, dev, main, common)
    ldpc_entry["launches"] = main["launches"]
    ldpc_entry["max_abs_err"] = max(max_err, ldpc_entry["max_abs_err"])

    print(json.dumps({"kernels": [rs_entry, ldpc_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
