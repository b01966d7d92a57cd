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
  cascade, encode and the expanded-LLR `bp` entry.
- Measurement path: runs the DMA probes' entry point
  (`benchmarks.probe_dma.run`, the JAX probe's shapes and 1 GB gathered
  sets), checks that it launched all three probe kernels, holds each
  probe against its plain version (out, checksum and the bytes landed over
  all repeats) and times PyTorch's own gather and copy beside it; then runs the BER waterfall (`benchmarks.waterfall`) on the
  card, soft and hard, checks that it went through the BP kernel and that
  its lines equal the CPU run's on a small batch.

Every kernel's entry in the `kernels` line carries its bound: the larger
of its bytes over 3.35 TB/s and its integer operations over 16.7 T/s
(132 SMs x 64 INT32 lanes x 1.98 GHz, the H100 SXM's SM layout and boost
clock; the data sheet gives no integer rate), counted from this run's
inputs.  A probe's bytes are those device memory must give: its distinct
rows once, and on each later repeat all but the 50 MB the L2 can keep;
a probe whose set fits L2 gets no device-memory bound.

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
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 131072          # bench.py's headline batch
WARMUP, ITERS = 3, 10   # CUDA-event timing
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 132 * 64 * 1.98e9   # H100 SXM: SMs x INT32 lanes x boost clock


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(obj) -> None:
    print("# " + json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float) -> dict:
    """The least time of a call: the larger of its bytes over the memory
    rate and its integer operations over the peak, and which binds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def rs_ops(nr: int, n: int, fs: int, errors, erasures: int = 0, syndromes: bool = True) -> float:
    """GF operations (a product or a sum is one) of RS decodes with
    errors[i] corrections in row i: the syndromes (nr Horner passes over n
    symbols) unless given; for rows with errors, the erasure locator
    (erasures^2), BM over its nr - erasures trips, Chien over all fs
    points, Omega, Forney and the verify of every syndrome."""
    L = errors.double()
    with_err = (L > 0).double()
    per_row = (2 * nr * n if syndromes else 0) + 2 * fs * L + 5 * L * L + 2 * nr * L
    per_row = per_row + with_err * (erasures ** 2 + 4 * nr * (nr - erasures))
    return float(per_row.sum())


def ldpc_ops(E: int, V: int, iters, hard: bool) -> float:
    """Integer operations of BP decodes whose row i ran iters[i]
    iterations: per row the unpack and v2c fill (V + E), the hard entry's
    iteration-0 syndrome (E) and the output (V); per iteration the check
    update (9 per edge: the two-minimum fold and the output select), the
    var update (4 per edge, 2 per variable) and the syndrome (1 per
    edge)."""
    B = iters.numel()
    fixed = V + E + (E if hard else 0) + V
    return float(B * fixed + iters.double().sum() * (14 * E + 2 * V))


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
        ref = pt.create(codec.config, device="cpu")
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
        s = c.structure
        E, V, nbytes = s.num_edges_used, c.codeword_bits, (c.codeword_bits + 7) // 8
        graph_bytes = 2 * (s.num_checks + 1 + E + V + 1 + E)
        in_bytes = nbytes if kind == "hard" else V      # packed bytes or int8 LLRs
        b = bound(BATCH * (in_bytes + nbytes + 1 + 4) + graph_bytes,
                  ldpc_ops(E, V, got[2], kind == "hard"))
        log({"bench": f"ldpc_{kind}_kernel_bound", "kernel_ms": ms, **b,
             "share_of_bound": b["bound_ms"] / ms, **common})
        if kind == "hard":
            entry.update(ms=ms, plain_ms=plain_ms, **b)
        else:
            entry.update(soft_ms=ms, soft_plain_ms=plain_ms, soft_bound_ms=b["bound_ms"],
                         soft_bound_by=b["bound_by"])

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


def ldpc_bp_entry_timing(dev, main, common):
    """K6: the expanded-LLR `bp` entry (BPCudaKernel.bp, hard mode) at
    B = BATCH on the hard main path's inputs, expanded as phase 6 expands
    them, against one call of its plain version (equal on every output)."""
    import torch
    from libpoporon_tpu_torch.models.ldpc import LLR_INFINITY, LLR_MAX
    from libpoporon_tpu_torch.utils import bits

    c = main["hard"]._ldpc
    V, E = c.codeword_bits, c.structure.num_edges_used
    fake = torch.full((1, BATCH), LLR_MAX, dtype=torch.int32, device=dev)
    hb = bits.unpack(c.deinterleave(main["x"]), V).T
    llr = torch.cat([torch.where(hb == 1, -LLR_INFINITY, LLR_INFINITY), fake]).to(torch.int16)
    got = c.kernel.bp(llr, None, LDPC_MI)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = c._bp_plain(llr, None, LDPC_MI)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max_abs_err(got, want)
    check(err == 0, f"LDPC bp entry B={BATCH}: kernel != plain (max abs err {err})")
    ms = time_ms(c.kernel.bp, llr, None, LDPC_MI)
    # llr [V+1, B] int16 in; bits [V+1, B] int8, ok and iters out
    b = bound(BATCH * ((V + 1) * 2 + (V + 1) + 1 + 4), ldpc_ops(E, V, got[2], True))
    log({"bench": "ldpc_bp_entry_hard", "kernel_ms": ms, "plain_ms": plain_ms,
         "plain_calls": 1, "mean_iterations": float(got[2].double().mean()), **b,
         "share_of_bound": b["bound_ms"] / ms, **common})
    return err


def probe_phase(common):
    """Phase 8: the DMA probes' entry point (probe_dma.run: every probe at
    the JAX shapes and the 1 GB gathered sets) with the launch counts set
    to 0 before and read after; then each probe against its plain version
    on the card at those shapes and at rows 1 and 1000, out, checksum and
    landed bytes exact; the plain version and PyTorch's own gather and copy
    timed beside it; and one probe call under utils.profiling.trace, whose
    trace goes to build/traces.  Returns the three probes' entries
    of the kernels line."""
    import torch
    from libpoporon_tpu_torch.benchmarks import probe_dma as pd
    from libpoporon_tpu_torch.utils.profiling import trace

    for name in pd.launches:
        pd.launches[name] = 0
    t0 = time.perf_counter()
    results = list(pd.run(seed=0, warmup=WARMUP, iters=ITERS))
    run_s = time.perf_counter() - t0
    launches = dict(pd.launches)
    check(all(n >= 1 for n in launches.values()), f"a probe kernel never launched: {launches}")
    log({"phase": "probe_dma_run", "seconds": run_s, "launches": launches})
    timed = {(r["probe"], r["depth"], r["sub"], r["rows"]): r for r in results}

    # utils.profiling.trace around one probe call: the trace file is
    # written, and the profiler sees the kernel's device time by name
    rng = np.random.default_rng(2)
    src = pd.source(rng, pd.SOURCE_UNITS, "cuda")
    idx = pd.index(rng, src.shape[0] // 8, pd.JAX_ROWS, "cuda")
    log_dir = Path("build") / "traces"
    before = set(log_dir.glob("*.json")) if log_dir.exists() else set()
    with trace(str(log_dir)) as prof:
        pd.gather_flood(idx, src, pd.JAX_ROWS, 8, pd.REPEAT)
    check(set(log_dir.glob("*.json")) - before, "trace wrote no file")
    device_us = {e.key: getattr(e, "device_time_total", 0) for e in prof.key_averages()
                 if "probe" in e.key or "flood" in e.key}
    log({"phase": "probe_trace", "device_us_by_kernel": device_us, **common})

    rng = np.random.default_rng(1)
    max_err = {name: 0 for name in pd.launches}
    cases = 0

    def compare(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        max_err[name] = max(max_err[name], err)
        cases += 1
        check(err == 0, f"{name} {what}: kernel != plain (max abs err {err})")

    entries = {}
    for sub in (8, 16, 32):
        for units, shapes in ((pd.SOURCE_UNITS, (1, 1000, pd.JAX_ROWS)),
                              (pd.HBM_SOURCE_UNITS, (pd.HBM_ROWS[sub],))):
            src = None        # free the last source first
            src = pd.source(rng, units, "cuda")
            for rows in shapes:
                idx = pd.index(rng, src.shape[0] // sub, rows, "cuda")
                probe_cases(pd, compare, idx, src, rows, sub)
                if rows >= pd.JAX_ROWS:
                    entries.update(probe_timing(pd, timed, idx, src, rows, sub, common))
    log({"phase": "probe_vs_plain", "cases": cases, "max_abs_err": max_err})
    replaces = {"gather_flood": "benchmarks/probe_dma.py:43",
                "gather_ring": "benchmarks/probe_dma.py:94",
                "plane_copy": "benchmarks/probe_dma.py:146"}
    out = []
    for name in ("gather_flood", "gather_ring", "plane_copy"):
        row = entries[name]
        out.append({"name": name, "route": "cuda",
                    "source": "libpoporon_tpu_torch/csrc/probe_dma.cu",
                    "replaces": replaces[name], "launches": launches[name],
                    "max_abs_err": max_err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "shape": {"sub": 8, "rows": row["rows"], "repeat": pd.REPEAT,
                              "depth": row["depth"]}})
    return out


def probe_cases(pd, compare, idx, src, rows, sub):
    """Each probe against its plain version on one input: flood, ring of
    depth 8 and 1, plane."""
    what = f"sub={sub} rows={rows}"
    gather = pd.gather_plain(idx, src, sub, pd.REPEAT)
    compare("gather_flood", pd.gather_flood(idx, src, rows, sub, pd.REPEAT), gather, what)
    for depth in (8, 1):
        compare("gather_ring", pd.gather_ring(idx, src, rows, sub, pd.REPEAT, depth),
                gather, f"{what} depth={depth}")
    compare("plane_copy", pd.plane_copy(src, rows, sub, pd.REPEAT),
            pd.plane_plain(src, rows, sub, pd.REPEAT), what)


def probe_timing(pd, timed, idx, src, rows, sub, common):
    """Logs each probe that probe_dma.run timed at this shape beside its
    bound, its plain version and PyTorch's gather or copy over the same
    bytes (`repeat` calls; index_select also writes the rows back to device
    memory).  Returns the rows that go into the kernels line: the 1 GB set
    at 4 KB rows, ring depth 8."""
    import torch
    src2d = src.view(-1, sub * pd.LANES)
    dst = torch.empty(rows, sub * pd.LANES, dtype=torch.int32, device=src.device)

    def lib_gather():
        for _ in range(pd.REPEAT):
            torch.index_select(src2d, 0, idx, out=dst)
        return dst

    def lib_copy():
        for _ in range(pd.REPEAT):
            dst.view(-1, pd.LANES).copy_(src[: rows * sub])
        return dst

    gathered = rows * sub * pd.SUBLANE_BYTES
    lib = {"gather": time_ms(lib_gather), "copy": time_ms(lib_copy)}
    plain = {"gather": time_ms(pd.gather_plain, idx, src, sub, pd.REPEAT),
             "copy": time_ms(pd.plane_plain, src, rows, sub, pd.REPEAT)}
    entries = {}
    for name, depth, kind in (("gather_flood", 0, "gather"), ("gather_ring", 8, "gather"),
                              ("gather_ring", 1, "gather"), ("plane_copy", 0, "copy")):
        r = timed.get((name, depth, sub, rows))
        if r is None:
            continue
        row = {"name": name, "depth": depth, "sub": sub, "rows": rows,
               "distinct_bytes": r["distinct_bytes"], "l2_resident": r["l2_resident"],
               "ms": r["ms"], "gb_per_s": r["gb_per_s"], "mrows_per_s": r["mrows_per_s"],
               "ns_per_row": r["ns_per_row"], "plain_ms": plain[kind],
               "library_ms": lib[kind],
               "library_gb_per_s": gathered * pd.REPEAT / lib[kind] / 1e6}
        if not r["l2_resident"]:
            # device memory gives the distinct rows once and, on each later
            # repeat, all but what L2 can keep; plus idx, out and the counts
            d = r["distinct_bytes"]
            nbytes = d + (pd.REPEAT - 1) * (d - pd.L2_BYTES) + 8 * pd.LANES * 4 + 16
            if kind == "gather":
                nbytes += rows * 4
            b = bound(nbytes, gathered // 4)      # one add per word, last repeat
            row.update(b, share_of_bound=b["bound_ms"] / r["ms"])
        log({"bench": "probe_dma", **row, **common})
        if rows == pd.HBM_ROWS[8] and sub == 8 and depth in (0, 8):
            entries[name] = row
    return entries


def waterfall_phase(common):
    """Phase 9: the BER waterfall on the card at B = 16384 over its default
    SNRs, soft and hard, through the BP kernel; then, on 256 codewords, the
    same script on the card and on the CPU print the same lines."""
    import contextlib
    import io
    import math

    from libpoporon_tpu_torch.benchmarks import waterfall

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            codec = waterfall.main(argv)
        return codec, [json.loads(ln) for ln in buf.getvalue().splitlines()]

    fer_at_top = {}
    for mode, extra in (("soft", []), ("hard", ["--hard"])):
        t0 = time.perf_counter()
        codec, lines = run(["--batch", "16384", *extra])
        seconds = time.perf_counter() - t0
        check(codec.kernel is not None and codec.kernel.launches >= len(lines),
              f"waterfall {mode}: the BP kernel did not run every point")
        check(len(lines) == 7, f"waterfall {mode}: {len(lines)} lines")
        for ln in lines:
            check(all(math.isfinite(v) for v in ln.values()), f"waterfall {mode}: {ln}")
            check(0 < ln["raw_ber"] < 0.5 and 0 <= ln["fer"] <= 1
                  and 0 <= ln["avg_iters"] <= LDPC_MI, f"waterfall {mode}: {ln}")
            log({"phase": "waterfall", "mode": mode, "batch": 16384, **ln,
                 "card": common["card"]})
        log({"phase": "waterfall", "mode": mode, "seconds": seconds,
             "launches": codec.kernel.launches})
        fer_at_top[mode] = lines[-1]["fer"]
        small = ["--batch", "256", *extra]
        check(run(small)[1] == run([*small, "--device", "cpu"])[1],
              f"waterfall {mode}: the card's lines != the CPU's on 256 codewords")
    check(fer_at_top["soft"] < 0.01 and fer_at_top["soft"] <= fer_at_top["hard"],
          f"waterfall: FER at 5 dB {fer_at_top}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import libpoporon_tpu_torch as pt
    from libpoporon_tpu_torch.models.rs import RSCodec, _encode_np
    from libpoporon_tpu_torch.utils import build
    from libpoporon_tpu_torch.utils.profiling import card_info

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

    def kernel_vs_plain(bench, kernel_fn, plain_fn, *args, in_bytes, **ops_kw):
        """Times both in the order plain, kernel, kernel, plain; checks
        that they agree and that every row decoded to the original.
        in_bytes: bytes a row reads; ops_kw: rs_ops's mode arguments.
        Returns the kernel's ms, the plain version's and the bound."""
        got, want = kernel_fn(*args), plain_fn(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{bench}: kernel != plain")
        check(bool(got[0].all()) and torch.equal(got[1], data_dev),
              f"{bench}: rows not recovered")
        t_plain = [time_ms(plain_fn, *args)]
        t_kern = [time_ms(kernel_fn, *args), time_ms(kernel_fn, *args)]
        t_plain.append(time_ms(plain_fn, *args))
        ms, plain_ms = sum(t_kern) / 2, sum(t_plain) / 2
        # plus data, parity, ok and count written, and the four GF tables
        b = bound(BATCH * (in_bytes + 223 + 32 + 1 + 4) + 4 * 256 * 4,
                  rs_ops(rs.num_roots, 255, rs.fs, got[3], **ops_kw))
        log({"bench": bench, "kernel_ms": ms, "plain_ms": plain_ms,
             "kernel_runs_ms": t_kern, "plain_runs_ms": t_plain,
             "kernel_codewords_per_s": BATCH / ms * 1e3,
             "plain_codewords_per_s": BATCH / plain_ms * 1e3, **b,
             "share_of_bound": b["bound_ms"] / ms, **common})
        return ms, plain_ms, b

    data_dev = torch.as_tensor(data, device=dev)
    d_dev, p_dev = torch.as_tensor(bad, device=dev), enc.parity
    ms, plain_ms, rs_bound = kernel_vs_plain("rs_decode_2err", kern.decode_plain,
                                             rs._decode_plain, d_dev, p_dev, in_bytes=255)
    # 32 erasures at the same positions in every row, as bench.py does
    epos = np.sort(rng.choice(223, 32, replace=False)).astype(np.int32)
    eras = data.copy()
    eras[:, epos] ^= 0xFF
    kernel_vs_plain("rs_erasure_32", kern.decode_erasure, rs._decode_erasure,
                    torch.as_tensor(eras, device=dev), p_dev,
                    torch.as_tensor(epos, device=dev).expand(BATCH, 32).contiguous(),
                    torch.full((BATCH,), 32, dtype=torch.int32, device=dev),
                    in_bytes=255 + 32 * 4 + 4, erasures=32)
    s_log = rs.exp2log[rs._syndrome(d_dev, p_dev).long()]
    kernel_vs_plain("rs_ext_syndrome", kern.decode_ext, rs._decode_ext_syndrome,
                    d_dev, p_dev, s_log, in_bytes=255 + 32 * 4, syndromes=False)

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
        **rs_bound,
        "library_ms": None,
    }

    # ---- phases 5 to 7: the LDPC slice, and the bp entry's timing
    main = ldpc_main_path(pt, dev, rng)
    max_err = ldpc_kernel_vs_plain(pt, dev, rng)
    ldpc_entry = ldpc_timing(pt, dev, main, common)
    ldpc_entry["launches"] = main["launches"]
    ldpc_entry["library_ms"] = None
    bp_err = ldpc_bp_entry_timing(dev, main, common)
    ldpc_entry["max_abs_err"] = max(max_err, bp_err, ldpc_entry["max_abs_err"])
    del main

    # ---- phases 8 and 9: the measurement path (DMA probes, waterfall)
    probe_entries = probe_phase(common)
    waterfall_phase(common)

    print(json.dumps({"kernels": [rs_entry, ldpc_entry, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
