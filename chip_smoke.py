#!/usr/bin/env python3
"""On-card smoke test of libpoporon_tpu_torch, the PyTorch and CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (at first use), then for
each slice of the port:

- RS(255,223): drives the main path through the public facade at
  B = 131072 codewords (encode, flip 2 symbols per row, decode), checks
  that the decode went through both RS kernels (a plain decode is two
  launches: the syndrome kernel, then the decode kernel), holds the
  syndrome kernel and the decode in all three modes against their plain
  PyTorch versions on the card (rows within and past the code's
  capacity, erasures with extra errors, so that BM runs long with
  nonzero discrepancies), and times both.
- LDPC 128-byte rate-1/2: drives the facade at B = 131072 in both
  configurations users run, hard (`LdpcConfig(128, RATE_1_2)`, 4 flipped
  bits a row) and soft (`ldpc_config_default(128, RATE_1_2)`, int8 LLRs
  at about 1e-2 channel BER), checks that both decodes went through the
  BP kernel, holds the kernel's three entries against the plain version
  over nine configs (the gate's largest codes, 512 B and 1024 B rate
  1/2 and 1024 B rate 1/2 of column weight 4, among them), and times
  kernel, plain version, facade, adaptive cascade, encode and the
  expanded-LLR `bp` entry.
- Measurement path: runs the DMA probes' entry point
  (`benchmarks.probe_dma.run`, the JAX probe's shapes and 1 GB gathered
  sets), checks that it launched all three probe kernels, holds each
  probe against its plain version (out, checksum and the bytes landed over
  all repeats) and times PyTorch's own gather and copy beside it; then runs the BER waterfall (`benchmarks.waterfall`) on the
  card, soft and hard, checks that it went through the BP kernel and that
  its lines equal the CPU run's on a small batch.
- BCH, streaming and the C-shaped shim (plain PyTorch and the kernels
  above): BCH(15,5) at B = 131072 through the bit, word and byte APIs,
  each equal to the same call on the CPU, timed, with the device kernels
  of one decode_bits call counted from a torch.profiler trace;
  BCH(31,21), BCH(63,51) and BCH(4095,4071) through the facade, rows
  within and past capacity, equal to the CPU; StreamCodec over RS (32 MiB,
  4 bad bytes a block) and LDPC (4 MiB), round-tripping through the RS
  and BP kernels; the shim at B = 1 (RS plain, erasure and external
  syndrome, LDPC soft, BCH), equal to CPU handles, its kernels' counts
  moving.
- parallel/: ShardedCodec over every visible card at B = 131072 and over
  two entries of one card at B = 131071 (RS 2 errors, LDPC hard and
  soft), each output equal to the facade's, the kernels launched once a
  shard (RS twice), both timed; ldpc_decode_step's sums against the
  facade's; the statistics on card tensors against the CPU, locally and
  in a one-rank NCCL group; the scaling benchmark's row; the current
  CUDA device as it was.

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

`python3 chip_smoke.py --parallel-only` builds the kernels and runs the
RS and LDPC main paths, then phase 13 (parallel/) alone over every
visible card: the multi-card check, for a machine with several cards.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 131072          # bench.py's headline batch
WARMUP, ITERS = 3, 10   # CUDA-event timing (profiling.time_ms's defaults)
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


def syndrome_ops(nr: int, n: int) -> float:
    """Integer operations of one row's syndromes: nr n / 4.  The product of
    symbol j by the fixed powers alpha^(a_i (n-1-j)) of all nr syndromes is
    one lookup in a table of position j, and one 32-bit XOR sums four
    syndrome bytes, so only the sums count, four to an operation."""
    return nr * n / 4


def rs_ops(nr: int, n: int, fs: int, errors, erasures: int = 0, syndromes: bool = True) -> float:
    """Operations of RS decodes with errors[i] corrections in row i (L, the
    locator's degree): the syndromes (`syndrome_ops`) unless given; for
    rows with errors, the erasure locator (erasures^2), BM, Chien over all
    fs points, Omega, Forney and the verify of every syndrome, a GF
    product or sum one operation each.  BM (`bm_ops`) needs the
    discrepancy over L + 1 terms on each of its nr - erasures trips, and
    the update of L + 1 slots of the locator and of the b polynomial on
    the trips whose discrepancy is not zero: at most 2 (L - erasures) of
    them, and no more than the trips BM runs."""
    L = errors.double()
    with_err = (L > 0).double()
    trips = nr - erasures
    bm_ops = 2 * trips * (L + 1) + 4 * (L + 1) * (2 * (L - erasures)).clamp(0, trips)
    per_row = (syndrome_ops(nr, n) if syndromes else 0) + 2 * fs * L + 5 * L * L + 2 * nr * L
    per_row = per_row + with_err * (erasures ** 2 + bm_ops)
    return float(per_row.sum())


def ldpc_ops(E: int, V: int, ok, iters) -> float:
    """Integer operations of BP decodes whose row i ran iters[i]
    iterations and ended clean where ok[i]: per row the unpack and v2c fill
    (V + E) and the output (V); per iteration the check update (9 per edge:
    the two-minimum fold and the output select) and the var update (4 per
    edge, 2 per variable); and one syndrome (1 per edge) per clean verdict.
    A dirty verdict counts nothing: one unsatisfied check settles it.
    Every operation counts one: the kernels use no paired (two-to-a-lane)
    instructions."""
    B = iters.numel()
    return float(B * (2 * V + E) + ok.double().sum() * E
                 + iters.double().sum() * (13 * E + 2 * V))


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


def syndrome_timing(kern, kernel_fn, plain_fn, args, common):
    """Phase 4, the syndrome kernel alone at B = BATCH on the main path's
    rows (`rs_kernel.calls`): equal to its plain version, then timed plain,
    kernel, kernel, plain.  Its bound: per row `syndrome_ops`, and the row
    read and nr int32 logs written, plus the column table and log table
    once.  Returns the `rs_syndrome` entry of the kernels line, less
    launches and max_abs_err."""
    import torch
    from libpoporon_tpu_torch.benchmarks.rs_kernel import time_in_turns

    check(torch.equal(kernel_fn(*args), plain_fn(*args)), f"rs_syndrome B={BATCH}: kernel != plain")
    t_kern, t_plain = time_in_turns(kernel_fn, plain_fn, args)
    ms, plain_ms = sum(t_kern) / 2, sum(t_plain) / 2
    d, p = args
    nr, n = p.shape[1], d.shape[1] + p.shape[1]
    b = bound(BATCH * (n + 4 * nr) + kern.columns.numel() * 4 + 256 * 4,
              BATCH * syndrome_ops(nr, n))
    log({"bench": "rs_syndrome", "kernel_ms": ms, "plain_ms": plain_ms,
         "kernel_runs_ms": t_kern, "plain_runs_ms": t_plain,
         "kernel_codewords_per_s": BATCH / ms * 1e3, "column_table_bytes": kern.columns.numel() * 4,
         **b, "share_of_bound": b["bound_ms"] / ms, **common})
    return {"name": "rs_syndrome", "route": "cuda",
            "source": "libpoporon_tpu_torch/csrc/rs_decode.cu",
            "replaces": "libpoporon_tpu/models/rs_pallas.py:203",
            "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


# ------------------------------------------------------------ LDPC slice

LDPC_MI = 50        # the reference's default iteration budget (ldpc.c:23)
LDPC_CASE_BATCHES = (1, 1000, 4097)     # phase 6: one row, ragged, > 4 * 1024
LDPC_LARGE_BATCHES = (1, 1000)          # phase 6, 512 B and 1024 B codes


def ldpc_main_path(pt, dev, rng):
    """Phase 5: the LDPC main path through the facade at B = BATCH, hard
    and soft, with the kernels' counts read around it; the decoded rows
    are checked against the original info and, for the first rows, against
    the facade on CPU tensors (the plain version).  Returns the codecs and
    the inputs for the timing phase."""
    import torch
    from libpoporon_tpu_torch.benchmarks.bp_kernel import (channel_llr, distinct_positions,
                                                            flip_bits)
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
    the card, exact on ok, output and iterations, over six 128 B and 64 B
    configs at LDPC_CASE_BATCHES rows and the gate's largest codes (512 B
    and 1024 B rate 1/2, and 1024 B rate 1/2 of column weight 4) at
    LDPC_LARGE_BATCHES, rows mixing clean, noisy and junk rows, at the full
    budget and at 1 iteration.  Logs each config's launch form (layout in
    shared or global memory, groups and threads a block), its largest
    variable degree and blocks per SM.  Returns the max_abs_err."""
    import torch
    from libpoporon_tpu_torch.benchmarks.bp_kernel import distinct_positions, flip_bits
    from libpoporon_tpu_torch.models.ldpc import LLR_INFINITY, LLR_MAX, LDPCCodec
    from libpoporon_tpu_torch.models.ldpc_cuda import MODE_HARD_PACKED, MODE_SOFT_LLR8
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
        "512B-r12": pt.LdpcConfig(512, r12),
        "1024B-r12": pt.LdpcConfig(1024, r12),
        # column weight 4: the global-memory form with var loops of kMaxDv
        "1024B-r12-cw4": pt.LdpcConfig(1024, r12, column_weight=4),
    }
    cases = max_err = 0
    for name, cfg in configs.items():
        c = LDPCCodec(cfg, dev)
        k = c.kernel
        check(k is not None, f"LDPC {name}: no kernel")
        V = c.codeword_bits
        oks = {}
        for B in LDPC_LARGE_BATCHES if c.info_bytes > 128 else LDPC_CASE_BATCHES:
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
             "edges": c.structure.num_edges_used, "form": k.form, "dv": k.dv,
             "blocks_per_sm": {"hard": k.blocks_per_sm(MODE_HARD_PACKED, dev),
                               "soft": k.blocks_per_sm(MODE_SOFT_LLR8, dev)},
             "ok_share": oks})
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
    from libpoporon_tpu_torch.utils.profiling import time_ms

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
             "mean_iterations": float(got[2].double().mean()), "form": c.kernel.form,
             **common})
        E, V, nbytes = c.structure.num_edges_used, c.codeword_bits, (c.codeword_bits + 7) // 8
        in_bytes = nbytes if kind == "hard" else V      # packed bytes or int8 LLRs
        b = bound(BATCH * (in_bytes + nbytes + 1 + 4) + c.kernel.graph.numel(),
                  ldpc_ops(E, V, got[0], got[2]))
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
    from libpoporon_tpu_torch.utils.profiling import time_ms

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
    b = bound(BATCH * ((V + 1) * 2 + (V + 1) + 1 + 4), ldpc_ops(E, V, got[0], got[2]))
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
    from libpoporon_tpu_torch.utils.profiling import time_ms
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


# ------------------------------------------- BCH, streaming and the shim

BCH_CONFIGS = {"BCH(31,21)": ((5, 0x25, 2), BATCH), "BCH(63,51)": ((6, 0x43, 2), BATCH),
               "BCH(4095,4071)": ((12, 0x1053, 2), 2048)}


def bch_rows(rng, c, B):
    """Codeword bits [B, n] of random data through c.encode_bits, with 0..t
    bit errors in the first half of the rows, t+1..t+3 in most of the
    rest and random words in the last sixteenth; distinct error positions
    a row, made in one pass.  Returns (received bits, sent bits)."""
    n, t = c.n, c.t
    sent = c.encode_bits(rng.integers(0, 2, (B, c.data_length)).astype(np.int32)).cpu().numpy()
    nerr = np.where(np.arange(B) < B // 2, np.arange(B) % (t + 1), t + 1 + np.arange(B) % 3)
    pos = np.argsort(rng.random((B, n)), axis=1)[:, : t + 3]
    flips = np.zeros((B, n), np.int32)
    np.put_along_axis(flips, pos, (np.arange(t + 3)[None, :] < nerr[:, None]).astype(np.int32),
                      axis=1)
    rx = sent ^ flips
    junk = B // 16
    rx[-junk:] = rng.integers(0, 2, (junk, n))
    return rx, sent


def launches_per_call(fn, *args):
    """Device kernels one call of fn launches, from a torch.profiler trace
    (utils.profiling.trace; the trace goes to build/traces): (kernels,
    memory copies and sets, their device us in all, the five kernels of
    most device time with their us, names cut at 80 characters)."""
    import torch
    from libpoporon_tpu_torch.utils.profiling import trace
    fn(*args)
    torch.cuda.synchronize()
    with trace(str(Path("build") / "traces")) as prof:
        fn(*args)
    dev = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    check(dev, "the profiler saw no device event")
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in dev:
        if e not in copies:
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0) + e.device_time_total
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    return len(dev) - len(copies), len(copies), sum(e.device_time_total for e in dev), top


def bch_phase(pt, dev, rng, common):
    """Phase 10: BCH(15,5) (`bch_config_default()`) at B = BATCH from random
    15-bit words (bench.py:202-224): decode_bits, encode_bits, the facade's
    byte round trip and the word API's decode on the card, each equal to
    the same call on the CPU, then timed, with the device kernels of one
    decode_bits call from a profiler trace and its bytes bound; then
    BCH(31,21), BCH(63,51) and BCH(4095,4071) through the facade, rows
    within and past capacity and random words, equal to the CPU."""
    import torch
    from libpoporon_tpu_torch.models.bch import BCHCodec
    from libpoporon_tpu_torch.utils.profiling import time_ms

    cases = 0

    def same(got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        err = max_abs_err([g.cpu() for g in got], list(want))
        cases += 1
        check(err == 0 and all(g.shape == w.shape for g, w in zip(got, want)),
              f"BCH {what}: the card != the CPU (max abs err {err})")

    cfg = pt.bch_config_default()
    codec, ref = pt.create(cfg, device="cuda"), pt.create(cfg, device="cpu")
    c, cc = codec._bch, ref._bch
    words = rng.integers(0, 1 << c.n, BATCH).astype(np.int32)
    rx = ((words[:, None] >> np.arange(c.n)) & 1).astype(np.int32)
    rx_dev = torch.as_tensor(rx, device=dev)
    dbits = torch.as_tensor(rng.integers(0, 2, (BATCH, c.data_length)).astype(np.int32),
                            device=dev)
    data = torch.as_tensor(rng.integers(0, 1 << c.data_length, (BATCH, 1)).astype(np.uint8),
                           device=dev)
    words_dev = torch.as_tensor(words, device=dev)

    def round_trip(d):
        par = codec.encode(d).parity
        bad = d ^ torch.where(torch.arange(d.shape[0], device=d.device)[:, None] % 2 == 0, 1, 4)
        return codec.decode(bad.to(torch.uint8), par)

    got = c.decode_bits(rx_dev)
    same(got, cc.decode_bits(rx), "15 decode_bits")
    ok_share = float(got[0].double().mean())
    same([c.encode_bits(dbits)], [cc.encode_bits(dbits.cpu())], "15 encode_bits")
    res = round_trip(data)
    par_cpu = ref.encode(data.cpu()).parity
    bad_cpu = (data.cpu() ^ torch.where(torch.arange(BATCH)[:, None] % 2 == 0, 1, 4)).to(torch.uint8)
    same(list(res) + [codec.last_num_errors], list(ref.decode(bad_cpu, par_cpu))
         + [ref.last_num_errors], "15 facade round trip")
    check(bool(res.ok.all()) and torch.equal(res.data, data), "BCH(15,5) round trip: a row lost")
    same(c.decode(words_dev), cc.decode(words), "15 word decode")

    t = {"decode_bits": time_ms(c.decode_bits, rx_dev),
         "encode_bits": time_ms(c.encode_bits, dbits),
         "facade_round_trip": time_ms(round_trip, data),
         "word_decode": time_ms(c.decode, words_dev)}
    kernels, copies, device_us, top = launches_per_call(c.decode_bits, rx_dev)
    # the function's bytes: int32 bits in; ok, int32 bits and int32 counts out
    b = bound(BATCH * (4 * c.n + 1 + 4 * c.n + 4), 0)
    log({"bench": "bch15_decode_bits", "config": repr(cfg), "ms": t["decode_bits"],
         "codewords_per_s": BATCH / t["decode_bits"] * 1e3, "ok_share_random_words": ok_share,
         "device_kernels_per_call": kernels, "copies_per_call": copies,
         "device_us_in_trace": device_us, "top_kernels_us": top, **b,
         "share_of_bound": b["bound_ms"] / t["decode_bits"], **common})
    for name in ("encode_bits", "facade_round_trip", "word_decode"):
        log({"bench": f"bch15_{name}", "ms": t[name], "codewords_per_s": BATCH / t[name] * 1e3,
             **common})

    for name, (params, B) in BCH_CONFIGS.items():
        cfg = pt.BchConfig(*params)
        codec, ref = pt.create(cfg, device="cuda"), pt.create(cfg, device="cpu")
        cpu = BCHCodec(cfg, "cpu")
        rx, sent = bch_rows(rng, cpu, B)
        d = cpu.unpack_data(torch.as_tensor(rx[:, cpu.parity_bits:]))
        p = cpu.unpack_parity(torch.as_tensor(rx[:, : cpu.parity_bits]))
        t0 = time.perf_counter()
        res = codec.decode(d.to(dev), p.to(dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        same(list(res) + [codec.last_num_errors], list(ref.decode(d, p)) + [ref.last_num_errors],
             f"{name} facade decode B={B}")
        within = np.arange(B) < B // 2
        want = cpu.unpack_data(torch.as_tensor(sent[:, cpu.parity_bits:])).numpy()
        check(bool(res.ok.cpu().numpy()[within].all())
              and np.array_equal(res.data.cpu().numpy()[within], want[within]),
              f"{name}: a row within capacity not corrected")
        ms = time_ms(codec.decode, d.to(dev), p.to(dev))
        log({"bench": "bch_facade_decode", "config": name, "batch": B, "ms": ms,
             "first_call_s": seconds, "codewords_per_s": B / ms * 1e3,
             "ok_share": float(res.ok.double().mean()), "card": common["card"]})
    log({"phase": "bch", "cases": cases, "max_abs_err": 0})
    return t["decode_bits"], kernels


def stream_phase(pt, dev, rng, common):
    """Phase 11: StreamCodec over RS(255,223), 32 MiB with 4 corrupted
    bytes in every block, and over LDPC 128 B rate 1/2, 4 MiB as sent (a
    few blocks in a thousand of this code fail to converge from even one
    flipped bit, in the JAX package as here), each round-tripping exactly
    through the RS and BP kernels; a 100 KB payload gives the same blob
    and result on the card as on the CPU."""
    import torch
    from libpoporon_tpu_torch.stream import StreamCodec

    out = {}
    for name, cfg, size in (("rs", pt.rs_config_default(), 32 << 20),
                            ("ldpc", pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), 4 << 20)):
        codec = pt.create(cfg, device="cuda")
        kern = codec._rs.kernel if name == "rs" else codec._ldpc.kernel
        sc = StreamCodec(codec)
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        kern.launches = 0
        t0 = time.perf_counter()
        blob = sc.encode_stream(payload)
        enc_s = time.perf_counter() - t0
        arr = np.frombuffer(blob, np.uint8).reshape(-1, sc.block_size).copy()
        nb = arr.shape[0]
        rows = np.arange(nb)[:, None]
        if name == "rs":      # 4 distinct bytes a block
            pos = (rng.integers(0, 255, nb)[:, None] + np.array([0, 61, 127, 190])) % 255
            arr[rows, pos] ^= rng.integers(1, 256, (nb, 4), dtype=np.uint8)
        t0 = time.perf_counter()
        got, stats = sc.decode_stream(arr.tobytes())
        dec_s = time.perf_counter() - t0
        check(got == payload and stats["blocks_failed"] == 0,
              f"stream {name}: payload not recovered ({stats})")
        launches = {"launches": kern.launches}
        if name == "rs":
            launches["syndrome_launches"] = kern.syndrome_launches
        check(launches["launches"] >= 1, f"stream {name}: no kernel launched")
        small = payload[: 100_000]
        ref = StreamCodec(pt.create(cfg, device="cpu"))
        check(sc.encode_stream(small) == ref.encode_stream(small), f"stream {name}: blob != CPU's")
        check(sc.decode_stream(sc.encode_stream(small)) == ref.decode_stream(ref.encode_stream(small)),
              f"stream {name}: decode != CPU's")
        out[name] = {"payload_bytes": size, "blocks": nb, "encode_s": enc_s, "decode_s": dec_s,
                     "encode_mb_per_s": size / enc_s / 1e6, "decode_mb_per_s": size / dec_s / 1e6,
                     "corrected": stats["corrected"], **launches}
        log({"phase": "stream", "codec": name, **out[name], "max_abs_err": 0,
             "card": common["card"]})
    return out


def shim_phase(pt, dev, rng, common):
    """Phase 12: the C-shaped shim at B = 1 on the card (RS plain, erasure
    and external syndrome, LDPC default with soft LLRs, BCH default), each
    call's return and buffers equal to the same calls on a CPU handle, and
    the RS and BP kernels' launch counts moving; the first decode call and
    the mean of 20 more timed on the host clock (each returns its result
    to NumPy, so each waits for the card)."""
    import torch
    from libpoporon_tpu_torch import compat as pp

    eras = [3, 10, 200]

    def rs_cfg(**kw):
        return pp.poporon_rs_config_create(8, 0x11D, 1, 1, 32, **kw)

    data = rng.integers(0, 256, 223, dtype=np.uint8)
    parity = np.zeros(32, np.uint8)
    pp.poporon_encode(pp.poporon_create(rs_cfg(), device="cpu"), data.copy(), 223, parity)
    bad = data.copy()
    bad[eras] ^= 0x5A
    rs_ref = pt.create(pt.rs_config_default(), device="cpu")._rs
    syn = rs_ref.exp2log[rs_ref._syndrome(torch.as_tensor(bad[None]),
                                          torch.as_tensor(parity[None])).long()][0]
    ldpc_data = rng.integers(0, 256, 128, dtype=np.uint8)
    ldpc_par = np.zeros(128, np.uint8)
    enc_data = ldpc_data.copy()
    pp.poporon_encode(pp.poporon_create(pp.poporon_config_ldpc_default(128, 1), device="cpu"),
                      enc_data, 128, ldpc_par)
    sign = np.unpackbits(np.concatenate([enc_data, ldpc_par]))
    llr = np.clip(np.round(np.where(sign == 1, -60, 60) + rng.normal(0, 25, 2048)), -127, 127)
    bch_data = np.array([21], np.uint8)
    bch_par = np.zeros(2, np.uint8)
    pp.poporon_encode(pp.poporon_create(pp.poporon_config_bch_default(), device="cpu"),
                      bch_data.copy(), 1, bch_par)
    cases = {
        "rs_plain": (rs_cfg(), bad, parity, "rs"),
        "rs_erasure": (rs_cfg(erasure=pp.poporon_erasure_create_from_positions(32, eras)),
                       bad, parity, "rs"),
        "rs_syndrome": (rs_cfg(syndrome=syn.numpy()), bad, parity, "rs"),
        "ldpc_soft": (pp.poporon_ldpc_config_create(128, 1, 1, 3, True, True, True, 0, 0, 0,
                                                    llr.astype(np.int8), 2048, 0),
                      enc_data, ldpc_par, "ldpc"),
        "bch": (pp.poporon_config_bch_default(), bch_data ^ np.uint8(5), bch_par, None),
    }
    for name, (cfg, d, p, kind) in cases.items():
        results = []
        for device in ("cuda", "cpu"):
            h = pp.poporon_create(cfg, device=device)
            check(h is not None, f"shim {name}: poporon_create gave NULL on {device}")
            kern = getattr(h.codec, f"_{kind}").kernel if kind else None
            if kern is not None:
                kern.launches = 0
            bd, bp = d.copy(), p.copy()
            enc_par = np.zeros_like(p)
            enc_ok = pp.poporon_encode(h, d.copy(), len(d), enc_par)
            t0 = time.perf_counter()
            r = pp.poporon_decode(h, bd, len(d), bp)
            ms = (time.perf_counter() - t0) * 1e3
            results.append((enc_ok, enc_par.tolist(), r, bd.tolist(), bp.tolist(),
                            pp.poporon_get_iterations_used(h)))
            if device == "cuda":
                launches = None if kern is None else kern.launches
                check(kind is None or launches >= 1, f"shim {name}: no kernel launched")
                first_ms = ms
                t0 = time.perf_counter()
                for _ in range(20):
                    pp.poporon_decode(h, d.copy(), len(d), p.copy())
                steady_ms = (time.perf_counter() - t0) / 20 * 1e3
        check(results[0] == results[1], f"shim {name}: the card's results != the CPU's")
        check(results[0][2][0], f"shim {name}: decode failed {results[0][2]}")
        log({"phase": "shim", "case": name, "result": list(results[0][2]), "launches": launches,
             "first_decode_ms": first_ms, "decode_ms": steady_ms, "max_abs_err": 0,
             "card": common["card"]})


# ------------------------------------------------------- parallel/ (phase 13)

PAR_ODD = BATCH - 1     # the two-entry mesh's batch: one pad row, then split


def shard_kernels(sc):
    """The RS or BP kernel wrappers of a ShardedCodec's device codecs."""
    return [c._rs.kernel if hasattr(c, "_rs") else c._ldpc.kernel for c in sc.codecs.values()]


def kernel_counts(sc):
    """(kernel launches, RS syndrome launches) summed over the shards' codecs."""
    ks = shard_kernels(sc)
    return sum(k.launches for k in ks), sum(getattr(k, "syndrome_launches", 0) for k in ks)


def zero_counts(sc):
    for k in shard_kernels(sc):
        k.launches = 0
        if hasattr(k, "syndrome_launches"):
            k.syndrome_launches = 0


def parallel_phase(pt, rs_case, ldpc, common):
    """Phase 13: parallel/.  ShardedCodec over every visible card at
    B = BATCH and over two entries of one card at B = BATCH - 1 (a pad
    row, a split, a join), on the RS 2-error and LDPC hard and soft inputs
    of phases 2 and 5: each output equal to the facade's on the same
    inputs, the kernels launched per shard, both timed in turns.  Then
    ldpc_decode_step's sums against the facade, the statistics on card
    tensors against the CPU, locally and inside a one-rank NCCL group
    that the phase opens and closes, and the scaling benchmark on the
    visible cards.  The current CUDA device is the same after it."""
    import contextlib
    import datetime
    import io
    import tempfile

    import torch
    import torch.distributed as dist
    from libpoporon_tpu_torch.benchmarks import scaling
    from libpoporon_tpu_torch.parallel import (ShardedCodec, batch_mesh, ber_stats,
                                               iteration_histogram)
    from libpoporon_tpu_torch.utils.bits import unpack
    from libpoporon_tpu_torch.utils.profiling import time_ms

    t0 = time.perf_counter()
    current = torch.cuda.current_device()
    meshes = {"cards": (batch_mesh(), BATCH), "one_card_x2": (batch_mesh(["cuda:0"] * 2), PAR_ODD)}
    x = ldpc["x"]
    cases = [("rs_2err", rs_case["codec"], rs_case["args"], {}, 2),
             ("ldpc_hard", ldpc["hard"], (x[:, :128], x[:, 128:]), {}, 1),
             ("ldpc_soft", ldpc["soft"], (ldpc["soft_data"], ldpc["soft_parity"]),
              {"soft_llr": ldpc["llr"]}, 1)]
    for mesh_name, (mesh, B) in meshes.items():
        n = len(mesh.devices)
        for name, codec, args, kw, per_shard in cases:
            args = tuple(a[:B] for a in args)
            kw = {k: v[:B] for k, v in kw.items()}
            sc = ShardedCodec(codec, mesh)
            want = codec.decode(*args, **kw)
            zero_counts(sc)
            got = sc.decode(*args, **kw)
            torch.cuda.synchronize()
            launches, syn = kernel_counts(sc)
            check(launches == per_shard * n and (per_shard == 1 or syn == n),
                  f"parallel {name} on {mesh_name}: {launches} launches ({syn} syndrome) "
                  f"for {n} shards, {per_shard} a shard")
            err = max_abs_err(got, want)
            check(err == 0 and all(a.shape == b.shape and a.device == b.device
                                   for a, b in zip(got, want)),
                  f"parallel {name} on {mesh_name}: sharded != facade (max abs err {err})")

            def facade_fn():
                return codec.decode(*args, **kw)

            def sharded_fn():
                return sc.decode(*args, **kw)

            devs = list(dict.fromkeys(mesh.devices))
            t_f = [time_ms(facade_fn, devices=devs)]
            t_s = [time_ms(sharded_fn, devices=devs), time_ms(sharded_fn, devices=devs)]
            t_f.append(time_ms(facade_fn, devices=devs))
            ms, facade_ms = sum(t_s) / 2, sum(t_f) / 2
            log({**common, "phase": "parallel", "case": name, "mesh": mesh_name,
                 "shards": n, "batch": B, "launches": launches, "syndrome_launches": syn,
                 "max_abs_err": err, "sharded_ms": ms, "facade_ms": facade_ms,
                 "sharded_runs_ms": t_s, "facade_runs_ms": t_f,
                 "sharded_over_facade": ms / facade_ms, "split_join_ms": ms - facade_ms})

    # ldpc_decode_step: its sums are the facade's (plus the zero pad rows,
    # each a codeword converging at iteration 0, as the JAX psum counts them)
    hard = ldpc["hard"]
    word = torch.cat(list(hard.encode(ldpc["info"])), dim=1)
    for mesh_name, (mesh, B) in meshes.items():
        want = hard.decode(x[:B, :128], x[:B, 128:])
        ok, out, iters, st = ShardedCodec(hard, mesh).ldpc_decode_step(x[:B])
        pads = (-B) % len(mesh.devices)
        check(torch.equal(ok, want.ok) and torch.equal(iters, want.corrected),
              f"ldpc_decode_step on {mesh_name}: ok or iterations != the facade's")
        check(st == {"converged": int(want.ok.sum()) + pads,
                     "iterations_total": int(want.corrected.sum())},
              f"ldpc_decode_step on {mesh_name}: stats {st} != the facade's sums")
        log({"phase": "parallel_step", "mesh": mesh_name, "batch": B, **st, "pads": pads})

    # statistics on card tensors: local, then over a one-rank NCCL group
    ok, out, iters, _ = ShardedCodec(hard, meshes["cards"][0]).ldpc_decode_step(x)
    ref_bits, out_bits = unpack(word), unpack(out)
    ber_cpu = ber_stats(ref_bits.cpu(), out_bits.cpu(), group=None)
    hist_cpu = iteration_histogram(iters.cpu(), LDPC_MI, group=None)

    def same_stats(ber, hist, what):
        check(all(torch.equal(ber[k].cpu(), ber_cpu[k]) for k in ber_cpu)
              and torch.equal(hist.cpu(), hist_cpu), f"statistics {what} != on the CPU")

    same_stats(ber_stats(ref_bits, out_bits, group=None),
               iteration_histogram(iters, LDPC_MI, group=None), "on the card, local")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            same_stats(ber_stats(ref_bits, out_bits), iteration_histogram(iters, LDPC_MI),
                       "over a one-rank NCCL group")
            _, _, _, st = ShardedCodec(hard, meshes["cards"][0],
                                       group=dist.group.WORLD).ldpc_decode_step(x)
            check(st["converged"] == int(ok.sum()), "ldpc_decode_step over NCCL")
        finally:
            dist.destroy_process_group()
    log({"phase": "parallel_stats", "errors": int(ber_cpu["errors"]),
         "total": int(ber_cpu["total"]), "ber": float(ber_cpu["ber"]),
         "histogram_nonzero": {i: int(v) for i, v in enumerate(hist_cpu.tolist()) if v},
         "nccl_one_rank": "equal", "max_abs_err": 0})

    with contextlib.redirect_stdout(io.StringIO()):
        res = scaling.main([])
    log({"phase": "scaling", **res})
    check(torch.cuda.current_device() == current,
          f"the current CUDA device moved from {current} to {torch.cuda.current_device()}")
    log({"phase": "parallel", "seconds": time.perf_counter() - t0, "card": common["card"]})


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import libpoporon_tpu_torch as pt
    from libpoporon_tpu_torch.benchmarks import rs_kernel
    from libpoporon_tpu_torch.models.rs import RSCodec, _encode_np
    from libpoporon_tpu_torch.utils import build
    from libpoporon_tpu_torch.utils.profiling import card_info, time_ms

    t_start = time.perf_counter()
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
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log({"phase": "build", "seconds": build_s, "library": so.name, "ptxas": ptxas})

    # ---- phase 2: the main path through the facade, B = 131072
    rng = np.random.default_rng(0)
    codec = pt.create(pt.rs_config_default(), device="cuda")
    kern = codec._rs.kernel
    check(kern is not None, "default RS config has no kernel")
    data = rng.integers(0, 256, (BATCH, 223), dtype=np.uint8)
    bad = rs_kernel.two_errors(rng, data)

    kern.launches = kern.syndrome_launches = 0
    t0 = time.perf_counter()
    enc = codec.encode(data)
    res = codec.decode(bad, enc.parity)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, syn_launches = kern.launches, kern.syndrome_launches
    # one plain decode: the syndrome kernel, then the decode kernel
    check(launches == 2 and syn_launches == 1,
          f"the main path's decode launched {launches} RS kernels, {syn_launches} "
          "of them the syndrome kernel; a plain decode is 2 launches, 1 of them syndromes")
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
         "launches": launches, "syndrome_launches": syn_launches, "all_ok": True,
         "corrected": 2})
    if "--parallel-only" in (sys.argv[1:] if argv is None else argv):
        # phase 13 alone on the inputs of phases 2 and 5, for a machine
        # with several cards
        common = {"batch": BATCH, "card": card, "cards": torch.cuda.device_count(),
                  "warmup": WARMUP, "iters": ITERS}
        parallel_phase(pt, {"codec": codec, "args": (torch.as_tensor(bad, device=dev),
                                                     enc.parity)},
                       ldpc_main_path(pt, dev, rng), common)
        return 0

    # ---- phase 3: kernels against their plain versions, on the card
    max_err = syn_err = 0
    cases = syn_cases = 0

    def compare_syndromes(tag, rs_, d, p):
        """The syndrome kernel against exp2log[_syndrome] on CUDA tensors."""
        nonlocal syn_err, syn_cases
        got = rs_.kernel.syndromes(d, p)
        want = rs_kernel.plain_syndromes(rs_, d.contiguous(), p.contiguous())
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        syn_err = max(syn_err, err)
        syn_cases += 1
        check(err == 0, f"syndrome kernel != plain in {tag} (max abs err {err})")

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
            bd_t, bp_t = torch.as_tensor(bd, device=dev), torch.as_tensor(bp, device=dev)
            compare_syndromes(f"{name} B={B} size={size}", rs_, bd_t, bp_t)
            if B > 1:   # rows from the second on: a base off 16-byte alignment
                compare_syndromes(f"{name} B={B - 1} size={size} view", rs_,
                                  bd_t[1:], bp_t[1:])
            compare(f"{name} plain B={B} size={size}", rs_, "plain", bd, bp)
            sl = rs_kernel.plain_syndromes(rs_, bd_t, bp_t)
            compare(f"{name} ext B={B} size={size}", rs_, "ext", bd, bp,
                    sl.to(torch.int32).cpu().numpy())
            if size < 8:
                continue
            for E, extra in ((min(32, nr), 0), (7, 3)):   # (7, 3): the F1 input
                be, pos, cnt = erasure_case(rng, d, E, extra)
                compare(f"{name} erasure E={E}+{extra} B={B} size={size}",
                        rs_, "erasure", be, p, pos, cnt)
        # rows on which BM runs long with nonzero discrepancies: t+1..t+3
        # errors a row, and E = 1, nr/4, nr/2 erasures with (nr - E)/2 and
        # (nr - E)/2 + 1 extra errors
        B = 4096
        d = rng.integers(0, 256, (B, k), dtype=np.uint8)
        p = rs_.encode(d).cpu().numpy()
        bd, bp = corrupt(rng, d, p, rng.integers(nr // 2 + 1, nr // 2 + 4, B))
        compare(f"{name} plain B={B} t+1..t+3 errors", rs_, "plain", bd, bp)
        sl = rs_kernel.plain_syndromes(rs_, torch.as_tensor(bd, device=dev),
                                       torch.as_tensor(bp, device=dev))
        compare(f"{name} ext B={B} t+1..t+3 errors", rs_, "ext", bd, bp, sl.cpu().numpy())
        for E in (1, nr // 4, nr // 2):
            for extra in ((nr - E) // 2, (nr - E) // 2 + 1):
                be, pos, cnt = erasure_case(rng, d, E, extra)
                compare(f"{name} erasure E={E}+{extra} B={B}", rs_, "erasure", be, p, pos, cnt)
    log({"phase": "kernel_vs_plain", "cases": cases, "max_abs_err": max_err,
         "syndrome_cases": syn_cases, "syndrome_max_abs_err": syn_err})
    # ROADMAP F8: 0x11B (x of order 51) passes GF's check, but its log
    # table repeats; the gate sends it to the plain version, equal to the CPU
    cfg = pt.RSConfig(generator_polynomial=0x11B)
    rs_ = RSCodec(cfg, dev)
    check(rs_.kernel is None, "0x11B: the RS kernel's gate admits a non-primitive polynomial")
    d = rng.integers(0, 256, (1000, rs_.k), dtype=np.uint8)
    p = rs_.encode(d).cpu().numpy()
    bd, bp = corrupt(rng, d, p, rng.integers(0, 18, 1000))
    be, pos, cnt = erasure_case(rng, d, 8, 2)
    ref = RSCodec(cfg, "cpu")
    for tag, args, kw in (("plain", (bd, bp), {}), ("erasure", (be, p), {"erasures": (pos, cnt)})):
        err = max_abs_err([t.cpu() for t in rs_.decode(*args, **kw)], ref.decode(*args, **kw))
        check(err == 0, f"0x11B {tag}: the card's plain version != the CPU's (max abs err {err})")
    log({"phase": "kernel_vs_plain", "config": "poly11b", "kernel": None,
         "card_plain_vs_cpu_max_abs_err": 0})

    # ---- phase 4: timing at B = 131072 on the card
    common = {"batch": BATCH, "card": card, "warmup": WARMUP, "iters": ITERS}

    def kernel_vs_plain(bench, kernel_fn, plain_fn, args, in_bytes, ops_kw):
        """Times both in the order plain, kernel, kernel, plain; checks
        that they agree and that every row decoded to the original.
        in_bytes: bytes a row reads; ops_kw: rs_ops's mode arguments.
        Returns the kernel's ms, the plain version's and the bound."""
        got, want = kernel_fn(*args), plain_fn(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{bench}: kernel != plain")
        check(bool(got[0].all()) and torch.equal(got[1], data_dev),
              f"{bench}: rows not recovered")
        t_kern, t_plain = rs_kernel.time_in_turns(kernel_fn, plain_fn, args)
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
    eras, epos = rs_kernel.erasures_32(rng, data)
    timed = rs_kernel.calls(codec, bad, p_dev, eras, epos)
    ms, plain_ms, rs_bound = kernel_vs_plain("rs_decode_2err", *timed["k1_plain"],
                                             in_bytes=255, ops_kw={})
    kernel_vs_plain("rs_erasure_32", *timed["k2_erasure_32"],
                    in_bytes=255 + 32 * 4 + 4, ops_kw={"erasures": 32})
    kernel_vs_plain("rs_ext_syndrome", *timed["k3_ext"],
                    in_bytes=255 + 32 * 4, ops_kw={"syndromes": False})
    syn_entry = syndrome_timing(kern, *timed["syndromes"], common)

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
        "launches": launches,       # a plain decode: syndromes, then decode
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

    # ---- phases 8 and 9: the measurement path (DMA probes, waterfall)
    probe_entries = probe_phase(common)
    waterfall_phase(common)

    # ---- phases 10 to 12: BCH, streaming and the C-shaped shim
    t0 = time.perf_counter()
    bch_phase(pt, dev, rng, common)
    stream_phase(pt, dev, rng, common)
    shim_phase(pt, dev, rng, common)
    log({"phase": "bch_stream_shim", "seconds": time.perf_counter() - t0})

    # ---- phase 13: parallel/ (sharded codecs, statistics, scaling)
    parallel_phase(pt, {"codec": codec, "args": (d_dev, p_dev)}, main, common)
    del main

    syn_entry.update(launches=syn_launches, max_abs_err=syn_err)
    log({"phase": "total", "seconds": time.perf_counter() - t_start, "card": card})
    print(json.dumps({"kernels": [rs_entry, syn_entry, ldpc_entry, *probe_entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
