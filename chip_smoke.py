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
  syndrome kernel (also alone at 1 and 33 roots, the ends of its
  factoring) and the decode in all three modes against their plain
  PyTorch versions on the card (rows within and past the code's
  capacity, erasures with extra errors, so that BM runs long with
  nonzero discrepancies), and times both; then the decode on the
  benchmark cell `rs255.ser2.dev`'s mix (every symbol hit at 2/255, so
  Binomial errors a row) at B = 131072, plain and from the syndromes (the
  decode kernel alone), each equal to its plain version there and at
  B = 131071, a ragged last warp.
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
- One process a card (phase 14): `python -m torch.distributed.run`
  starts one rank a card over NCCL (two ranks on cuda:0 over gloo where
  there is one card); each opens the group through `distributed_init`
  from the launcher's environment, decodes its share of the RS 2-error
  and LDPC hard and soft inputs through ShardedCodec on its own card,
  equal to this process's facade, its kernels launched as on the main
  path, and sums ldpc_decode_step's statistics, ber_stats and
  iteration_histogram over the group, equal to the facade's and the
  CPU's; then `scaling.py --distributed` with as many ranks.  Each
  launcher is bounded, its ranks killed past the bound.

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
RS and LDPC main paths, then phases 13 and 14 alone over every visible
card: the multi-card check, for a machine with several cards.

Phase 16 drives RS(544,514) over GF(2^10), 400G Ethernet's KP4 code, at
B = 131072 codewords of 16-bit symbols through the facade: both m = 10
kernels (their launches counted) against the plain version on the card,
on the benchmark cell `rs544.ber2p4e-4.dev`'s mix (bits flipped at
2.4e-4) and on rows of exactly t = 15 and t + 1 errors, then timed; and
the gate's other m = 10 shapes (nr = 14, 16, 33 and 64, prim 2 and 7,
fcr 1 and 5) on a thousand rows each against the plain version, with the
syndrome kernel's launch shape and ptxas figures at each F; and the
syndrome kernel's two lane layouts of its half tables timed in turns,
the other one from a copy of its source built apart.
`python3 chip_smoke.py --wide-only` builds the kernels and runs phase 16
alone.

Phase 17 drives NAND flash's software BCH-8 on 512-byte sectors
(`BchConfig(13, 0x201b, 8, data_length=4096)`) at B = 131072 sectors
through the facade: the BCH decode kernel, one launch a decode, against
the plain version on the card, on the benchmark cell
`bch4200.rber5e-4.dev`'s mix (stored bits flipped at 5e-4), at exactly t
and t + 1 errors, t errors in the parity alone, on ragged and offset
batches and on rows whose locator has a root in the shortened code's pad;
parity wider than the kernel takes read as its first bytes, other widths
refused; the gate's other forms (t = 4 and 16, 1 KiB sectors at m = 14, a field of
ten bits), each also from unaligned bytes; then timed, with ptxas's
figures.  `python3 chip_smoke.py --bch-only` builds the kernels and runs
phase 17 alone.
"""

from __future__ import annotations

import json
import re
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


PTXAS_KERNELS = ("rs_decode_kernel", "rs_stripe_kernel", "rs_syndrome_wide_kernel")


def ptxas_figures(lines, form_of) -> dict:
    """Each kernel form that form_of (an entry line -> its name, or None)
    names -> its registers, stack frame, spill stores and loads and static
    shared bytes, from the build's `-Xptxas=-v` lines."""
    out, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            cur = form_of(ln)
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[cur].update(registers=int(m[1]), static_smem=int(smem[1]) if smem else 0)
    return out


def ptxas_report(lines) -> dict:
    """`ptxas_figures` of each form of the kernels PTXAS_KERNELS
    (`rs_decode_kernel<false>` and `<true>` for bytes,
    `rs_decode_kernel<10,false>` for ten-bit symbols,
    `rs_syndrome_wide_kernel<2>` for two factors, and so on)."""
    def form_of(ln):
        m = re.search(r"Compiling entry function '\w*?\d(rs_[a-z_]+_kernel)I(?:Li(\d+)E)?"
                      r"(?:Lb([01])E)?", ln)
        if not m or m[1] not in PTXAS_KERNELS:
            return None
        if m[3] is None:                    # rs_syndrome_wide_kernel<F>
            return f"{m[1]}<{m[2]}>"
        field = "" if m[2] in (None, "8") else f"{m[2]},"      # a field's form, m = 8 unnamed
        return f"{m[1]}<{field}{'true' if m[3] == '1' else 'false'}>"

    return ptxas_figures(lines, form_of)


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
    read and nr int32 logs written, plus the division and tail tables
    and the log table once.  Returns the `rs_syndrome` entry of the kernels line, less
    launches and max_abs_err."""
    import torch
    from libpoporon_tpu_torch.benchmarks.rs_kernel import time_in_turns

    check(torch.equal(kernel_fn(*args), plain_fn(*args)), f"rs_syndrome B={BATCH}: kernel != plain")
    t_kern, t_plain = time_in_turns(kernel_fn, plain_fn, args)
    ms, plain_ms = sum(t_kern) / 2, sum(t_plain) / 2
    d, p = args
    nr, n = p.shape[1], d.shape[1] + p.shape[1]
    b = bound(BATCH * (n + 4 * nr) + kern.syndrome_tables.numel() * 4 + 256 * 4,
              BATCH * syndrome_ops(nr, n))
    log({"bench": "rs_syndrome", "kernel_ms": ms, "plain_ms": plain_ms,
         "kernel_runs_ms": t_kern, "plain_runs_ms": t_plain,
         "kernel_codewords_per_s": BATCH / ms * 1e3, "table_bytes": kern.syndrome_tables.numel() * 4,
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
    that decode_*_adaptive makes, the facade with the kernel and with the
    plain version (a facade whose codec has its launcher taken away: the
    plain version under the cascade), and encode.
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
        plain = pt.create(facade.config, device="cuda")
        plain._ldpc.kernel = None
        want = facade.decode(*args, **kw)
        check(all(torch.equal(a, b) for a, b in zip(plain.decode(*args, **kw), want)),
              f"LDPC {kind}: facade with the plain version != with the kernel")
        for name, f in (("kernel", facade), ("plain", plain)):
            reps = {} if name == "kernel" else plain_runs(lambda t: f.decode(*args, **kw), None)
            t = time_ms(lambda: f.decode(*args, **kw), **reps)
            log({"bench": f"ldpc_{kind}_facade", "path": name, "ms": t,
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


# ------------------------------------------------- stripes (phase 15)

STRIPE_CONFIGS = (       # name, num_roots, cells n, erasure counts e
    ("rs14_10", 4, 14, (1, 2, 3, 4)),      # HDFS RS-10-4: the tables' path
    ("rs9_6", 3, 9, (1, 2, 3)),            # HDFS RS-6-3
    ("nr32_n40", 32, 40, (1, 7, 32)),      # past the tables: every column errors-and-erasures
)
STRIPE_GROUP = 1 << 27   # columns of a 128 MiB block group
STRIPE_BLOCK = 1 << 19   # columns a plain-version call takes in the block group's check


def stripe_cells(rng, codec, n: int, L: int, dev):
    """Shard-major cells uint8 [n, L] of L random codewords, encoded on the
    card in blocks of 2^22 columns."""
    import torch
    rs = codec._rs
    k = n - rs.num_roots
    cells = torch.empty(n, L, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    for c in range(0, L, 1 << 22):
        data = torch.randint(0, 256, (min(1 << 22, L - c), k), generator=g, device=dev,
                             dtype=torch.uint8)
        cells[:, c: c + data.shape[0]] = torch.cat([data, rs.encode(data)], dim=1).t()
    return cells


def stripe_hurt(rng, cells, lost, extra_max: int):
    """cells (NumPy [n, L]) with the lost cells filled with junk (their
    contents are ignored) and, in every 8th column at random, 1 to
    extra_max symbol errors among the surviving cells."""
    n, L = cells.shape
    cells = cells.copy()
    cells[list(lost)] = rng.integers(0, 256, (len(lost), L), dtype=np.uint8)
    surv = np.array([j for j in range(n) if j not in lost])
    cols = np.nonzero(rng.random(L) < 1 / 8)[0]
    for m in range(extra_max):
        pick = cols if m == 0 else cols[rng.random(len(cols)) < 0.5]
        rows = surv[rng.integers(0, len(surv), len(pick))]
        cells[rows, pick] ^= rng.integers(1, 256, len(pick), dtype=np.uint8)
    return cells


def stripe_group_check(codec, group, lost, rng) -> int:
    """The stripe kernel on a whole block group with 1 or 2 symbol errors
    among the survivors of every 64th column (every other one of those
    past capacity at e = 1 and 2), against the plain version on the card
    a block of STRIPE_BLOCK columns at a time: every output, the persistent
    blocks' walk and the last block's sum of `failed` included.  Returns
    the largest difference."""
    import torch
    dev, L = group.device, group.shape[1]
    surv = torch.tensor([c for c in range(group.shape[0]) if c not in lost], device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    hurt = group.clone()
    cols = torch.arange(0, L, 64, device=dev) + torch.randint(0, 64, (L // 64,), generator=g,
                                                               device=dev)
    first = torch.randint(0, len(surv), cols.shape, generator=g, device=dev)
    hurt[surv[first], cols] ^= torch.randint(1, 256, cols.shape, generator=g, device=dev,
                                             dtype=torch.uint8)
    step = torch.randint(1, len(surv), cols[::2].shape, generator=g, device=dev)
    hurt[surv[(first[::2] + step) % len(surv)], cols[::2]] ^= torch.randint(
        1, 256, cols[::2].shape, generator=g, device=dev, dtype=torch.uint8)
    got = codec.reconstruct(hurt, lost)
    err, failed = 0, 0
    for c in range(0, L, STRIPE_BLOCK):
        want = codec._rs._reconstruct(hurt[:, c: c + STRIPE_BLOCK], tuple(lost))
        for a, b in zip((got.ok[c: c + STRIPE_BLOCK], got.rebuilt[:, c: c + STRIPE_BLOCK],
                         got.corrected[c: c + STRIPE_BLOCK]), want[:3]):
            err = max(err, int((a.int() - b.int()).abs().max()))
        failed += int(want[3])
    check(failed > 0, f"block group lost={lost}: the errors failed no column")
    return max(err, abs(int(got.failed) - failed))


def stripe_phase(pt, dev, rng, common) -> dict:
    """`Codec.reconstruct` on the card: the stripe kernel against its plain
    version on the card (every output, `failed` included) at L = 131072
    and 131071 (the 16-byte and the byte-wise loads), e = 1..nr lost cells
    named ascending and in another order, and every 8th column with 1 to
    (nr - e) / 2 + 1 symbol errors among the survivors (the
    errors-and-erasures path, within and past capacity); each call one
    launch, and a second call equal to the first (the kernel's ticket
    left at zero); where no survivor is hurt, the lost cells' own bytes.
    RS(40, 8) of 32 roots has no tables: every column takes the
    errors-and-erasures path.  Then a whole block group (14 cells of 2^27
    bytes) at e = 2, then 1 (a launch with more shared memory after one
    with less), named in the order drawn: the call's launches,
    the lost cells' own bytes back, and `stripe_group_check`; the
    kernel's time beside its bound, and the plain version's at 131072."""
    import torch
    from libpoporon_tpu_torch.utils.profiling import time_ms
    cases = 0
    for name, nr, n, es in STRIPE_CONFIGS:
        first = cases
        codec = pt.create(pt.RSConfig(num_roots=nr), device="cuda")
        rs, kern = codec._rs, codec._rs.kernel
        check(kern is not None, f"{name}: no kernel")
        for L in (BATCH, BATCH - 1):
            word = stripe_cells(rng, codec, n, L, dev).cpu().numpy()
            for e in es:
                lost = rng.choice(n, e, replace=False).tolist()
                for order in (sorted(lost), lost):
                    cells = torch.as_tensor(stripe_hurt(rng, word, order, (nr - e) // 2 + 1),
                                            device=dev)
                    before = kern.stripe_launches
                    got = codec.reconstruct(cells, order)
                    check(kern.stripe_launches == before + 1,
                          f"{name} L={L} lost={order}: {kern.stripe_launches - before} launches")
                    want = rs._reconstruct(cells, tuple(order))
                    again = codec.reconstruct(cells, order)
                    torch.cuda.synchronize()
                    for tag, a, b in zip(("ok", "rebuilt", "corrected", "failed"), got, want):
                        check(a.dtype == b.dtype and torch.equal(a, b),
                              f"{name} L={L} lost={order}: {tag} != the plain version's")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{name} L={L} lost={order}: a second call differs")
                    sound = (cells.cpu().numpy() == word)[[j for j in range(n)
                                                           if j not in order]].all(0)
                    check(np.array_equal(got.rebuilt.cpu().numpy()[:, sound],
                                         word[order][:, sound]),
                          f"{name} L={L} lost={order}: not the lost cells' own bytes")
                    cases += 1
        log({"phase": "stripe", "config": name, "cells": n, "roots": nr,
             "tables": kern._stripe_plan(n, (0,)).fast, "cases": cases - first})

    # a whole block group, e = 2 and 1: checked, then timed beside the
    # plain version at 131072
    codec = pt.create(pt.RSConfig(num_roots=4), device="cuda")
    kern = codec._rs.kernel
    group = stripe_cells(rng, codec, 14, STRIPE_GROUP, dev)
    small = group[:, :BATCH].contiguous()
    entry, group_err = None, 0
    for e in (2, 1):
        lost = rng.choice(14, e, replace=False).tolist()
        kern.launches = kern.stripe_launches = 0
        got = codec.reconstruct(group, lost)
        launches = kern.stripe_launches
        check((kern.launches, launches) == (1, 1),
              f"block group lost={lost}: {kern.launches} launches, {launches} of the stripe kernel")
        check(int(got.failed) == 0 and bool(got.ok.all()), f"block group lost={lost}: not ok")
        check(torch.equal(got.rebuilt, group[lost]),
              f"block group lost={lost}: not the lost cells' own bytes")
        del got
        err = stripe_group_check(codec, group, lost, rng)
        check(err == 0, f"block group lost={lost}: {err} off the plain version")
        group_err = max(group_err, err)
        ms = time_ms(codec.reconstruct, group, lost)
        plain_ms = time_ms(codec._rs._reconstruct, small, tuple(lost), warmup=1, iters=3)
        b = bound(STRIPE_GROUP * (14 - e + e + 2) + 4, 0)
        log({"bench": "rs_stripe", "cells": 14, "columns": STRIPE_GROUP, "lost": lost,
             "kernel_ms": ms, "GB_per_s": STRIPE_GROUP * (16 - e + e) / ms / 1e6,
             "plain_ms_at_131072": plain_ms, **b, "share_of_bound": b["bound_ms"] / ms,
             **common})
        entry = {"name": "rs_stripe", "route": "cuda",
                 "source": "libpoporon_tpu_torch/csrc/rs_decode.cu",
                 "replaces": None, "launches": launches, "ms": ms,
                 "plain_ms": plain_ms, "plain_columns": BATCH, **b, "library_ms": None}
    entry["max_abs_err"] = group_err
    log({"phase": "stripe", "cases": cases, "block_group_max_abs_err": group_err})
    return entry


# ---------------------------------------------- ten-bit symbols (phase 16)

WIDE_CONFIG = (10, 0x409, 0, 1, 30)     # RS(544,514) "KP4", IEEE 802.3 Clause 91
WIDE_SIZE = 514
WIDE_PER_BIT = 2.4e-4                   # fecbench/traffic/ber2p4e-4.dev.json's bit error rate
WIDE_PLAIN_ROWS = 16384                 # rows a block of the plain version ([rows, 10230] evaluations)


def wide_bit_flips(g, word, m: int, per_bit: float):
    """word with each of its symbols' m bits flipped independently at
    per_bit (fecbench/channels/bit_flips.py's channel)."""
    import torch
    err = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    for b in range(m):
        err |= (torch.rand(word.shape, generator=g, device=word.device) < per_bit).to(torch.int32) << b
    return word ^ err.to(word.dtype)


def wide_exact_errors(g, word, fs: int, count):
    """word with `count` symbol errors a row (an int, or a tensor [B] of
    each row's count) at distinct positions, each a random nonzero XOR."""
    import torch
    B, n = word.shape
    rank = torch.rand((B, n), generator=g, device=word.device).argsort(dim=1).argsort(dim=1)
    val = torch.randint(1, fs + 1, (B, n), generator=g, device=word.device, dtype=torch.int32)
    count = torch.as_tensor(count, device=word.device).reshape(-1, 1)
    return word ^ torch.where(rank < count, val, 0).to(word.dtype)


# the gate's other m = 10 shapes: (config, data symbols), one of each
# syndrome form F = ceil(nr / 16) = 1, 3 and 4 and a prim and fcr other than KP4's
WIDE_SHAPES = (((10, 0x409, 0, 1, 14), 514),     # RS(528,514) "KR4", Clause 91's other code
               ((10, 0x409, 5, 1, 16), 300),     # fcr 5, one whole factor
               ((10, 0x409, 0, 2, 33), 900),     # prim 2, a factor of one root
               ((10, 0x409, 1, 7, 64), 959))     # prim 7, fcr 1, the whole 1023 symbols
WIDE_SHAPE_ROWS = 1001                           # ragged against every block of rows


def wide_shapes(pt, dev, forms) -> list[dict]:
    """The m = 10 kernels at the gate's other shapes (WIDE_SHAPES), each
    on B = WIDE_SHAPE_ROWS rows with 0 to t + 2 errors, in full and from
    row 1: each decode launches both kernels (the counts move by 2 and
    1) and equals the plain version, the syndrome kernel equals its plain
    version, and every row of at most t errors is recovered.  Each entry
    carries the syndrome kernel's launch shape (blocks the card holds,
    lane copies, dynamic shared bytes) and ptxas figures at its F."""
    import torch
    out = []
    for cfg, size in WIDE_SHAPES:
        codec = pt.create(pt.RSConfig(*cfg), device="cuda")
        rs, kern = codec._rs, codec._rs.kernel
        check(kern is not None and kern.m == 10, f"{cfg} has no m = 10 kernel")
        nr, fs = rs.num_roots, rs.fs
        g = torch.Generator(device=dev).manual_seed(cfg[2] * 1000 + nr)
        info = torch.randint(0, fs + 1, (WIDE_SHAPE_ROWS, size), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int16)
        word = torch.cat([info, codec.encode(info).parity], dim=1)
        count = torch.arange(WIDE_SHAPE_ROWS, device=dev) % (nr // 2 + 3)
        w = wide_exact_errors(g, word, fs, count)
        d, p = w[:, :size].contiguous(), w[:, size:].contiguous()
        for tag, (dd, pp) in (("all", (d, p)), ("from_row_1", (d[1:], p[1:]))):
            kern.launches = kern.syndrome_launches = 0
            got = codec.decode(dd, pp)
            check(kern.launches == 2 and kern.syndrome_launches == 1,
                  f"wide {cfg} {tag}: {kern.launches} launches, "
                  f"{kern.syndrome_launches} of syndromes")
            want = rs._decode_plain(dd, pp)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"wide {cfg} {tag}: kernels != plain version")
            check(torch.equal(kern.syndromes(dd, pp), rs.exp2log[rs._syndrome(dd, pp).long()]),
                  f"wide {cfg} {tag}: syndrome kernel != plain version")
        within = count <= nr // 2
        check(bool(got.ok[within[1:]].all()) and torch.equal(got.data[within[1:]], info[1:][within[1:]]),
              f"wide {cfg}: rows of at most t errors not recovered")
        out.append({"config": cfg, "size": size, "rows": WIDE_SHAPE_ROWS,
                    "ok_share": float(got.ok.float().mean()),
                    "syndrome_shape": kern._syndrome_shape(dev),
                    **forms.get(f"rs_syndrome_wide_kernel<{-(-nr // 16)}>", {})})
    return out


# rs_syndrome_wide_kernel<2>'s figures where T was one [F][2][1024] table of
# 16-byte halves with no lane copies (about 37 conflicted wavefronts a warp
# and symbol): ptxas registers, dynamic shared bytes, blocks an SM
WIDE_SYNDROME_BEFORE = {"registers": 80, "dynamic_smem": 74688, "blocks_per_sm": 2}
WIDE_LOAD_WORDS = re.compile(r"^constexpr int kWideLoadWords = (\d+);", re.M)


def wide_layouts(kern, dev, d, p, want, common) -> None:
    """The wide syndrome kernel's two lane layouts of its half tables timed
    in turns on the rows d | p (kept, other, other, kept): the kept one,
    the package's, a copy a lane with 32-bit loads (kWideLoadWords 1) or
    a copy a lane pair with 64-bit loads (2); the other one from a copy
    of csrc/rs_decode.cu with that constant changed, built apart and
    checked equal to `want` first."""
    import torch
    from libpoporon_tpu_torch.benchmarks.rs_kernel import library_copy
    from libpoporon_tpu_torch.utils import build
    from libpoporon_tpu_torch.utils.profiling import time_ms

    src = (build.CSRC_DIR / "rs_decode.cu").read_text()
    found = WIDE_LOAD_WORDS.findall(src)
    check(len(found) == 1, f"kWideLoadWords defined {len(found)} times")
    kept = int(found[0])
    other = 3 - kept
    lib, lines = library_copy(WIDE_LOAD_WORDS.sub(f"constexpr int kWideLoadWords = {other};", src),
                              f"wide_load_words_{other}")
    own = build.load_library
    shapes, runs = {kept: kern._syndrome_shape(dev)}, {kept: [time_ms(kern.syndromes, d, p)]}
    try:
        build.load_library = lambda: lib          # the launcher now runs the copy's kernel
        kern._syndrome_shapes.clear()
        shapes[other] = kern._syndrome_shape(dev)
        check(torch.equal(kern.syndromes(d, p), want),
              f"wide syndromes at kWideLoadWords {other} != plain version")
        runs[other] = [time_ms(kern.syndromes, d, p), time_ms(kern.syndromes, d, p)]
    finally:
        build.load_library = own
        kern._syndrome_shapes.clear()
    runs[kept].append(time_ms(kern.syndromes, d, p))
    other_forms = ptxas_report(lines)
    out = {str(w): {"ms": runs[w], "shape": shapes[w]} for w in (kept, other)}
    out[str(other)].update(other_forms.get("rs_syndrome_wide_kernel<2>", {}))
    log({"bench": "rs544_syndrome_layouts", "kept_load_words": kept, "layouts": out, **common})


def wide_phase(pt, dev, forms, common) -> list[dict]:
    """Phase 16: RS(544,514) over GF(2^10) through the facade on the card,
    B = BATCH codewords of 16-bit symbols.  The codec holds the m = 10
    kernels; encode equals the NumPy LFSR; each decode (both kernels, the
    launcher's counts moving by 2 and 1) equals the plain version on the
    card, and the syndrome kernel alone equals its plain version, on the
    cell `rs544.ber2p4e-4.dev`'s mix (bits flipped at 2.4e-4), on rows with
    exactly t = 15 errors (all recovered) and t + 1 (rows fail), at B - 1
    and from row 1 (rows 4-byte aligned); the gate's other shapes on a
    thousand rows each (`wide_shapes`); then the kernels, the facade and
    the plain version timed, and the syndrome kernel's two lane layouts
    (`wide_layouts`).  Returns the two kernels' entries of the kernels
    line."""
    import torch
    from libpoporon_tpu_torch.benchmarks.rs_kernel import time_in_turns
    from libpoporon_tpu_torch.models.rs import _encode_np
    from libpoporon_tpu_torch.utils.profiling import time_ms

    t0 = time.perf_counter()
    codec = pt.create(pt.RSConfig(*WIDE_CONFIG), device="cuda")
    rs, kern = codec._rs, codec._rs.kernel
    build_s = time.perf_counter() - t0
    check(kern is not None and kern.m == 10, "RS(544,514) over GF(2^10) has no m = 10 kernel")
    check(codec.symbol_dtype == torch.int16, f"symbol dtype {codec.symbol_dtype}")
    nr, size, fs = rs.num_roots, WIDE_SIZE, rs.fs
    n = size + nr
    g = torch.Generator(device=dev).manual_seed(16)
    info = torch.randint(0, fs + 1, (BATCH, size), generator=g, device=dev,
                         dtype=torch.int32).to(torch.int16)
    enc = codec.encode(info)
    check(enc.parity.dtype == torch.int16 and tuple(enc.parity.shape) == (BATCH, nr),
          f"encode gave {enc.parity.dtype} {tuple(enc.parity.shape)}")
    lfsr = _encode_np(rs.gf, rs.genlog, nr, info[:256].cpu().numpy().astype(np.int64))
    check(np.array_equal(enc.parity[:256].cpu().numpy().astype(np.int64), lfsr),
          "m = 10 encode != NumPy LFSR")
    word = torch.cat([info, enc.parity], dim=1)
    cases = {"ber2p4e-4": wide_bit_flips(g, word, 10, WIDE_PER_BIT),
             "t15": wide_exact_errors(g, word, fs, 15),
             "t16": wide_exact_errors(g, word, fs, 16)}

    def plain(d, p):
        parts = [rs._decode_plain(d[i:i + WIDE_PLAIN_ROWS], p[i:i + WIDE_PLAIN_ROWS])
                 for i in range(0, d.shape[0], WIDE_PLAIN_ROWS)]
        return tuple(torch.cat(x) for x in zip(*parts))

    def plain_syndromes(d, p):
        return torch.cat([rs.exp2log[rs._syndrome(d[i:i + WIDE_PLAIN_ROWS],
                                                  p[i:i + WIDE_PLAIN_ROWS]).long()]
                          for i in range(0, d.shape[0], WIDE_PLAIN_ROWS)])

    def same(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    out = {}
    for name, w in cases.items():
        d, p = w[:, :size].contiguous(), w[:, size:].contiguous()
        kern.launches = kern.syndrome_launches = 0
        got = codec.decode(d, p)
        check(kern.launches == 2 and kern.syndrome_launches == 1,
              f"wide {name}: {kern.launches} launches, {kern.syndrome_launches} of syndromes")
        check(same(got, plain(d, p)), f"wide {name}: kernels != plain version")
        check(torch.equal(kern.syndromes(d, p), plain_syndromes(d, p)),
              f"wide {name}: syndrome kernel != plain version")
        for tag, (dd, pp) in (("ragged", (d[:BATCH - 1], p[:BATCH - 1])),
                              ("from_row_1", (d[1:], p[1:])),
                              ("one_row", (d[:1], p[:1])), ("33_rows", (d[:33], p[:33]))):
            check(same(codec.decode(dd, pp), plain(dd, pp)), f"wide {name} {tag}: kernels != plain")
        ok = got.ok
        if name == "t15":
            check(bool(ok.all()) and torch.equal(got.data, info) and bool((got.corrected == 15).all()),
                  "wide t15: rows not recovered")
        if name == "t16":
            check(not bool(ok.all()), "wide t16: every row passed")
        out[name] = {"ok_share": float(ok.float().mean()),
                     "rows_with_errors": int((w != word).any(dim=1).sum()),
                     "mean_corrected": float(got.corrected.float().mean())}
    log({"phase": "wide", "config": repr(codec.config), "codec_build_s": build_s,
         "cases": out, "kernel_vs_plain": "equal", "launches_per_decode": 2, **common})
    log({"phase": "wide_shapes", "cases": wide_shapes(pt, dev, forms), "kernel_vs_plain": "equal",
         "launches_per_decode": 2})

    # timing on the cell's mix
    w = cases["ber2p4e-4"]
    d, p = w[:, :size].contiguous(), w[:, size:].contiguous()
    s_log = kern.syndromes(d, p)
    t_syn, _ = time_in_turns(kern.syndromes, None, (d, p))
    t_dec, _ = time_in_turns(kern.decode_ext, None, (d, p, s_log))
    t_fac = time_ms(codec.decode, d, p)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = plain(d, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    corrected = want[3].cpu()
    syn_ms, dec_ms = sum(t_syn) / 2, sum(t_dec) / 2
    syn_b = bound(BATCH * (2 * n + 4 * nr), BATCH * nr * n / 2)
    dec_b = bound(BATCH * (2 * n + 4 * nr + 2 * n + 1 + 4),
                  rs_ops(nr, n, n, corrected, syndromes=False))
    log({"bench": "rs544_syndrome", "kernel_ms": syn_ms, "kernel_runs_ms": t_syn, **syn_b,
         "share_of_bound": syn_b["bound_ms"] / syn_ms, **common})
    log({"bench": "rs544_decode", "kernel_ms": dec_ms, "kernel_runs_ms": t_dec, **dec_b,
         "share_of_bound": dec_b["bound_ms"] / dec_ms, **common})
    log({"bench": "rs544_facade", "ms": t_fac, "codewords_per_s": BATCH / t_fac * 1e3,
         "payload_MB_per_s": BATCH * size * 10 / 8 / t_fac / 1e3,
         "plain_ms": plain_ms, **common})
    wide_layouts(kern, dev, d, p, s_log, common)
    log({"phase": "wide_shape", "decode": {"shape": kern.decode_shape(dev, False),
                                           **forms.get("rs_decode_kernel<10,false>", {})},
         "syndrome": {"shape": kern._syndrome_shape(dev),
                      **forms.get("rs_syndrome_wide_kernel<2>", {})},
         "syndrome_before": WIDE_SYNDROME_BEFORE})
    del cases, w, d, p, want
    return [{"name": "rs544_syndrome", "route": "cuda",
             "source": "libpoporon_tpu_torch/csrc/rs_decode.cu", "replaces": None,
             "ms": syn_ms, "plain_ms": None, **syn_b, "library_ms": None},
            {"name": "rs544_decode", "route": "cuda",
             "source": "libpoporon_tpu_torch/csrc/rs_decode.cu", "replaces": None,
             "ms": dec_ms, "plain_ms": plain_ms, "plain_ms_is": "the whole plain decode",
             **dec_b, "library_ms": None}]


# ------------------------------------------ NAND sector BCH (phase 17)

BCH_NAND = (13, 0x201B, 8, 4096)        # Linux's software BCH-8 on 512-byte sectors
BCH_PER_BIT = 5e-4                      # fecbench/traffic/rber5e-4.dev.json's raw bit error rate
BCH_PLAIN_ROWS = 16384                  # rows a block of the plain version
BCH_PAD_ROWS = 1024                     # rows whose locator has a root in the pad
BCH_WIDTH_ROWS = 4096                   # rows of the widths the kernel takes or refuses
# the gate's other forms: t = 4 and 16 on 512-byte sectors, 1 KiB sectors
# at m = 14 (Linux's step 1024) and a field of ten bits
BCH_SHAPES = ((13, 0x201B, 4, 4096), (13, 0x201B, 16, 4096), (14, 0x402B, 16, 8192),
              (10, 0x409, 3, 512))
BCH_SHAPE_ROWS = 4001                   # ragged against every block of rows
BCH_FORM = re.compile(r"Compiling entry function '\w*?(bch_decode_kernel)ILi(\d+)ELi(\d+)E")


def bch_ptxas(lines) -> dict:
    """`ptxas_figures` of each `bch_decode_kernel<lanes,words>`."""
    def form_of(ln):
        m = BCH_FORM.search(ln)
        return f"{m[1]}<{m[2]},{m[3]}>" if m else None

    return ptxas_figures(lines, form_of)


def bch_errors(g, c, B: int, count, parity_only: bool = False):
    """Byte errors (data [B, data_bytes], parity [B, parity_bytes]) with
    count[r] distinct bit errors in row r (an int or a tensor [B]), over
    the whole word or its parity alone."""
    import torch
    span = c.parity_bits if parity_only else c.n
    count = torch.as_tensor(count, device=g.device).reshape(-1, 1).expand(B, 1)
    k = int(count.max())
    bits = torch.zeros(B, c.n, dtype=torch.int32, device=g.device)
    if k:
        pos = torch.rand((B, span), generator=g, device=g.device).topk(k, dim=1).indices
        bits.scatter_(1, pos, (torch.arange(k, device=g.device)[None, :] < count).to(torch.int32))
    return c.unpack_data(bits[:, c.parity_bits:]), c.unpack_parity(bits[:, : c.parity_bits])


def bch_pad_rows(c, data, parity, seed: int):
    """Rows with the syndromes of 1 + r % t bit errors in row r, some in
    the pad of the shortened code, each pad bit's x^p mod g(x) flipped in
    the parity instead: every row must fail."""
    rng = np.random.default_rng(seed)
    d, p = data.cpu().numpy().copy(), parity.cpu().numpy().copy()
    rem, a = [], 1                                  # x^q mod g(x), q = 0 .. fs - 1
    for _ in range(c.fs):
        rem.append(a)
        a <<= 1
        if a >> c.parity_bits & 1:
            a ^= c.gen_poly
    for r in range(d.shape[0]):
        weight = 1 + r % c.t
        pad = 1 + (r // c.t) % weight
        flips = set(int(q) for q in rng.choice(c.n, weight - pad, replace=False))
        for q in rng.choice(np.arange(c.n, c.fs), pad, replace=False):
            flips ^= {b for b in range(c.parity_bits) if rem[int(q)] >> b & 1}
        for q in flips:
            if q < c.parity_bits:
                p[r, c.parity_bytes - 1 - q // 8] ^= 1 << (q % 8)
            else:
                d[r, c.data_bytes - 1 - (q - c.parity_bits) // 8] ^= 1 << ((q - c.parity_bits) % 8)
    import torch
    return torch.as_tensor(d, device=data.device), torch.as_tensor(p, device=data.device)


def bch_plain(c, d, p):
    """The plain version's decode of bytes, in blocks of BCH_PLAIN_ROWS."""
    import torch
    parts = [c.decode_bytes_plain(d[i:i + BCH_PLAIN_ROWS], p[i:i + BCH_PLAIN_ROWS])
             for i in range(0, d.shape[0], BCH_PLAIN_ROWS)]
    return tuple(torch.cat(x) for x in zip(*parts))


def bch_same(codec, d, p, what: str) -> None:
    """The facade's decode on the card (one kernel launch) equals the plain
    version, last_num_errors included."""
    import torch
    kern = codec._bch.kernel
    kern.launches = 0
    got = codec.decode(d, p)
    check(kern.launches == 1, f"BCH {what}: {kern.launches} kernel launches, not 1")
    want = bch_plain(codec._bch, d, p)
    check(torch.equal(got.ok, want[0]) and torch.equal(got.data, want[1])
          and torch.equal(got.corrected, want[2]) and torch.equal(got.parity, p),
          f"BCH {what}: kernel != plain version")
    check(torch.equal(codec.last_num_errors, torch.where(want[0], want[2], -1)),
          f"BCH {what}: last_num_errors")
    return got


def bch_shapes(pt, dev) -> list[dict]:
    """The gate's other forms (BCH_SHAPES) on BCH_SHAPE_ROWS rows of 0 to
    t + 2 errors, in full, from row 1 and with the rows' bytes off their
    16-byte alignment (the kernel's byte path), each equal to the plain
    version; rows of at most t errors recovered."""
    import torch
    out = []
    for params in BCH_SHAPES:
        m, poly, t, k = params
        codec = pt.create(pt.BchConfig(m, poly, t, data_length=k), device="cuda")
        c = codec._bch
        check(c.kernel is not None, f"BCH {params} has no kernel")
        g = torch.Generator(device=dev).manual_seed(m * 100 + t)
        info = torch.randint(0, 256, (BCH_SHAPE_ROWS, c.data_bytes), generator=g, device=dev,
                             dtype=torch.uint8)
        parity = codec.encode(info).parity
        count = torch.arange(BCH_SHAPE_ROWS, device=dev) % (t + 3)
        ed, ep = bch_errors(g, c, BCH_SHAPE_ROWS, count)
        d, p = info ^ ed, parity ^ ep
        got = bch_same(codec, d, p, f"{params} all")
        bch_same(codec, d[1:], p[1:], f"{params} from row 1")
        odd = torch.empty(BCH_SHAPE_ROWS * c.data_bytes + 1, dtype=torch.uint8, device=dev)
        du = odd[1:].view(BCH_SHAPE_ROWS, c.data_bytes)
        du.copy_(d)
        bch_same(codec, du, p, f"{params} unaligned")
        within = count <= t
        check(bool(got.ok[within].all()) and torch.equal(got.data[within], info[within]),
              f"BCH {params}: rows of at most t errors not recovered")
        out.append({"config": params, "rows": BCH_SHAPE_ROWS,
                    "ok_share": float(got.ok.float().mean()), "shape": c.kernel.shape(dev)})
    return out


def bch_nand_phase(pt, dev, ptxas, common) -> dict:
    """Phase 17: NAND flash's software BCH-8 on 512-byte sectors
    (BchConfig(13, 0x201b, 8, data_length=4096), BCH(8191, 8087) shortened
    to 4,200 bits) through the facade on the card, B = BATCH sectors.  The
    codec holds the BCH decode kernel; each decode is one launch and equals
    the plain version on the card (run in blocks of rows), last_num_errors
    included: on the benchmark cell `bch4200.rber5e-4.dev`'s mix (stored
    bits flipped at 5e-4), at exactly t = 8 (all recovered) and t + 1
    errors, t errors in the parity alone, at B - 1 rows, from row 1, at 1
    and 33 rows; on rows whose locator has a root in the pad (all fail);
    on parity wider than 13 bytes, of which both read the first 13; data
    of 513 bytes and parity of 12 refused with ValueError and no launch;
    the gate's other forms (`bch_shapes`); then the kernel, the facade and
    a block of the plain version timed, with ptxas's figures.  Returns the
    kernel's entry of the kernels line."""
    import torch
    from fecbench.channels.stored_bit_flips import errors as stored_errors
    from fecbench.metrics.bch_decode_roofline import decode_bytes, decode_ops
    from libpoporon_tpu_torch.utils.profiling import time_ms

    t0 = time.perf_counter()
    codec = pt.create(pt.BchConfig(*BCH_NAND[:3], data_length=BCH_NAND[3]), device="cuda")
    c, kern = codec._bch, codec._bch.kernel
    build_s = time.perf_counter() - t0
    check(kern is not None, "the NAND BCH config has no kernel")
    check(c._M_chien is None and c._G_syn is None, "the kernel path built the plain matrices")
    check((codec.info_size, codec.parity_size) == (512, 13),
          f"sizes {codec.info_size}, {codec.parity_size}")
    g = torch.Generator(device=dev).manual_seed(17)
    info = torch.randint(0, 256, (BATCH, 512), generator=g, device=dev, dtype=torch.uint8)
    parity = codec.encode(info).parity
    err = stored_errors(g, BATCH, 512 + 13, BCH_PER_BIT, dev)
    cases = {"rber5e-4": (info ^ err[:, :512], parity ^ err[:, 512:])}
    del err
    for name, count, par in (("t8", c.t, False), ("t9", c.t + 1, False),
                             ("t8_parity", c.t, True)):
        ed, ep = bch_errors(g, c, BATCH, count, par)
        cases[name] = (info ^ ed, parity ^ ep)
    out = {}
    for name, (d, p) in cases.items():
        got = bch_same(codec, d, p, name)
        for tag, (dd, pp) in (("ragged", (d[:BATCH - 1], p[:BATCH - 1])),
                              ("from_row_1", (d[1:], p[1:])),
                              ("one_row", (d[:1], p[:1])), ("33_rows", (d[:33], p[:33]))):
            bch_same(codec, dd, pp, f"{name} {tag}")
        if name in ("t8", "t8_parity"):
            check(bool(got.ok.all()) and torch.equal(got.data, info)
                  and bool((got.corrected == c.t).all()), f"BCH {name}: rows not recovered")
        if name == "t9":
            check(not bool(got.ok.all()), "BCH t9: every row passed")
        out[name] = {"ok_share": float(got.ok.float().mean()),
                     "mean_corrected": float(got.corrected.float().mean()),
                     "rows_failed": int((~got.ok).sum())}
    pd, pp = bch_pad_rows(c, info[:BCH_PAD_ROWS], parity[:BCH_PAD_ROWS], 17)
    got = bch_same(codec, pd, pp, "pad root")
    check(not bool(got.ok.any()), "BCH pad root: a row passed")
    d, p = (x[:BCH_WIDTH_ROWS] for x in cases["rber5e-4"])
    bch_same(codec, d, torch.cat([p, p[:, :2]], dim=1), "parity of 15 bytes")
    kern.launches = 0
    for what, (dd, pp) in (("data of 513 bytes", (torch.cat([d, d[:, :1]], dim=1), p)),
                           ("parity of 12 bytes", (d, p[:, :12]))):
        try:
            codec.decode(dd, pp)
            refused = False
        except ValueError:
            refused = True
        check(refused and kern.launches == 0, f"BCH {what}: decoded, not refused")
    log({"phase": "bch_nand", "config": repr(codec.config), "codec_build_s": build_s,
         "cases": out, "pad_root_rows": BCH_PAD_ROWS, "kernel_vs_plain": "equal",
         "launches_per_decode": 1, **common})
    log({"phase": "bch_shapes", "cases": bch_shapes(pt, dev), "kernel_vs_plain": "equal"})

    # timing on the cell's mix
    d, p = cases["rber5e-4"]
    t_kern = [time_ms(kern.decode, d, p), time_ms(kern.decode, d, p)]
    t_fac = time_ms(codec.decode, d, p)
    dp, pq = d[:BCH_PLAIN_ROWS], p[:BCH_PLAIN_ROWS]
    t_plain = time_ms(c.decode_bytes_plain, dp, pq, warmup=1, iters=3)
    corrected = bch_plain(c, d, p)[2].cpu()
    ms = sum(t_kern) / 2
    b = bound(decode_bytes(BATCH, 512, 13), decode_ops(c.n, c.parity_bits, c.t, corrected))
    forms = bch_ptxas(ptxas)
    log({"bench": "bch_nand_decode", "kernel_ms": ms, "kernel_runs_ms": t_kern, **b,
         "share_of_bound": b["bound_ms"] / ms, "facade_ms": t_fac,
         "payload_MB_per_s": BATCH * 512 / t_fac / 1e3,
         "plain_ms_per_16384_rows": t_plain, "shape": kern.shape(dev), "ptxas": forms,
         **common})
    del cases, d, p
    return {"name": "bch_nand_decode", "route": "cuda",
            "source": "libpoporon_tpu_torch/csrc/bch_decode.cu", "replaces": None,
            "ms": ms, "plain_ms": t_plain * BATCH / BCH_PLAIN_ROWS,
            "plain_ms_is": "a block of 16384 rows, scaled", **b, "library_ms": None}


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


# ------------------------------------------- one process a card (phase 14)

PROC_TIMEOUT_S = 120    # a launcher's bound, its ranks included
GROUP_TIMEOUT_S = 60    # every collective's bound inside a rank


def proc_cases(pt):
    """Phase 14's decodes: name -> (config, kernel launches a decode,
    soft), the configs of phases 2 and 5."""
    return {"rs_2err": (pt.rs_config_default(), 2, False),
            "ldpc_hard": (pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), 1, False),
            "ldpc_soft": (pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), 1, True)}


def children(pid: int) -> list[int]:
    """The processes whose parent is pid (torchrun starts each rank in a
    session of its own, so killing its group does not reach them)."""
    kids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            if ppid == pid:
                kids.append(int(d.name))
    return kids


def launch_ranks(n: int, args: list[str]) -> str:
    """`python -m torch.distributed.run --standalone --nproc-per-node n
    ARGS` from the repository's root, bounded by PROC_TIMEOUT_S: past it
    the launcher and its ranks are killed.  Raises unless it exits 0;
    returns its standard output."""
    import os
    import signal
    import subprocess

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", str(n), *args],
                         cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        out, err = p.communicate(timeout=PROC_TIMEOUT_S)
    finally:
        if p.poll() is None:
            for pid in children(p.pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.kill()
            p.communicate()
    check(p.returncode == 0, f"ranks of {' '.join(args)} exited {p.returncode}:\n{err[-4000:]}")
    return out


def processes_rank(tmp: Path) -> int:
    """One rank of phase 14, started by torchrun: opens the group from its
    environment through distributed_init, decodes its 1/N of phase 14's
    inputs through ShardedCodec on a one-entry mesh of its own card with
    group=WORLD, compares them with the single-process facade's rows,
    counts its kernels' launches, and reduces ldpc_decode_step's sums,
    ber_stats and iteration_histogram over WORLD.  Writes its results to
    tmp/rank{RANK}.json."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    import libpoporon_tpu_torch as pt
    from libpoporon_tpu_torch.parallel import (ShardedCodec, batch_mesh, ber_stats,
                                               distributed_init, iteration_histogram)
    from libpoporon_tpu_torch.utils.bits import unpack

    t0 = time.perf_counter()
    meta = json.loads((tmp / "meta.json").read_text())
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    lo, hi = BATCH * rank // world, BATCH * (rank + 1) // world

    def rows(name):
        return torch.from_numpy(np.array(np.load(tmp / f"{name}.npy", mmap_mode="r")[lo:hi])).to(dev)

    res = {"rank": rank, "world": world, "device": str(dev), "backend": meta["backend"],
           "rows": [lo, hi], "cases": {}}

    def decode():
        """The rank's decodes and reductions into res; its codecs hold
        the group and go with it."""
        mesh = batch_mesh([dev])
        codecs = {}
        for name, (cfg, per_decode, soft) in proc_cases(pt).items():
            codecs[name] = sc = ShardedCodec(pt.create(cfg, device=dev), mesh,
                                             group=dist.group.WORLD)
            kw = {"soft_llr": rows(f"{name}_llr")} if soft else {}
            args = rows(f"{name}_in0"), rows(f"{name}_in1")
            zero_counts(sc)
            got = sc.decode(*args, **kw)
            torch.cuda.synchronize(dev)
            launches, syn = kernel_counts(sc)
            want = [rows(f"{name}_want{i}") for i in range(4)]
            same_shape = all(a.shape == b.shape and a.dtype == b.dtype
                             for a, b in zip(got, want))
            res["cases"][name] = {"max_abs_err": max_abs_err(got, want),
                                  "same_shapes": same_shape, "launches": launches,
                                  "syndrome_launches": syn, "launches_a_decode": per_decode}
        sc = codecs["ldpc_hard"]
        zero_counts(sc)
        ok, out, iters, st = sc.ldpc_decode_step(rows("ldpc_hard_x"))
        ber = ber_stats(unpack(rows("ldpc_hard_word")), unpack(out))
        hist = iteration_histogram(iters, LDPC_MI)
        res.update(step=st, step_launches=kernel_counts(sc)[0],
                   errors=int(ber["errors"]), total=int(ber["total"]),
                   ber=float(ber["ber"]), hist=hist.tolist(),
                   current_device=torch.cuda.current_device())

    # the rank's card is its current device (NCCL's stream); no library
    # call below changes it
    with torch.cuda.device(dev):
        distributed_init(None, world, rank, backend=meta["backend"],
                         timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            decode()
        finally:
            # nothing holds the group now, so destroying it joins its
            # threads, which must not outlive the interpreter
            dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def processes_phase(pt, rs_case, ldpc, common):
    """Phase 14: one process a card.  torchrun starts N ranks (one a card
    over NCCL where there are several cards; two on cuda:0 over gloo on
    one card, since NCCL refuses two ranks on one card).  Each takes its
    1/N of the B = BATCH inputs of phases 2 and 5 (RS 2 errors, LDPC hard
    and soft) and decodes them as `processes_rank` says; its rows must
    equal this process's facade's, its launches 2 RS and 1 BP a decode,
    ldpc_decode_step's sums over the group the facade's over the whole
    batch, and ber_stats and iteration_histogram over the group the CPU's.
    Then the scaling benchmark's --distributed mode runs with the same N.
    Every wait is bounded; a rank that fails, hangs or writes no result
    fails the phase."""
    import tempfile

    import torch
    from libpoporon_tpu_torch.parallel import ber_stats, iteration_histogram
    from libpoporon_tpu_torch.utils.bits import unpack

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    n, backend = (cards, "nccl") if cards > 1 else (2, "gloo")
    hard = ldpc["hard"]
    x = ldpc["x"]
    inputs = {"rs_2err": (rs_case["codec"], rs_case["args"], {}),
              "ldpc_hard": (hard, (x[:, :128], x[:, 128:]), {}),
              "ldpc_soft": (ldpc["soft"], (ldpc["soft_data"], ldpc["soft_parity"]),
                            {"soft_llr": ldpc["llr"]})}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def save(name, t):
            np.save(tmp / f"{name}.npy", t.cpu().numpy())

        for name, (cfg, _, _) in proc_cases(pt).items():
            codec, args, kw = inputs[name]
            check(codec.config == cfg, f"phase 14 {name}: config {codec.config!r} != {cfg!r}")
            for i, a in enumerate(args):
                save(f"{name}_in{i}", a)
            if kw:
                save(f"{name}_llr", kw["soft_llr"])
            for i, t in enumerate(codec.decode(*args, **kw)):
                save(f"{name}_want{i}", t)
        save("ldpc_hard_x", x)
        word = torch.cat(list(hard.encode(ldpc["info"])), dim=1)
        save("ldpc_hard_word", word)
        want = hard.decode(x[:, :128], x[:, 128:])
        want_step = {"converged": int(want.ok.sum()), "iterations_total": int(want.corrected.sum())}
        _, out, iters = hard._ldpc.decode_hard(x, LDPC_MI)
        ber_cpu = ber_stats(unpack(word).cpu(), unpack(out).cpu(), group=None)
        hist_cpu = iteration_histogram(iters.cpu(), LDPC_MI, group=None).tolist()
        (tmp / "meta.json").write_text(json.dumps({"backend": backend}))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        prep_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        launch_ranks(n, [str(Path(__file__).resolve()), "--processes-rank", str(tmp)])
        ranks_s = time.perf_counter() - t1
        for r in range(n):
            f = tmp / f"rank{r}.json"
            check(f.exists(), f"phase 14: rank {r} of {n} wrote no result")
            res = json.loads(f.read_text())
            for name, c in res["cases"].items():
                check(c["max_abs_err"] == 0 and c["same_shapes"],
                      f"phase 14 rank {r} {name}: rows != the facade's ({c})")
                per = c["launches_a_decode"]
                check(c["launches"] == per and c["syndrome_launches"] == (1 if per == 2 else 0),
                      f"phase 14 rank {r} {name}: {c['launches']} launches "
                      f"({c['syndrome_launches']} syndrome), {per} a decode")
            check(len(res["cases"]) == 3, f"phase 14 rank {r}: cases {sorted(res['cases'])}")
            check(res["step"] == want_step and res["step_launches"] == 1,
                  f"phase 14 rank {r}: ldpc_decode_step {res['step']} ({res['step_launches']} "
                  f"launches) != the facade's sums {want_step}")
            check([res["errors"], res["total"], res["ber"], res["hist"]]
                  == [int(ber_cpu["errors"]), int(ber_cpu["total"]), float(ber_cpu["ber"]),
                      hist_cpu], f"phase 14 rank {r}: statistics over the group != the CPU's")
            check(res["current_device"] == int(res["device"].split(":")[1]),
                  f"phase 14 rank {r}: current device {res['current_device']}")
            log({**common, "phase": "processes", "rank": r, "processes": n,
                 "backend": backend, "device": res["device"], "rows": res["rows"],
                 "cases": res["cases"], "step": res["step"], "errors": res["errors"],
                 "total": res["total"], "max_abs_err": 0, "rank_seconds": res["seconds"]})

    t1 = time.perf_counter()
    res = json.loads(launch_ranks(n, ["-m", "libpoporon_tpu_torch.benchmarks.scaling",
                                      "--distributed"]))
    scaling_s = time.perf_counter() - t1
    check(res["processes"] == n and res["backend"] == backend
          and all(name in res for name in ("rs_decode_2err", "rs_erasure_32", "bch15",
                                           "ldpc_hard_128B", "ldpc_soft_128B")),
          f"phase 14: scaling --distributed gave {sorted(res)}")
    log({"phase": "scaling_processes", **res})
    log({"phase": "processes", "processes": n, "backend": backend, "seconds":
         time.perf_counter() - t0, "prepare_s": prep_s, "ranks_s": ranks_s,
         "scaling_s": scaling_s, "card": common["card"]})


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    if "--processes-rank" in argv:
        # one rank of phase 14, started by that phase's launcher
        return processes_rank(Path(argv[argv.index("--processes-rank") + 1]))
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
    forms = ptxas_report(ptxas)
    check(len(forms) == 9, f"ptxas lines for {sorted(forms)}, not the decode and stripe "
                           "kernels' two byte forms each, the decode kernel's ten-bit form "
                           "and the wide syndrome kernel's four")
    for name, f in forms.items():
        check(f.get("spill_stores") == 0 and f.get("spill_loads") == 0,
              f"ptxas: {name} spills ({f})")
    if "--wide-only" in argv:
        # phase 16 alone
        entries = wide_phase(pt, torch.device("cuda"), forms,
                             {"batch": BATCH, "card": card, "warmup": WARMUP, "iters": ITERS})
        print(json.dumps({"kernels": entries}), flush=True)
        print(json.dumps({"ok": True}), flush=True)
        return 0
    if "--bch-only" in argv:
        # phase 17 alone
        entry = bch_nand_phase(pt, torch.device("cuda"), ptxas,
                               {"batch": BATCH, "card": card, "warmup": WARMUP, "iters": ITERS})
        print(json.dumps({"kernels": [entry]}), flush=True)
        print(json.dumps({"ok": True}), flush=True)
        return 0
    if "--stripe-only" in argv:
        # phase 15 alone
        entry = stripe_phase(pt, torch.device("cuda"), np.random.default_rng(15),
                             {"card": card, "warmup": WARMUP, "iters": ITERS})
        print(json.dumps({"kernels": [entry]}), flush=True)
        return 0

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
    shape = {}
    for form, erasure in (("rs_decode_kernel<false>", False), ("rs_decode_kernel<true>", True)):
        per_sm, smem, carveout = kern.decode_shape(dev, erasure)
        shape[form] = {"dynamic_smem": smem, "blocks_per_sm": per_sm, "carveout_pct": carveout,
                       **forms[form]}
    log({"phase": "rs_decode_shape", "nr": rs.num_roots, **shape,
         "rs_stripe_kernel": {k: v for k, v in forms.items() if "stripe" in k}})
    if "--parallel-only" in argv:
        # phases 13 and 14 alone on the inputs of phases 2 and 5, for a
        # machine with several cards
        common = {"batch": BATCH, "card": card, "cards": torch.cuda.device_count(),
                  "warmup": WARMUP, "iters": ITERS}
        rs_case = {"codec": codec, "args": (torch.as_tensor(bad, device=dev), enc.parity)}
        main = ldpc_main_path(pt, dev, rng)
        parallel_phase(pt, rs_case, main, common)
        processes_phase(pt, rs_case, main, common)
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

    def edge_cases(tag, rs_, erng):
        """The decode kernel in all three modes at the edges of its tiles and
        copies: B = 1, 127 (a tile short of a row) and 129 (a tile and a
        row), a shortened code (size < k), each on the batch's first rows and
        on a view from row 1 (data off 16-byte alignment; parity, syndromes
        and erasure positions too where nr is not a multiple of 4)."""
        nr, k = rs_.num_roots, rs_.k
        for B, size in ((1, k), (127, k), (129, k), (129, k // 2 + 1)):
            d = erng.integers(0, 256, (B + 1, size), dtype=np.uint8)
            p = rs_.encode(d).cpu().numpy()
            bd, bp = corrupt(erng, d, p, erng.integers(0, nr // 2 + 2, B + 1))  # clean .. t + 1
            bd_t, bp_t = torch.as_tensor(bd, device=dev), torch.as_tensor(bp, device=dev)
            sl = rs_kernel.plain_syndromes(rs_, bd_t, bp_t).to(torch.int32)
            E = min(nr, 8, size)
            be, pos, cnt = erasure_case(erng, d, E, min(1, (nr - E) // 2))
            be_t, pos_t, cnt_t = (torch.as_tensor(a, device=dev) for a in (be, pos, cnt))
            for rows, view in ((slice(0, B), ""), (slice(1, B + 1), " view")):
                where = f"{tag} B={B} size={size}{view}"
                compare(f"{where} plain", rs_, "plain", bd_t[rows], bp_t[rows])
                compare(f"{where} ext", rs_, "ext", bd_t[rows], bp_t[rows], sl[rows])
                compare(f"{where} erasure E={E}", rs_, "erasure", be_t[rows], bp_t[rows],
                        pos_t[rows], cnt_t[rows])

    edge_rng = np.random.default_rng(3)   # its own, so that the later phases' inputs stay
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
        if name in ("default", "nr16", "nr64"):
            edge_cases(name, rs_, edge_rng)
    # the syndrome kernel alone at the ends of its adaptation: nr = 1 (one
    # factor, 15 bytes of its divisor a power of x) and nr = 33 (three
    # factors, one copy of T), beside nr = 16 (one factor, eight copies)
    # and nr = 64 (four factors, one copy) above
    for nr in (1, 33):
        rs_ = RSCodec(pt.RSConfig(num_roots=nr), dev)
        check(rs_.kernel is not None, f"nr{nr}: no kernel")
        for B, size in ((4096, rs_.k), (1, rs_.k), (1000, 1), (1000, 100)):
            d = rng.integers(0, 256, (B, size), dtype=np.uint8)
            p = rs_.encode(d).cpu().numpy()
            nerr = rng.integers(0, nr // 2 + 2, B)
            nerr[: B // 8] = 0
            bd, bp = corrupt(rng, d, p, nerr, B // 16)
            bd_t, bp_t = torch.as_tensor(bd, device=dev), torch.as_tensor(bp, device=dev)
            compare_syndromes(f"nr{nr} B={B} size={size}", rs_, bd_t, bp_t)
            if B > 1:
                compare_syndromes(f"nr{nr} B={B - 1} size={size} view", rs_, bd_t[1:], bp_t[1:])
        edge_cases(f"nr{nr}", rs_, edge_rng)
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
    # a generator of its own, so that the later phases' inputs stay as they were
    binom = rs_kernel.binomial_errors(np.random.default_rng(1), data, enc.parity.cpu().numpy())
    timed = rs_kernel.calls(codec, bad, p_dev, eras, epos, binom)
    ms, plain_ms, rs_bound = kernel_vs_plain("rs_decode_2err", *timed["k1_plain"],
                                             in_bytes=255, ops_kw={})
    kernel_vs_plain("rs_erasure_32", *timed["k2_erasure_32"],
                    in_bytes=255 + 32 * 4 + 4, ops_kw={"erasures": 32})
    kernel_vs_plain("rs_ext_syndrome", *timed["k3_ext"],
                    in_bytes=255 + 32 * 4, ops_kw={"syndromes": False})
    syn_entry = syndrome_timing(kern, *timed["syndromes"], common)
    # rs255.ser2.dev's rows: plain (both kernels), then the decode kernel
    # alone; each equal to its plain version at B and at B - 1
    kernel_vs_plain("rs_decode_binomial", *timed["k1_binomial"],
                    in_bytes=255, ops_kw={})
    kernel_vs_plain("rs_ext_binomial", *timed["k3_binomial"],
                    in_bytes=255 + 32 * 4, ops_kw={"syndromes": False})
    for name in ("k1_binomial", "k3_binomial"):
        kernel_fn, plain_fn, args = timed[name]
        ragged = [a[: BATCH - 1] for a in args]
        got, want = kernel_fn(*ragged), plain_fn(*ragged)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} B={BATCH - 1}: kernel != plain")
    log({"phase": "rs_binomial", "batch": BATCH, "ragged_batch": BATCH - 1,
         "rows_with_errors": int((timed["k3_binomial"][2][2] != rs.fs).any(dim=1).sum()),
         "kernel_vs_plain": "equal"})

    plain = pt.create(pt.RSConfig(), device="cuda")
    plain._rs.kernel = None          # the plain version under the facade
    check(all(torch.equal(a, b) for a, b in zip(plain.decode(d_dev, p_dev),
                                                codec.decode(d_dev, p_dev))),
          "RS: facade with the plain version != with the kernel")
    for name, c in (("kernel", codec), ("plain", plain)):
        t = time_ms(c.decode, d_dev, p_dev)
        log({"bench": "rs_decode_2err_facade", "path": name, "ms": t,
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

    # ---- phases 13 and 14: parallel/ (sharded codecs, statistics,
    # scaling), then one process a card
    rs_case = {"codec": codec, "args": (d_dev, p_dev)}
    parallel_phase(pt, rs_case, main, common)
    processes_phase(pt, rs_case, main, common)
    del main

    # ---- phase 15: stripes (Codec.reconstruct, the stripe kernel)
    stripe_entry = stripe_phase(pt, dev, np.random.default_rng(15), common)

    # ---- phase 16: ten-bit symbols (RS(544,514) over GF(2^10))
    wide_entries = wide_phase(pt, dev, forms, common)

    # ---- phase 17: NAND sector BCH (the BCH decode kernel)
    bch_entry = bch_nand_phase(pt, dev, ptxas, common)

    syn_entry.update(launches=syn_launches, max_abs_err=syn_err)
    log({"phase": "total", "seconds": time.perf_counter() - t_start, "card": card})
    print(json.dumps({"kernels": [rs_entry, syn_entry, ldpc_entry, stripe_entry,
                                  *wide_entries, bch_entry, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
