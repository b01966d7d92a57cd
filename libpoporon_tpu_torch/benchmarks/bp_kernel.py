"""Time the LDPC BP kernel on the main paths' inputs, and split its time by
pass.

    python -m libpoporon_tpu_torch.benchmarks.bp_kernel [--breakdown]

Inputs, made from seeds with the helpers chip_smoke.py's phase 5 also
uses (`distinct_positions`, `flip_bits`, `channel_llr`), at B = 131072:
hard, `LdpcConfig(128, RATE_1_2)` with 4 distinct flipped bits a row;
soft, `ldpc_config_default(128, RATE_1_2)` (both interleavers) with int8
LLRs of +-90 plus N(0, 38.6).  Each line is one JSON object carrying the
card's name and power limit and the package it imported, so that two
trees can be timed against each other in one call on one card: run this
file by path with `PYTHONPATH` set to each tree in turns (one package of
a name per process).

Default: the kernel's packed hard and int8 soft entries at the full
budget (CUDA events, 3 warm-up and 10 timed calls), the expanded-LLR `bp`
entry (hard) and the facade's decode, each with its mean iterations.

`--breakdown`: builds an instrumented copy of the imported package's
csrc/ldpc_bp.cu under its build/breakdown/ (the package's own library is
not touched), in which the first thread of each codeword group reads
clock64() at the end of each pass, and prints the cycles a codeword
spends in each (`LABELS`: `fixed_in`, taking the codeword, unpacking and
v2c_0; `check_syndrome`; `var`; `output`), and `budget_share`, the share
of all codeword cycles spent on codewords that ran out the budget.  Each
pass's time is its share of the cycles times the uninstrumented kernel's
time.  The stamps are placed by the text anchors in `ANCHORS`; an edit
to the kernel that moves one makes the build raise.
Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

import libpoporon_tpu_torch as pt
from libpoporon_tpu_torch.models.ldpc import LLR_INFINITY, LLR_MAX
from libpoporon_tpu_torch.utils import bits, build
from libpoporon_tpu_torch.utils.profiling import card_info, time_ms

BATCH = 131072
MI = 50

_PRELUDE = r"""
__device__ unsigned long long pp_stamp_sum[8];
extern "C" int pp_bp_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, pp_stamp_sum, sizeof(pp_stamp_sum));
}
extern "C" int pp_bp_stamps_clear() {
  unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(pp_stamp_sum, zero, sizeof(zero));
}
#define PP_DECL(lead) long long pp_t = clock64(), pp_c0 = pp_t, pp_acc[8] = {}; \
  const bool pp_lead = (lead)
#define PP_STAMP(k) do { if (pp_lead) { const long long n_ = clock64(); \
  pp_acc[k] += n_ - pp_t; pp_t = n_; } } while (0)
#define PP_END(ok) do { if (pp_lead) { if (!(ok)) { pp_acc[6] += pp_t - pp_c0; ++pp_acc[7]; } \
  pp_c0 = pp_t; } } while (0)
#define PP_FLUSH() do { if (pp_lead) for (int k_ = 0; k_ < 8; ++k_) \
  atomicAdd(pp_stamp_sum + k_, (unsigned long long)pp_acc[k_]); } while (0)
"""

# The labels of the stamps, and the (pattern, replacement) pairs that place
# them: each group's thread 0 stamps; the check pass carries the syndrome.
# Each pattern must match once.
LABELS = ("fixed_in", "check_syndrome", "var", "output")
ANCHORS = [
    (r"(#include <cuda_runtime.h>\n)", r"\1" + _PRELUDE.replace("\\", "\\\\")),
    (r"(  const int16_t\* in16 = static_cast<const int16_t\*>\(p.in\);\n)",
     r"\1  PP_DECL(gt == 0);\n"),
    (r"(    cw = \*next;\n  \}\n)", r"\1  PP_FLUSH();\n"),
    (r"(    group_sync\(bar, T\);\n)(\n    // Step t)", r"\1    PP_STAMP(0);\n\2"),
    (r"(          check_pass\([^;]*;\n)", r"\1      PP_STAMP(1);\n"),
    (r"(      group_sync\(bar, T\);\n)(    \}\n    const int iters = t;)",
     r"\1      PP_STAMP(2);\n\2"),
    (r"(    if \(gt == 0\) \{\n      p.ok_out\[b\] = ok;\n)",
     r"    PP_STAMP(3);\n    PP_END(ok);\n\1"),
]


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def instrument(src: str) -> str:
    """The kernel source with the stamps in place (raises if an anchor does
    not match exactly once)."""
    for pat, rep in ANCHORS:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"breakdown anchor matched {n} times: {pat}")
    return src


def instrumented_library() -> ctypes.CDLL:
    """Builds the instrumented copy of csrc/ldpc_bp.cu alone into
    build/breakdown/ and loads it with the package's argtypes."""
    out = build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ldpc_bp_stamped.cu"
    cu.write_text(instrument((build.CSRC_DIR / "ldpc_bp.cu").read_text()))
    so = out / "libldpc_bp_stamped.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    log({"breakdown_build": [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
                             if "registers" in ln or "spill" in ln]})
    lib = ctypes.CDLL(str(so))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.pp_bp_stamps.argtypes = [ctypes.c_void_p]
    return lib


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
    g = torch.Generator(device=word.device).manual_seed(seed)
    sign = 1 - 2 * bits.unpack(word, nbits).to(torch.float32)
    noise = torch.randn(sign.shape, generator=g, device=word.device) * sigma
    return (sign * 90 + noise).round().clamp(-127, 127).to(torch.int8)


def inputs(dev):
    """The hard and soft main paths' facades and kernel inputs."""
    rng = np.random.default_rng(0)
    hard = pt.create(pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), device=dev)
    soft = pt.create(pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), device=dev)
    info = rng.integers(0, 256, (BATCH, 128), dtype=np.uint8)
    pos = distinct_positions(rng, BATCH, 2048, 4)
    enc = hard.encode(info)
    word = torch.cat([enc.data, enc.parity], 1).cpu().numpy()
    x = torch.as_tensor(flip_bits(word, pos), device=dev)
    enc_s = soft.encode(info)
    llr = channel_llr(torch.cat([enc_s.data, enc_s.parity], 1), 2048, 38.6, seed=1)
    return hard, soft, x, llr, enc_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="split the kernel's time by pass with clock64() stamps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bp_kernel measures the card, and torch sees no CUDA device")
    dev = torch.device("cuda")
    common = {"card": card_info(), "package": str(build.PACKAGE_DIR), "batch": BATCH}
    hard, soft, x, llr, enc_s = inputs(dev)
    kh, ks = hard._ldpc.kernel, soft._ldpc.kernel
    entries = {"hard": (kh.bp_packed_hard, x), "soft": (ks.bp_llr8_soft, llr)}
    form = kh.form
    times = {}
    for kind, (fn, inp) in entries.items():
        got = fn(inp, MI)
        times[kind] = time_ms(fn, inp, MI)
        log({"bench": f"bp_{kind}", "ms": times[kind], "form": form,
             "mean_iterations": float(got[2].double().mean()),
             "ok_share": float(got[0].double().mean()), **common})
    if not args.breakdown:
        c = hard._ldpc
        V = c.codeword_bits
        hb = bits.unpack(c.deinterleave(x), V).T
        fake = torch.full((1, BATCH), LLR_MAX, dtype=torch.int32, device=dev)
        llr_h = torch.cat([torch.where(hb == 1, -LLR_INFINITY, LLR_INFINITY), fake])
        llr_h = llr_h.to(torch.int16)
        log({"bench": "bp_entry_hard", "ms": time_ms(kh.bp, llr_h, None, MI), **common})
        for kind, facade, a, kw in (
                ("hard", hard, (x[:, :128], x[:, 128:]), {}),
                ("soft", soft, (enc_s.data, enc_s.parity), {"soft_llr": llr})):
            t = time_ms(lambda: facade.decode(*a, **kw))
            log({"bench": f"facade_{kind}", "ms": t, "mbit_per_s": BATCH * 2048 / t / 1e3,
                 **common})
        return 0

    lib = instrumented_library()
    build.load_library = lambda: lib     # the wrappers now launch the stamped copy
    for kind, (fn, inp) in entries.items():
        fn(inp, MI)                      # warm-up
        torch.cuda.synchronize()
        if lib.pp_bp_stamps_clear() != 0:
            raise RuntimeError("pp_bp_stamps_clear failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn(inp, MI)
        end.record()
        end.synchronize()
        sums = (ctypes.c_ulonglong * 8)()
        if lib.pp_bp_stamps(ctypes.addressof(sums)) != 0:
            raise RuntimeError("pp_bp_stamps failed")
        cyc = [int(v) for v in sums]
        total = sum(cyc[: len(LABELS)])
        log({"bench": f"bp_{kind}_breakdown", "uninstrumented_ms": times[kind],
             "instrumented_ms": start.elapsed_time(end),
             "cycles_per_codeword": {k: cyc[i] / BATCH for i, k in enumerate(LABELS)},
             "share": {k: cyc[i] / total for i, k in enumerate(LABELS)},
             "ms_split": {k: cyc[i] / total * times[kind] for i, k in enumerate(LABELS)},
             "budget_share": cyc[6] / total, "budget_codewords": cyc[7],
             "mean_iterations": float(got[2].double().mean()), "form": form, **common})
    return 0


if __name__ == "__main__":
    sys.exit(main())
