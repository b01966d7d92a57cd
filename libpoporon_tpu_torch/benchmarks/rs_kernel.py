"""Time the RS decode kernels on the RS main path's inputs, and split the
decode kernel's time by stage.

    python -m libpoporon_tpu_torch.benchmarks.rs_kernel [ENTRY ...] [--breakdown]

At B = 131072 codewords of RS(255,223) (`rs_config_default()`), made
from a seed: the plain decode of rows with 2 symbol errors (`k1_plain`),
the erasure decode of rows with the same 32 erased positions
(`k2_erasure_32`), the external-syndrome decode from their log-form
syndromes (`k3_ext`), the syndrome kernel alone (`syndromes`), the
facade's decode of the 2-error rows (`facade`), and the plain and
external-syndrome decodes of rows whose every symbol, data and parity,
is hit at 2/255 (`k1_binomial`, `k3_binomial`: Binomial errors a row, the
mix of fecbench's `rs255.ser2.dev`); all of them, or the ENTRY names
given.  Each is first checked (the decodes recover every row,
the syndromes equal their plain version), then timed twice with CUDA
events (3 warm-up and 10 timed calls each).  Each line is one JSON
object carrying the card's name and power limit and the package it
imported, so that two trees can be timed against each other in one call
on one card: run this file by path with `PYTHONPATH` set to each tree in
turns (one package of a name per process).

`--breakdown`: builds an instrumented copy of the imported package's
csrc/rs_decode.cu under its build/breakdown/ (the package's own library is
not touched), in which every thread of the decode kernel reads clock64()
where each stage begins (`LABELS`: the tables in, and the warp's copy
of its rows through after its sweep; the block's log-form syndromes
read in and turned into bytes; the erasure locator, BM, degree and
Chien, Omega and Forney, verify and apply; the waits at the block's two
barriers), charging the cycles since the last reading to the stage it
leaves, so that a row that returns early charges its last stage.  One
lane of each warp adds the warp's sums.  It prints the cycles
a codeword spends in each stage for the 2-error rows (`k3_ext`), the
Binomial rows (`k3_binomial`) and the 32-erasure rows (`k2_erasure_32`),
and each stage's ms: its share of the cycles times the uninstrumented
decode kernel's time (the ext entries'; K2's less the syndrome
kernel's).  The stamps are placed by the text anchors in
`ANCHORS`; an edit to the kernel that moves one makes the build raise.
Needs a card and nvcc.

chip_smoke.py's RS timing (phase 4) takes its inputs (`two_errors`,
`erasures_32`, `binomial_errors`), its calls (`calls`) and its timer
(`time_in_turns`) from here, adding the plain versions' times and the
bounds.
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
from libpoporon_tpu_torch.utils import build
from libpoporon_tpu_torch.utils.profiling import card_info, time_ms

BATCH = 131072
PER_SYMBOL = 2 / 255   # fecbench/traffic/ser2.dev.json's symbol error rate

# entry -> its kernel call and its plain version, of (facade codec, models.rs.RSCodec)
ENTRIES = {
    "k1_plain": lambda c, rs: (rs.kernel.decode_plain, rs._decode_plain),
    "k2_erasure_32": lambda c, rs: (rs.kernel.decode_erasure, rs._decode_erasure),
    "k3_ext": lambda c, rs: (rs.kernel.decode_ext, rs._decode_ext_syndrome),
    "syndromes": lambda c, rs: (rs.kernel.syndromes, lambda d, p: plain_syndromes(rs, d, p)),
    "facade": lambda c, rs: (c.decode, None),
    "k1_binomial": lambda c, rs: (rs.kernel.decode_plain, rs._decode_plain),
    "k3_binomial": lambda c, rs: (rs.kernel.decode_ext, rs._decode_ext_syndrome),
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


def binomial_errors(rng, data, parity):
    """data and parity with every symbol hit independently at PER_SYMBOL by
    a random nonzero XOR, so that the errors a row are Binomial(n,
    PER_SYMBOL) (fecbench/channels/symbol_errors.py's channel)."""
    word = np.concatenate([data, parity], axis=1)
    hit = rng.random(word.shape) < PER_SYMBOL
    word = word ^ np.where(hit, rng.integers(1, 256, word.shape), 0).astype(np.uint8)
    k = data.shape[1]
    return word[:, :k], word[:, k:]


def plain_syndromes(rs, d, p):
    """The syndrome kernel's plain version: log-form syndromes int32 [B, nr]."""
    return rs.exp2log[rs._syndrome(d, p).long()]


def calls(codec, bad, parity, eras, epos, binomial, names=tuple(ENTRIES)):
    """name -> (kernel call, plain call or None, args) for the entries
    `names`, on parity's device: bad the 2-error rows (`two_errors`),
    parity the originals' (CUDA tensor), eras and epos the 32-erasure rows
    and their positions (`erasures_32`), binomial the Binomial rows' data
    and parity (`binomial_errors`)."""
    rs = codec._rs
    dev = parity.device
    B = parity.shape[0]
    d = torch.as_tensor(bad, device=dev)
    bd, bp = (torch.as_tensor(a, device=dev) for a in binomial)
    args = {
        "k1_plain": (d, parity),
        "k2_erasure_32": (torch.as_tensor(eras, device=dev), parity,
                          torch.as_tensor(epos, device=dev).expand(B, len(epos)).contiguous(),
                          torch.full((B,), len(epos), dtype=torch.int32, device=dev)),
        "k3_ext": (d, parity, plain_syndromes(rs, d, parity)),
        "syndromes": (d, parity),
        "facade": (d, parity),
        "k1_binomial": (bd, bp),
        "k3_binomial": (bd, bp, plain_syndromes(rs, bd, bp)),
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


_PRELUDE = r"""
#define PP_RS_STAMPED  // leaves out the stripe kernel, which the stamps do not reach
__device__ unsigned long long pp_stamp_sum[16];
extern "C" int pp_rs_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, pp_stamp_sum, sizeof(pp_stamp_sum));
}
extern "C" int pp_rs_stamps_clear() {
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pp_stamp_sum, zero, sizeof(zero));
}
// Per-thread cycle sums by stage: stage(k) charges the cycles since the
// last reading to the current stage and makes k current.
struct PPStamps {
  long long t, acc[16];
  int cur;
  __device__ PPStamps() {
    for (int k = 0; k < 16; ++k) acc[k] = 0;
    cur = 0;
    t = clock64();
  }
  __device__ __forceinline__ void stage(int k) {
    const long long now = clock64();
    acc[cur] += now - t;
    t = now;
    cur = k;
  }
  // every lane of the warp calls it: lane 0 adds the warp's sums
  __device__ void flush() {
    stage(cur);
    for (int k = 0; k < 16; ++k) {
      unsigned long long v = (unsigned long long)acc[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((threadIdx.x & 31) == 0) atomicAdd(pp_stamp_sum + k, v);
    }
  }
};
"""

# The stages, in the order of their indices in the stamped copy.
LABELS = ("copy_through", "syndromes", "erasure_locator", "bm", "degree_chien",
          "omega_forney", "verify_apply", "wait")
# (pattern, replacement) pairs that place the stamps; each pattern must
# match once.  locate_row and finish_row get the kernel's stamps as a last
# argument; the Chien sweep, which every thread of a warp runs, is charged
# to "degree_chien" on every thread; the waits at the block's two barriers
# to "wait".
ANCHORS = [
    (r"(#include <cuda_runtime.h>\n)", r"\1" + _PRELUDE.replace("\\", "\\\\")),
    (r"(const Sym<M>\* S,\n\s+Sym<M>\* el)\) \{\n", r"\1, PPStamps& pp) {\n"),
    (r"(\n  // 2\. Start locator)", r"\n  pp.stage(2);\1"),
    (r"(\n  // 3\. Berlekamp-Massey)", r"\n  pp.stage(3);\1"),
    (r"(\n  // 4\. Degree)", r"\n  pp.stage(4);\1"),
    (r"(Apply apply, int\* corrected)\) \{\n", r"\1, PPStamps& pp) {\n"),
    (r"(\n  // 6\. Omega)", r"\n  pp.stage(5);\1"),
    (r"(\n  // 8\. Verify)", r"\n  pp.stage(6);\1"),
    (r"(  extern __shared__ __align__\(16\) uint8_t s_syn\[\];[^\n]*\n)", r"\1  PPStamps pp;\n"),
    (r"(  __syncthreads\(\);  // tables in, flags cleared\n)",
     r"  pp.stage(7);\n\1  pp.stage(1);\n"),
    (r"(  __syncthreads\(\);  // syndromes in\n)", r"  pp.stage(7);\n\1  pp.stage(2);\n"),
    (r"(row, S, el)\);\n", r"\1, pp);\n"),
    (r"(  chien_sweep\(p, gf, el, deg, hits\);\n)", r"  pp.stage(4);\n\1  pp.stage(0);\n"),
    (r"(  __syncwarp\(\);\n)", r"\1  pp.stage(4);\n"),
    (r"(&corrected)\);\n", r"\1, pp);\n"),
    (r"(    p\.corrected_out\[row\] = corrected;\n  \}\n)(\}\n)", r"\1  pp.flush();\n\2"),
]


def instrument(src: str) -> str:
    """The kernel source with the stamps in place (raises if an anchor does
    not match exactly once)."""
    for pat, rep in ANCHORS:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"breakdown anchor matched {n} times: {pat}")
    return src


def library_copy(src: str, stem: str) -> tuple[ctypes.CDLL, list[str]]:
    """Builds `src`, an edited copy of csrc/rs_decode.cu, alone into
    build/<stem>/ and loads it with the package's argtypes: (the library,
    nvcc's register, spill and entry lines)."""
    out = build.BUILD_DIR / stem
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"rs_decode_{stem}.cu"
    cu.write_text(src)
    so = out / f"librs_decode_{stem}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared",
           "-o", str(so), str(cu)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    lines = [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    lib = ctypes.CDLL(str(so))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib, lines


def instrumented_library() -> ctypes.CDLL:
    """Builds the instrumented copy of csrc/rs_decode.cu alone into
    build/breakdown/ and loads it with the package's argtypes."""
    lib, lines = library_copy(instrument((build.CSRC_DIR / "rs_decode.cu").read_text()),
                              "breakdown")
    log({"breakdown_build": lines})
    lib.pp_rs_stamps.argtypes = [ctypes.c_void_p]
    return lib


def breakdown(timed, common, kern) -> None:
    """The stage split of the decode kernel for the 2-error and the
    Binomial rows (ext mode) and the 32-erasure rows, from the stamped
    copy; kern is the launcher the entries call."""
    ms = {name: time_ms(fn, *args) for name, (fn, _, args) in timed.items()}
    decode_ms = {"k3_ext": ms["k3_ext"], "k3_binomial": ms["k3_binomial"],
                 "k2_erasure_32": ms["k2_erasure_32"] - ms["syndromes"]}
    lib = instrumented_library()
    build.load_library = lambda: lib     # the wrappers now launch the stamped copy
    kern._decode_shapes.clear()          # whose kernels get their own launch shapes
    kern._syndrome_shapes.clear()
    for name in ("k3_ext", "k3_binomial", "k2_erasure_32"):
        fn, _, args = timed[name]
        fn(*args)                        # warm-up
        torch.cuda.synchronize()
        if lib.pp_rs_stamps_clear() != 0:
            raise RuntimeError("pp_rs_stamps_clear failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn(*args)
        end.record()
        end.synchronize()
        if not bool(got[0].all()):
            raise RuntimeError(f"{name}: the stamped kernel did not recover every row")
        sums = (ctypes.c_ulonglong * 16)()
        if lib.pp_rs_stamps(ctypes.addressof(sums)) != 0:
            raise RuntimeError("pp_rs_stamps failed")
        cyc = [int(v) for v in sums][: len(LABELS)]
        total = sum(cyc)
        log({"bench": f"rs_{name}_breakdown", "uninstrumented_ms": ms[name],
             "decode_kernel_ms": decode_ms[name],
             "instrumented_ms": start.elapsed_time(end),
             "cycles_per_codeword": {k: c / BATCH for k, c in zip(LABELS, cyc)},
             "share": {k: c / total for k, c in zip(LABELS, cyc)},
             "ms_split": {k: c / total * decode_ms[name] for k, c in zip(LABELS, cyc)},
             **common})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("entries", nargs="*", metavar="ENTRY",
                    help=f"entries to time, of {list(ENTRIES)}; all by default")
    ap.add_argument("--breakdown", action="store_true",
                    help="split the decode kernel's time by stage with clock64() stamps "
                         "(k3_ext, k3_binomial and k2_erasure_32; ENTRY names are not read)")
    opts = ap.parse_args(argv)
    names = opts.entries or list(ENTRIES)
    unknown = set(names) - set(ENTRIES)
    if unknown:
        raise SystemExit(f"unknown entries {sorted(unknown)}; known: {list(ENTRIES)}")
    if opts.breakdown:
        names = ["k2_erasure_32", "k3_ext", "k3_binomial", "syndromes"]
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
    binomial = binomial_errors(rng, data, parity.cpu().numpy())
    want = torch.as_tensor(data, device=dev)

    timed = calls(codec, bad, parity, eras, epos, binomial, names)
    for name, (fn, plain_fn, args) in timed.items():
        got = fn(*args)
        if name == "syndromes":
            good = torch.equal(got, plain_fn(*args))
        else:
            ok, out = (got.ok, got.data) if name == "facade" else got[:2]
            good = bool(ok.all()) and torch.equal(out, want)
        if not good:
            raise RuntimeError(f"{name}: wrong result")
        if opts.breakdown:
            continue
        t, _ = time_in_turns(fn, None, args)
        ms = sum(t) / len(t)
        log({"bench": f"rs_{name}", "ms": ms, "runs_ms": t,
             "codewords_per_s": BATCH / ms * 1e3, **common})
    if opts.breakdown:
        breakdown(timed, common, codec._rs.kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
