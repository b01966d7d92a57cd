"""Build and load the package's CUDA kernels at first use.

Every `csrc/*.cu` file is compiled with nvcc for Hopper (`sm_90a`), one
nvcc process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
ctypes.  The library's name carries a hash of the sources and flags, so
an edited source builds anew and an unchanged one is loaded from
`build/`.  A failed build raises with nvcc's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point; each returns a cudaError_t
SIGNATURES = {
    # data, parity, columns, tables, s_log_out, batch, size, nr, words,
    # device, stream
    "pp_rs_syndrome": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # erasure, data, parity, eras_pos, eras_cnt, eras_width, s_log, tables,
    # data_out, parity_out, ok_out, corrected_out,
    # batch, size, nr, fcr, prim, prim_inv, device, stream
    "pp_rs_decode": [_I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P],
    # mode, in, chan, graph, out, ok_out, iters_out, counter, batch, V, P,
    # E, runs, dv, has_src, max_iter, shared_graph, groups, threads, grid,
    # device, stream
    "pp_ldpc_bp": [_I, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # mode, V, P, E, runs, dv, has_src, shared_graph, groups, threads,
    # device (returns blocks per SM, or a negative cudaError_t)
    "pp_ldpc_bp_blocks_per_sm": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    # mode, idx, src, out, checksum, landed, nsrc, rows, sub, repeat, depth,
    # device, stream
    "pp_probe_dma": [_I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpoporon_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet.

    Writes nvcc's output (ptxas register and spill counts included) to a
    `.log` file beside the library.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cus = sorted(CSRC_DIR.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{cu.stem}.o") for cu in cus]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)] for cu, o in zip(cus, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(compiles, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        p = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append((link, p.stdout, p.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(out for _, out, _ in steps))
    for cmd, out, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, so)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
