"""Build, load and launch the package's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc for Hopper (`sm_90a`), one
nvcc process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
ctypes at first use.  The library's name carries a hash of the sources
and flags, so an edited source builds anew and an unchanged one is
loaded from `build/`.  A failed build raises with nvcc's output; there
is no fallback.

Every launch of the library goes through `launch`, every occupancy query
through `occupancy`: they enter the card, pass it and its current stream
(`stream`), and raise on an error the entry returns.  The kernel
launchers (models/rs_cuda.py, models/ldpc_cuda.py, models/bch_cuda.py,
benchmarks/probe_dma.py) take CUDA tensors only.  A codec on the card
whose config is inside its kernel's gate builds a launcher; every other
codec, and every codec on the CPU, runs its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point; each returns a cudaError_t
SIGNATURES = {
    # m (the field's bits: 8 or 10), data, parity, tables, log_tables,
    # s_log_out, batch, size, nr, copies, grid, smem, device, stream
    "pp_rs_syndrome": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # m, nr, device, copies out, smem out (returns blocks per SM, or a
    # negative cudaError_t)
    "pp_rs_syndrome_shape": [_I, _I, _I, _P, _P],
    # m, erasure, data, parity, eras_pos, eras_cnt, eras_width, s_log,
    # tables, data_out, parity_out, ok_out, corrected_out,
    # batch, size, nr, fcr, prim, prim_inv, device, stream
    "pp_rs_decode": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P],
    # m, erasure, nr, device, smem out, carveout out (returns blocks per
    # SM, or a negative cudaError_t)
    "pp_rs_decode_shape": [_I, _I, _I, _I, _P, _P],
    # cells, lost, surv, nibbles, tables, rebuilt, ok_out, corrected_out,
    # failed_out, work, grid, smem, L, n, e, nr, fcr, prim, prim_inv, fast,
    # tmask, vec, device, stream
    "pp_rs_stripe": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong,
                     _I, _I, _I, _I, _I, _I, _I, ctypes.c_uint, _I, _I, _P],
    # n_surv, fast, vec, device, smem out (returns blocks per SM, 0 past
    # the device's shared memory, or a negative cudaError_t)
    "pp_rs_stripe_blocks_per_sm": [_I, _I, _I, _I, _P],
    # mode, in, chan, graph, out, ok_out, iters_out, counter, batch, V, P,
    # E, runs, dv, has_src, max_iter, shared_graph, groups, threads, grid,
    # device, stream
    "pp_ldpc_bp": [_I, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # mode, V, P, E, runs, dv, has_src, shared_graph, groups, threads,
    # device (returns blocks per SM, or a negative cudaError_t)
    "pp_ldpc_bp_blocks_per_sm": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    # data, parity, tables, data_out, ok_out, corrected_out, batch, data
    # bytes, parity bytes, parity bits, t, m, vec, threads, grid, smem,
    # device, stream
    "pp_bch_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # m, t, parity bits, threads, device, smem out (returns blocks per SM,
    # 0 past the device's shared memory, or a negative cudaError_t)
    "pp_bch_decode_shape": [_I, _I, _I, _I, _I, _P],
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


def stream(device: torch.device) -> tuple[int, int]:
    """(card index, handle of the card's current stream): the last two
    arguments of every launch entry."""
    return device.index or 0, torch.cuda.current_stream(device).cuda_stream


def launch(entry: str, device: torch.device, *args) -> None:
    """Launch `entry` on `device`'s current stream with `args` (as
    SIGNATURES lists them, without the card and the stream; a tensor
    passes its address, found by exact type, which costs less than
    `isinstance` on every launch).  Raises RuntimeError naming the entry
    and the CUDA error it returns."""
    args = [a.data_ptr() if type(a) is torch.Tensor else a for a in args]
    with torch.cuda.device(device):
        rc = getattr(load_library(), entry)(*args, *stream(device))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def occupancy(entry: str, device: torch.device, *args) -> int:
    """Blocks one SM of `device` holds at once, as the occupancy entry
    `entry` reports it for `args` (as SIGNATURES lists them).  Raises
    RuntimeError on a negative result, the CUDA error."""
    with torch.cuda.device(device):
        n = getattr(load_library(), entry)(*args)
    if n < 0:
        raise RuntimeError(f"{entry} failed: CUDA error {-n}")
    return n


@functools.cache
def sm_count(card: int) -> int:
    """The SMs of card `card`."""
    return torch.cuda.get_device_properties(card).multi_processor_count
