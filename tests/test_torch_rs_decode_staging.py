"""The RS decode kernel's staging, emulated on the CPU.

In `rs_decode_kernel` (libpoporon_tpu_torch/csrc/rs_decode.cu) each warp
copies its 32 rows straight through to the outputs (`copy_through`: bytes
one at a time up to the output's first 16-byte boundary and after its
last, and 16 bytes a store between, each built by a funnel shift from the
two 16-byte words of the input that hold it), and the block turns its
tile's log-form syndromes into bytes in shared memory
(`stage_syndromes`: 16-byte loads, element e of the tile at row e / nr,
found by a multiply and a shift, each row `syndrome_stride(nr)` bytes
apart).  Nothing of it runs here, so these
tests follow the kernel's index arithmetic step for step in NumPy, over
every alignment of input and output, and hold the results to a plain copy
and to step 1's rules.  The card holds the kernel itself to the plain
version (chip_smoke.py phase 3).
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from libpoporon_tpu_torch.utils import build

THREADS = 128       # kThreads: rows a block
FS = 255


def syndrome_stride(nr: int) -> int:
    """rs_decode.cu `syndrome_stride`: the least odd count of words that
    holds nr bytes, in bytes."""
    return 4 * (((nr + 3) // 4) | 1)


def test_stride_is_the_kernels():
    """The emulation's stride is the kernel's expression."""
    src = (build.CSRC_DIR / "rs_decode.cu").read_text()
    m = re.search(r"__host__ __device__ constexpr int syndrome_stride\(int nr\) "
                  r"\{ return ([^;]+); \}", src)
    assert m, "syndrome_stride not found in rs_decode.cu"
    assert m.group(1) == "4 * (((nr + 3) / 4) | 1)"
    assert ("__host__ __device__ constexpr int decode_smem(int nr) "
            "{ return kThreads * syndrome_stride(nr); }") in src


@pytest.mark.parametrize("nr", [1, 2, 3, 4, 5, 8, 10, 16, 31, 32, 33, 63, 64])
def test_a_warps_rows_fall_in_distinct_banks(nr):
    """Byte i of 32 consecutive rows lies in 32 different 4-byte banks,
    whatever i, and a row holds its nr bytes."""
    stride = syndrome_stride(nr)
    assert stride % 4 == 0 and stride >= nr and (stride // 4) % 2 == 1
    for first in (0, 32, 96):
        for i in range(nr):
            banks = {((r * stride + i) // 4) % 32 for r in range(first, first + 32)}
            assert len(banks) == 32, f"nr {nr}, byte {i}"
    assert THREADS * stride <= THREADS * 68     # at most 8,704 bytes a block (nr = 64)


def test_row_of_element_is_exact():
    """stage_syndromes finds element e's row as (e m) >> 32, m = 2^32 / nr
    + 1, in 64 bits: exact for every e < 2^16 and nr <= 64."""
    e = np.arange(1 << 16, dtype=np.uint64)
    for nr in range(1, 65):
        m = np.uint64((1 << 32) // nr + 1)
        assert np.array_equal((e * m) >> np.uint64(32), e // np.uint64(nr)), f"nr {nr}"


def emulate_copy_through(mem: np.ndarray, src: int, dst: int, total: int) -> tuple[int, int]:
    """copy_through(src, dst, total) on the flat byte memory `mem`, as the
    kernel's threads do it together; returns the least and the last + 1
    address of every load it made."""
    head = min((16 - (dst & 15)) & 15, total)
    vecs = (total - head) >> 4
    tail = head + (vecs << 4)
    lo_read, hi_read = src, src + total
    mem[dst:dst + head] = mem[src:src + head]
    mem[dst + tail:dst + total] = mem[src + tail:src + total]
    at = src + head
    shift = at & 15
    base = at - shift
    if vecs == 0:
        return lo_read, hi_read
    if shift == 0:
        mem[dst + head:dst + tail] = mem[base:base + 16 * vecs]
        return min(lo_read, base), max(hi_read, base + 16 * vecs)
    words = mem[base:base + 16 * (vecs + 1)].copy().view("<u4").reshape(vecs + 1, 4)
    pair = np.concatenate([words[:-1], words[1:]], axis=1).astype(np.uint64)  # vs[k], vs[k + 1]
    q, sh = shift >> 2, np.uint64(8 * (shift & 3))
    out = np.empty((vecs, 4), dtype="<u4")
    for j in range(4):
        lo, hi = pair[:, q + j], pair[:, q + j + 1]
        out[:, j] = (((hi << np.uint64(32)) | lo) >> sh) & np.uint64(0xFFFFFFFF)
    mem[dst + head:dst + tail] = out.reshape(-1).view(np.uint8)
    return min(lo_read, base), max(hi_read, base + 16 * (vecs + 1))


@pytest.mark.parametrize("total", [1, 15, 16, 17, 100, 32 * 127, 223 * 128, 255 * 128])
def test_copy_through_is_a_copy_at_every_alignment(total):
    """The output is the input, byte for byte and nothing past it, for
    every offset of input and output within 16 bytes; every load lies in
    the 16-byte words that hold the input."""
    rng = np.random.default_rng(total)
    size = 2 * total + 128
    for s_off in range(16):
        for d_off in range(16):
            mem = rng.integers(0, 256, size, dtype=np.uint8)
            src, dst = 16 + s_off, ((total + 63) // 16) * 16 + 32 + d_off
            before = mem.copy()
            lo, hi = emulate_copy_through(mem, src, dst, total)
            assert np.array_equal(mem[dst:dst + total], before[src:src + total]), (s_off, d_off)
            assert np.array_equal(mem[:dst], before[:dst]), (s_off, d_off)
            assert np.array_equal(mem[dst + total:], before[dst + total:]), (s_off, d_off)
            assert lo >= src & ~15 and hi <= (src + total + 15) & ~15, (s_off, d_off)


def emulate_stage_syndromes(mem: np.ndarray, src: int, nr: int, rows: int, antilog):
    """stage_syndromes on the flat int32 memory `mem` from element index
    src: (the shared bytes, THREADS rows of syndrome_stride(nr), 0xEE
    where nothing was written; the err flags)."""
    stride = syndrome_stride(nr)
    syn = np.full(THREADS * stride, 0xEE, dtype=np.uint8)
    err = np.zeros(THREADS, dtype=np.uint8)
    total = rows * nr
    m = (1 << 32) // nr + 1

    def put(e, v):
        r = (e * m) >> 32
        syn[r * stride + e - r * nr] = antilog[v] if 0 <= v <= FS else 0
        if v != FS:
            err[r] = 1

    head = min(((16 - ((4 * src) & 15)) & 15) >> 2, total)
    vecs = (total - head) >> 2
    tail = head + (vecs << 2)
    assert (src + head) % 4 == 0 or vecs == 0     # the 16-byte loads are aligned
    order = list(range(head)) + list(range(tail, total)) + list(range(head, tail))
    for e in order:
        put(e, int(mem[src + e]))
    return syn, err


@pytest.mark.parametrize("nr", [1, 3, 16, 32, 33, 64])
def test_syndromes_land_in_their_rows(nr):
    """Each row's bytes are step 1's S_i (antilog of a log in [0, fs], 0
    outside it, so fs and logs out of range read as zero) at its stride,
    the padding untouched, and err set exactly for the rows with any log
    other than fs (the `s_log[3, 0] = 300` case counts as an error),
    whatever the input's alignment and for short tiles."""
    rng = np.random.default_rng(nr)
    antilog = np.concatenate([rng.permutation(np.arange(1, 256)), [0]]).astype(np.uint8)
    stride = syndrome_stride(nr)
    for rows in (1, 5, 127, 128):
        for off in range(4):
            logs = rng.integers(0, FS, (rows, nr))
            logs[::3] = FS                              # clean rows
            logs[1::7, 0] = 300                         # out of range, else clean
            logs[1::7, 1:] = FS
            logs[2::11, -1] = -1
            mem = np.full(rows * nr + 8, -7, dtype=np.int64)
            mem[off:off + rows * nr] = logs.reshape(-1)
            syn, err = emulate_stage_syndromes(mem, off, nr, rows, antilog)
            want = np.where((logs >= 0) & (logs <= FS), antilog[np.clip(logs, 0, FS)], 0)
            got = syn.reshape(THREADS, stride)
            assert np.array_equal(got[:rows, :nr], want), (rows, off)
            assert (got[:rows, nr:] == 0xEE).all() and (got[rows:] == 0xEE).all(), (rows, off)
            assert np.array_equal(err[:rows], (logs != FS).any(axis=1)), (rows, off)
            assert not err[rows:].any(), (rows, off)
