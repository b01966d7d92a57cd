"""Launcher of the hand-written CUDA BCH decode kernel (csrc/bch_decode.cu).

No TPU kernel decodes BCH: the JAX package runs it through XLA, as the
port's plain version (models/bch.py) runs it through bit matrices.  The
kernel decodes shortened binary BCH codes of whole data bytes, such as
NAND flash's BCH-8 on 512-byte sectors, from the stored bytes: data
uint8 [B, data_bytes] and parity uint8 [B, parity_bytes] in, the
corrected data, ok and the count of corrected bits out, in one launch,
with no bit tensor.  Its steps (the file's header has them in full):
the division of each row by g(x) a byte a step, the syndromes at the t
odd roots of the remainder, Berlekamp-Massey, a thread a row; the
locator's roots at the word's own positions, solved by the thread for a
degree of 1, 2 or 3 and by a warp's Chien sweep past it; the verify; the
data copied through with the found bits flipped.

`bch_tables` makes the kernel's host data, for the launcher and the
tests alike.  `BCHCudaDecoder` launches the kernel on CUDA tensors
through utils/build.py `launch` and raises if a launch fails; it knows
nothing of the codec.  models/bch.py `BCHCodec` builds one for a codec
on a card inside the gate (`BCHCudaDecoder.supports`); every other codec
runs the plain PyTorch version there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from ..utils.profiling import span
from ..utils.tensors import checked

MAX_M = 14           # the log and antilog tables in shared memory: 2^m entries each
MAX_T = 16
THREADS = 256        # rows a block takes at a time, a thread each
NO_ROOT = 0xFFFF     # the root tables' entry where y^2 + y = c, y^3 + y = c have no roots


def kernel_lanes(t: int) -> int:
    """The kernel form's locator lanes for t: 4, 8 or 16."""
    return 4 if t <= 4 else 8 if t <= 8 else 16


def kernel_words(t: int) -> int:
    """32-bit words of the kernel form's remainder for t: 32 words >= 14
    lanes, so any g(x) of degree m t <= 14 t fits."""
    return {4: 2, 8: 4, 16: 8}[kernel_lanes(t)]


def _pad16(b: bytes) -> bytes:
    return b + bytes(-len(b) % 16)


def bch_tables(log2exp, exp2log, gen: int, t: int) -> np.ndarray:
    """The kernel's table image, uint8 [k * 16], from the field's antilog
    and log tables ([2^m] each, log of zero fs = 2^m - 1, antilog of fs
    zero) and the generator g(x) (bit j the coefficient of x^j, degree
    pb).  With W = kernel_words(t) and sh = 32 W - pb, each section
    padded to 16 bytes:

    - the division table, uint32 [256, W]: entry u is (u(x) x^pb mod g)
      << sh, word 0 the lowest: the kernel's remainder is held shifted up
      by sh bits, so that its top byte is the top of word W - 1;
    - the nibble tables, uint16 [t, nq, 16], q0 = sh // 4, nq = 8 W - q0:
      entry (i, q - q0, v) is the XOR over the set bits b of v of
      alpha^((2 i + 1) d), d = 4 q + b - sh the degree of bit b of nibble
      q of the shifted remainder (none where d < 0): the XOR over the
      remainder's nibbles is its value at alpha^(2i+1);
    - the log table and the antilog table, uint16 [2^m] each;
    - the quadratic's table, uint16 [2^m]: entry c a y with y^2 + y = c
      (the other is y ^ 1), NO_ROOT where there is none;
    - the cubic's table, uint16 [2^m, 4]: entry c the three distinct y
      with y^3 + y = c, then 0; NO_ROOT first where there are not three.
    The kernel keeps the last two in device memory, the rest in shared
    memory."""
    alog = np.asarray(log2exp, dtype=np.int64)
    log = np.asarray(exp2log, dtype=np.int64)
    fs = len(alog) - 1
    pb = gen.bit_length() - 1
    W = kernel_words(t)
    sh = 32 * W - pb
    if not 8 <= pb <= 32 * W:
        raise ValueError(f"g(x) of degree {pb} outside 8..{32 * W} for t = {t}")
    rem = []
    r = gen ^ (1 << pb)                              # x^pb mod g
    for _ in range(8):
        rem.append(r)
        r <<= 1
        if r >> pb & 1:
            r ^= gen
    div = np.zeros((256, W), dtype=np.uint32)
    for u in range(256):
        v = 0
        for b in range(8):
            if u >> b & 1:
                v ^= rem[b]
        v <<= sh
        for k in range(W):
            div[u, k] = (v >> (32 * k)) & 0xFFFFFFFF
    q0 = sh // 4
    q = np.arange(q0, 8 * W)[:, None, None]                       # [nq, 1, 1]
    v = np.arange(16)[None, :, None]                              # [1, 16, 1]
    b = np.arange(4)[None, None, :]                               # [1, 1, 4]
    d = 4 * q + b - sh
    live = ((v >> b) & 1).astype(bool) & (d >= 0)                 # [nq, 16, 4]
    nib = np.zeros((t, 8 * W - q0, 16), dtype=np.int64)
    for i in range(t):
        terms = np.where(live, alog[((2 * i + 1) * np.maximum(d, 0)) % fs], 0)
        nib[i] = np.bitwise_xor.reduce(terms, axis=2)
    y = np.arange(fs + 1)
    square = np.where(y == 0, 0, alog[(2 * log[y]) % fs])
    quad = np.full(fs + 1, NO_ROOT, dtype=np.uint16)
    quad[square ^ y] = y                              # y and y ^ 1 give the same c
    cube = np.where(y == 0, 0, alog[(3 * log[y]) % fs]) ^ y
    order = np.argsort(cube, kind="stable")
    values, first, count = np.unique(cube[order], return_index=True, return_counts=True)
    cubic = np.zeros((fs + 1, 4), dtype=np.uint16)
    cubic[:, 0] = NO_ROOT
    three = count == 3
    cubic[values[three], :3] = order[first[three][:, None] + np.arange(3)]
    image = b"".join(_pad16(x.tobytes()) for x in (
        div, nib.astype(np.uint16), log.astype(np.uint16), alog.astype(np.uint16), quad, cubic))
    return np.frombuffer(image, dtype=np.uint8).copy()


class BCHCudaDecoder:
    """BCH decode as one CUDA kernel launch: `launches` counts them, so
    that a run can show that its decodes went through the kernel.  Every
    entry takes CUDA tensors on the launcher's card, and raises
    ValueError for any other."""

    @staticmethod
    def supports(bch) -> bool:
        """Config gate: m <= 14 (the tables in shared memory), t <= 16, a
        g(x) of degree 8 or more (a byte a division step) and a whole
        number of data bytes (`data_length` a multiple of 8), which
        covers Linux's software BCH (strengths 4, 8 and 16 on 512-byte
        steps at m = 13, 1 KiB steps at m = 14)."""
        return (bch.m <= MAX_M and 1 <= bch.t <= MAX_T and bch.parity_bits >= 8
                and bch.data_length % 8 == 0 and bch.data_length > 0)

    def __init__(self, tables: np.ndarray, m: int, t: int, parity_bits: int, data_bytes: int,
                 device):
        """tables: the code's `bch_tables`; m, t, the parity bits and data
        bytes as models/bch.py BCHCodec has them; device: the card the
        kernel runs on."""
        self.m, self.t, self.pb, self.nb = m, t, parity_bits, data_bytes
        self.pbytes = (parity_bits + 7) // 8
        self.launches = 0
        self.tables = torch.from_numpy(np.asarray(tables, dtype=np.uint8)).to(device)
        self._shapes = {}                     # card -> (blocks an SM holds, shared bytes)

    def _card(self, t: torch.Tensor) -> torch.device:
        """t's device, which must be the launcher's card."""
        dev = t.device
        if dev.type != "cuda" or dev != self.tables.device:
            raise ValueError(f"the BCH kernel takes CUDA tensors on {self.tables.device}, "
                             f"got {dev}")
        return dev

    def shape(self, dev) -> tuple[int, int]:
        """The launch on `dev`: (blocks an SM holds, dynamic shared bytes
        a block), from the library, once a card."""
        card = dev.index or 0
        if card not in self._shapes:
            smem = ctypes.c_int(0)
            per_sm = build.occupancy("pp_bch_decode_shape", dev, self.m, self.t, self.pb,
                                     THREADS, card, ctypes.addressof(smem))
            if per_sm == 0:
                raise RuntimeError(f"bch_decode kernel: no block fits an SM at "
                                   f"{smem.value} B of shared memory")
            self._shapes[card] = (per_sm, smem.value)
        return self._shapes[card]

    def decode(self, data, parity):
        """data uint8 [B, data_bytes], parity uint8 [B, parity_bytes] ->
        (ok bool [B], data uint8 [B, data_bytes], corrected int32 [B]) as
        models/bch.py `BCHCodec.decode_bytes` gives them."""
        with span("poporon.launch.bch_decode"):
            dev = self._card(data)
            B = data.shape[0]
            data = checked(data, torch.uint8, (B, self.nb), dev)
            parity = checked(parity, torch.uint8, (B, self.pbytes), dev)
            out = torch.empty_like(data)
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            corrected = torch.empty(B, dtype=torch.int32, device=dev)
            if B == 0:
                return ok, out, corrected
            per_sm, smem = self.shape(dev)
            grid = min(build.sm_count(dev.index or 0) * per_sm, -(-B // THREADS))
            vec = self.nb % 16 == 0 and data.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            build.launch("pp_bch_decode", dev, data, parity, self.tables, out, ok, corrected, B,
                         self.nb, self.pbytes, self.pb, self.t, self.m, int(vec), THREADS, grid,
                         smem)
            self.launches += 1
            return ok, out, corrected
