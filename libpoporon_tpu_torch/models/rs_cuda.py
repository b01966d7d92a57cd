"""Wrapper of the hand-written CUDA RS kernels (csrc/rs_decode.cu).

Counterpart of libpoporon_tpu/models/rs_pallas.py.  Two kernels serve the
plain, erasure and external-syndrome decode paths: a syndrome kernel
(bit-sliced, from the column table `syndrome_columns`) and a decode
kernel that starts from log-form syndromes.  For a CUDA tensor the
wrapper launches the kernels (and raises if a launch fails); for a CPU
tensor it runs their plain PyTorch version (models/rs.py).  The kernels
take any batch size, masking the ragged last block themselves, so no
host-side padding is needed.
"""

from __future__ import annotations

import torch

from ..utils import build
from ..utils.profiling import span
from ..utils.tensors import checked

MODE_PLAIN, MODE_ERASURE, MODE_EXT = 0, 1, 2
MAX_ROOTS = 64       # the kernel's per-thread arrays


def column_words(nr: int) -> int:
    """32-bit words a bit row of the column table: the syndrome kernel's
    buckets, 4, 8 or 16 for nr <= 16, 32 or 64."""
    if not 0 < nr <= MAX_ROOTS:
        raise ValueError(f"nr {nr} outside 1..{MAX_ROOTS}")
    return 4 if nr <= 16 else 8 if nr <= 32 else 16


def syndrome_columns(G_syn: torch.Tensor, nr: int) -> torch.Tensor:
    """The syndrome kernel's column table, int32 [fs, 8, W] on G_syn's
    device, W = column_words(nr).

    Entry [q, b] is row q*8 + b of G_syn [fs*8, nr*8] (the syndrome bits
    contributed by bit b, MSB first, of full-length position q), packed so
    that the W words, read as little-endian bytes, hold S_0 .. S_{nr-1}:
    G_syn[q*8 + b, 8*i + c] (bit c of S_i, MSB first) is bit
    8*(i % 4) + 7 - c of word i // 4.  Words past nr's bytes are zero.
    """
    W = column_words(nr)
    fs = G_syn.shape[0] // 8
    g = G_syn.to(torch.int64).reshape(fs, 8, nr, 8)             # [q, b, i, c]
    g = torch.nn.functional.pad(g, (0, 0, 0, 4 * W - nr))        # i up to 4W
    g = g.reshape(fs, 8, W, 4, 8)                                # i = 4w + k
    k = torch.arange(4, device=g.device)[:, None]
    c = torch.arange(8, device=g.device)[None, :]
    words = (g << (8 * k + 7 - c)).sum(dim=(-2, -1))            # [fs, 8, W]
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


class RSCudaDecoder:
    """rs_decode (plain / erasure / external-syndrome) as CUDA kernels.

    A plain or erasure decode is two launches (syndromes, then decode), an
    external-syndrome decode one.  `launches` counts every kernel launch,
    `syndrome_launches` those of the syndrome kernel, so that a run can
    show that its decodes went through the kernels.
    """

    @staticmethod
    def supports(rs) -> bool:
        """Config gate, as rs_pallas.py's: m = 8, nr <= 64 and
        (fcr + nr) * prim < 2^15; and, past it, a primitive polynomial.
        The kernel's Chien steps logs (log el_j + j) and so needs a log
        table that names every nonzero element once; a polynomial whose
        powers of x miss elements (0x11B) runs the plain version, which
        the kernel disagreed with there (ROADMAP.md Queue 3, F8)."""
        return (
            rs.m == 8
            and rs.num_roots <= MAX_ROOTS
            and (rs.fcr + rs.num_roots) * rs.prim < (1 << 15)
            and rs.gf.primitive
        )

    def __init__(self, rs):
        """rs: models.rs.RSCodec (supplies the tables and the plain path)."""
        if not self.supports(rs):
            raise ValueError("RS config outside the kernel's gate")
        self.rs = rs
        self.launches = 0
        self.syndrome_launches = 0
        # [4, 256] int32 on the codec's device: log, antilog, sec, inv
        self.tables = torch.stack(
            [rs.exp2log, rs.log2exp, rs.sec_tbl, rs.inv_tbl]).contiguous()
        # [fs, 8, W] int32 on the codec's device
        self.columns = syndrome_columns(rs.G_syn, rs.num_roots)

    def supports_erasure(self, E: int) -> bool:
        """Erasure lists 1..num_roots wide ride the kernel."""
        return 0 < E <= self.rs.num_roots

    def syndromes(self, data, parity):
        """Log-form syndromes int32 [B, nr] (fs where S_i = 0) of the rows
        data [B, size] | parity [B, nr]."""
        if data.device.type == "cpu":
            rs = self.rs
            return rs.exp2log[rs._syndrome(data, parity).long()]
        return self._syndromes(*self._rows(data, parity))

    def decode_plain(self, data, parity):
        if data.device.type == "cpu":
            return self.rs._decode_plain(data, parity)
        return self._launch(MODE_PLAIN, data, parity)

    def decode_erasure(self, data, parity, eras_pos, eras_count):
        if data.device.type == "cpu":
            return self.rs._decode_erasure(data, parity, eras_pos, eras_count)
        return self._launch(MODE_ERASURE, data, parity,
                            eras_pos=eras_pos, eras_count=eras_count)

    def decode_ext(self, data, parity, s_log):
        if data.device.type == "cpu":
            return self.rs._decode_ext_syndrome(data, parity, s_log)
        return self._launch(MODE_EXT, data, parity, s_log=s_log)

    def _rows(self, data, parity):
        """data and parity checked for the kernels: CUDA tensors on the
        codec's device, uint8, contiguous."""
        dev = data.device
        if dev.type != "cuda":
            raise ValueError(f"the RS kernels take CUDA tensors, got {dev}")
        if dev != self.tables.device:
            raise ValueError(f"rows on {dev}, the codec's tables on {self.tables.device}")
        B, size = data.shape
        if not 0 < size <= self.rs.k:
            raise ValueError(f"size {size} outside 1..{self.rs.k}")
        return (checked(data, torch.uint8, (B, size), dev),
                checked(parity, torch.uint8, (B, self.rs.num_roots), dev))

    @staticmethod
    def _stream(dev):
        return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream

    def _syndromes(self, data, parity):
        with span("poporon.launch.rs_syndrome"):
            rs = self.rs
            B, size = data.shape
            s_log = torch.empty(B, rs.num_roots, dtype=torch.int32, device=data.device)
            if B == 0:
                return s_log
            with torch.cuda.device(data.device):   # the launcher sets the device
                rc = build.load_library().pp_rs_syndrome(
                    data.data_ptr(), parity.data_ptr(), self.columns.data_ptr(),
                    self.tables.data_ptr(), s_log.data_ptr(), B, size, rs.num_roots,
                    self.columns.shape[2], *self._stream(data.device))
        if rc != 0:
            raise RuntimeError(f"rs_syndrome kernel launch failed: CUDA error {rc}")
        self.launches += 1
        self.syndrome_launches += 1
        return s_log

    def _launch(self, mode, data, parity, eras_pos=None, eras_count=None,
                s_log=None):
        """The decode of CUDA tensors: in plain and erasure mode the
        syndrome kernel, then the decode kernel from the syndromes."""
        with span("poporon.launch.rs_decode"):
            rs = self.rs
            data, parity = self._rows(data, parity)
            dev = data.device
            B, size = data.shape
            nr = rs.num_roots
            eras_width = 0
            if mode == MODE_ERASURE:
                eras_width = eras_pos.shape[1]
                if not self.supports_erasure(eras_width):
                    raise ValueError(f"erasure width {eras_width} outside 1..{nr}")
                eras_pos = checked(eras_pos, torch.int32, (B, eras_width), dev)
                eras_count = checked(eras_count, torch.int32, (B,), dev)
            if mode == MODE_EXT:
                s_log = checked(s_log, torch.int32, (B, nr), dev)
            else:
                s_log = self._syndromes(data, parity)

            data_out = torch.empty_like(data)
            parity_out = torch.empty_like(parity)
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            corrected = torch.empty(B, dtype=torch.int32, device=dev)
            if B == 0:
                return ok, data_out, parity_out, corrected

            def ptr(t):
                return None if t is None else t.data_ptr()

            with torch.cuda.device(dev):
                rc = build.load_library().pp_rs_decode(
                    int(mode == MODE_ERASURE), ptr(data), ptr(parity), ptr(eras_pos),
                    ptr(eras_count), eras_width, ptr(s_log), ptr(self.tables), ptr(data_out),
                    ptr(parity_out), ptr(ok), ptr(corrected),
                    B, size, nr, rs.fcr, rs.prim, rs.prim_inv, *self._stream(dev))
            if rc != 0:
                raise RuntimeError(f"rs_decode kernel launch failed: CUDA error {rc}")
            self.launches += 1
            return ok, data_out, parity_out, corrected
