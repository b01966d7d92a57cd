"""Wrapper of the hand-written CUDA RS decode kernel (csrc/rs_decode.cu).

Counterpart of libpoporon_tpu/models/rs_pallas.py: one kernel serves the
plain, erasure and external-syndrome decode paths.  For a CUDA tensor the
wrapper launches the kernel (and raises if the launch fails); for a CPU
tensor it runs the kernel's plain PyTorch version (models/rs.py).  The
kernel takes any batch size, masking the ragged last block itself, so no
host-side padding is needed.
"""

from __future__ import annotations

import torch

from ..utils import build
from ..utils.tensors import checked

MODE_PLAIN, MODE_ERASURE, MODE_EXT = 0, 1, 2
MAX_ROOTS = 64       # the kernel's per-thread arrays


class RSCudaDecoder:
    """rs_decode (plain / erasure / external-syndrome) as one CUDA kernel.

    `launches` counts kernel launches, so that a run can show that its
    decodes went through the kernel.
    """

    @staticmethod
    def supports(rs) -> bool:
        """Config gate, as rs_pallas.py's: m = 8, nr <= 64 and
        (fcr + nr) * prim < 2^15."""
        return (
            rs.m == 8
            and rs.num_roots <= MAX_ROOTS
            and (rs.fcr + rs.num_roots) * rs.prim < (1 << 15)
        )

    def __init__(self, rs):
        """rs: models.rs.RSCodec (supplies the tables and the plain path)."""
        if not self.supports(rs):
            raise ValueError("RS config outside the kernel's gate")
        self.rs = rs
        self.launches = 0
        # [4, 256] int32 on the codec's device: log, antilog, sec, inv
        self.tables = torch.stack(
            [rs.exp2log, rs.log2exp, rs.sec_tbl, rs.inv_tbl]).contiguous()

    def supports_erasure(self, E: int) -> bool:
        """Erasure lists 1..num_roots wide ride the kernel."""
        return 0 < E <= self.rs.num_roots

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

    def _launch(self, mode, data, parity, eras_pos=None, eras_count=None,
                s_log=None):
        rs = self.rs
        dev = data.device
        if dev.type != "cuda":
            raise ValueError(f"the RS kernel takes CUDA tensors, got {dev}")
        B, size = data.shape
        nr = rs.num_roots
        if not 0 < size <= rs.k:
            raise ValueError(f"size {size} outside 1..{rs.k}")
        data = checked(data, torch.uint8, (B, size), dev)
        parity = checked(parity, torch.uint8, (B, nr), dev)
        eras_width = 0
        if mode == MODE_ERASURE:
            eras_width = eras_pos.shape[1]
            if not self.supports_erasure(eras_width):
                raise ValueError(f"erasure width {eras_width} outside 1..{nr}")
            eras_pos = checked(eras_pos, torch.int32, (B, eras_width), dev)
            eras_count = checked(eras_count, torch.int32, (B,), dev)
        if mode == MODE_EXT:
            s_log = checked(s_log, torch.int32, (B, nr), dev)
        tables = self.tables.to(dev)

        data_out = torch.empty_like(data)
        parity_out = torch.empty_like(parity)
        ok = torch.empty(B, dtype=torch.bool, device=dev)
        corrected = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return ok, data_out, parity_out, corrected

        def ptr(t):
            return None if t is None else t.data_ptr()

        lib = build.load_library()
        rc = lib.pp_rs_decode(
            mode, ptr(data), ptr(parity), ptr(eras_pos), ptr(eras_count),
            eras_width, ptr(s_log), ptr(tables), ptr(data_out),
            ptr(parity_out), ptr(ok), ptr(corrected),
            B, size, nr, rs.fcr, rs.prim, rs.prim_inv, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rs_decode kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return ok, data_out, parity_out, corrected

