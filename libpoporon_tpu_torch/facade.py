"""Unified codec facade (counterpart of libpoporon_tpu/facade.py, RS and
LDPC parts).

One `Codec` object per config, operating on batches of codewords
([B, ...] uint8; a 1-D input is a batch of one) on one explicit torch
device.  Inputs (NumPy arrays or tensors) are moved to that device;
outputs are tensors on it.  Nothing chooses the device for the caller and
nothing moves work to another device.

As in the JAX package, LDPC `encode` returns the interleaved data where
the config interleaves, and LDPC `decode` reports the iterations used in
`corrected` (reference quirk, decode.c:535-537).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import BchConfig, FecType, LdpcConfig, RSConfig
from .erasure import Erasure
from .models.ldpc import LDPCCodec
from .models.rs import RSCodec
from .utils.tensors import as_tensor


@dataclasses.dataclass
class DecodeResult:
    ok: torch.Tensor          # bool [B] (or scalar)
    data: torch.Tensor        # uint8 [B, info]
    parity: torch.Tensor      # uint8 [B, parity]
    corrected: torch.Tensor   # int32 [B]; for LDPC the iterations used

    def __iter__(self):
        return iter((self.ok, self.data, self.parity, self.corrected))


@dataclasses.dataclass
class EncodeResult:
    data: torch.Tensor
    parity: torch.Tensor

    def __iter__(self):
        return iter((self.data, self.parity))


class Codec:
    def __init__(self, config, device: str | torch.device = "cpu"):
        if isinstance(config, BchConfig):
            raise NotImplementedError(
                "BCH is not ported yet (ROADMAP.md Queue 1 item 8)")
        if not isinstance(config, (RSConfig, LdpcConfig)):
            raise TypeError(f"unknown config type {type(config)}")
        self.config = config
        self.fec_type = config.fec_type
        self.last_corrected = 0
        self.iterations_used = 0
        if isinstance(config, RSConfig):
            self._rs = RSCodec(config, device)
            self.device = self._rs.device
        else:
            self._ldpc = LDPCCodec(config, device)
            self.device = self._ldpc.device

    # -------------------------------------------------------- getters

    @property
    def parity_size(self) -> int:
        """poporon_get_parity_size (poporon.c:324-345)."""
        if self.fec_type == FecType.RS:
            return self._rs.num_roots
        return self._ldpc.parity_bytes

    @property
    def info_size(self) -> int:
        """poporon_get_info_size (poporon.c:347-363)."""
        if self.fec_type == FecType.RS:
            return self._rs.fs - self._rs.num_roots
        return self._ldpc.info_bytes

    # --------------------------------------------------------- encode

    def encode(self, data) -> EncodeResult:
        data = as_tensor(data, torch.uint8, self.device)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
        if self.fec_type == FecType.RS:
            out = EncodeResult(data, self._rs.encode(data))
        else:
            out = self._encode_ldpc(data)
        if squeeze:
            out = EncodeResult(out.data[0], out.parity[0])
        return out

    def _encode_ldpc(self, data) -> EncodeResult:
        c = self._ldpc
        if data.shape[-1] != c.info_bytes:
            raise ValueError(f"LDPC encode size must be {c.info_bytes} (encode.c:154)")
        if c.outer_fwd is not None:
            # outer_buf[fwd[i]] = data[i], a gather by the inverse
            data = data[:, c.outer_inv]
        parity = c.encode(data)
        if c.inter_g is not None:
            cw = c.interleave(torch.cat([data, parity], dim=1))
            data, parity = cw[:, : c.info_bytes], cw[:, c.info_bytes:]
        return EncodeResult(data, parity)

    # --------------------------------------------------------- decode

    def decode(self, data, parity, erasures=None, ext_syndrome=None,
               soft_llr=None) -> DecodeResult:
        data = as_tensor(data, torch.uint8, self.device)
        parity = as_tensor(parity, torch.uint8, self.device)
        if soft_llr is not None:
            soft_llr = as_tensor(soft_llr, torch.int8, self.device)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
            parity = parity[None]
            if soft_llr is not None and soft_llr.ndim == 1:
                soft_llr = soft_llr[None]
        if self.fec_type == FecType.RS:
            if isinstance(erasures, Erasure):
                erasures = erasures.positions.astype(np.int32)
            res = DecodeResult(*self._rs.decode(
                data, parity, erasures=erasures, ext_syndrome=ext_syndrome))
        else:
            res = self._decode_ldpc(data, parity, soft_llr)
        self.last_corrected = res.corrected
        if squeeze:
            res = DecodeResult(
                res.ok[0], res.data[0], res.parity[0], res.corrected[0])
            self.last_corrected = res.corrected
        return res

    def _decode_ldpc(self, data, parity, soft_llr) -> DecodeResult:
        c = self._ldpc
        cfg = self.config
        if data.shape[-1] != c.info_bytes:
            raise ValueError(f"LDPC decode size must be {c.info_bytes} (decode.c:497)")
        # use_soft_decode with no LLRs falls back to hard decoding
        # (reference quirk, decode.c:509-514).  Large batches take the
        # adaptive decode (bit-identical results).
        adaptive = data.shape[0] >= (cfg.adaptive_batch_threshold or 512)
        if cfg.use_soft_decode and soft_llr is not None:
            fn = c.decode_soft_adaptive if adaptive else c.decode_soft
            ok, cw_out, iters = fn(soft_llr, cfg.max_iterations)
        else:
            fn = c.decode_hard_adaptive if adaptive else c.decode_hard
            ok, cw_out, iters = fn(torch.cat([data, parity], dim=1), cfg.max_iterations)
        info = cw_out[:, : c.info_bytes]
        if c.outer_fwd is not None:
            # temp[outer_inv[i]] = cw[i], a gather by the forward permutation
            info = info[:, c.outer_fwd]
        self.iterations_used = iters
        return DecodeResult(ok, torch.where(ok[:, None], info, data), parity, iters)


def create(config, device: str | torch.device = "cpu") -> Codec:
    """poporon_create (poporon.c:172-188), on an explicit device."""
    return Codec(config, device)
