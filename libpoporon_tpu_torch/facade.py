"""Unified codec facade (counterpart of libpoporon_tpu/facade.py, RS part).

One `Codec` object per config, operating on batches of codewords
([B, ...] uint8; a 1-D input is a batch of one) on one explicit torch
device.  Inputs (NumPy arrays or tensors) are moved to that device;
outputs are tensors on it.  Nothing chooses the device for the caller and
nothing moves work to another device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import BchConfig, FecType, LdpcConfig, RSConfig
from .erasure import Erasure
from .models.rs import RSCodec


@dataclasses.dataclass
class DecodeResult:
    ok: torch.Tensor          # bool [B] (or scalar)
    data: torch.Tensor        # uint8 [B, info]
    parity: torch.Tensor      # uint8 [B, parity]
    corrected: torch.Tensor   # int32 [B]

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
        if isinstance(config, LdpcConfig):
            raise NotImplementedError(
                "LDPC is not ported yet (ROADMAP.md Queue 1 items 5-7)")
        if isinstance(config, BchConfig):
            raise NotImplementedError(
                "BCH is not ported yet (ROADMAP.md Queue 1 item 8)")
        if not isinstance(config, RSConfig):
            raise TypeError(f"unknown config type {type(config)}")
        self.config = config
        self.fec_type = config.fec_type
        self.last_corrected = 0
        self._rs = RSCodec(config, device)
        self.device = self._rs.device

    # -------------------------------------------------------- getters

    @property
    def parity_size(self) -> int:
        """poporon_get_parity_size (poporon.c:324-345)."""
        return self._rs.num_roots

    @property
    def info_size(self) -> int:
        """poporon_get_info_size (poporon.c:347-363)."""
        return self._rs.fs - self._rs.num_roots

    # --------------------------------------------------------- encode

    def encode(self, data) -> EncodeResult:
        data = self._rs.as_tensor(data, torch.uint8)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
        out = EncodeResult(data, self._rs.encode(data))
        if squeeze:
            out = EncodeResult(out.data[0], out.parity[0])
        return out

    # --------------------------------------------------------- decode

    def decode(self, data, parity, erasures=None, ext_syndrome=None) -> DecodeResult:
        data = self._rs.as_tensor(data, torch.uint8)
        parity = self._rs.as_tensor(parity, torch.uint8)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
            parity = parity[None]
        if isinstance(erasures, Erasure):
            erasures = erasures.positions.astype(np.int32)
        res = DecodeResult(*self._rs.decode(
            data, parity, erasures=erasures, ext_syndrome=ext_syndrome))
        self.last_corrected = res.corrected
        if squeeze:
            res = DecodeResult(
                res.ok[0], res.data[0], res.parity[0], res.corrected[0])
            self.last_corrected = res.corrected
        return res


def create(config, device: str | torch.device = "cpu") -> Codec:
    """poporon_create (poporon.c:172-188), on an explicit device."""
    return Codec(config, device)
