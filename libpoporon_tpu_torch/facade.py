"""Unified codec facade (counterpart of libpoporon_tpu/facade.py).

One `Codec` object per config, operating on batches of codewords
([B, ...]; a 1-D input is a batch of one) on one torch device: the card
("cuda") unless the caller asks for another, such as "cpu".  Without a
card the default raises; it never falls back to the CPU.  Inputs (NumPy
arrays or tensors) are moved to the codec's device; outputs are tensors
on it.  Nothing moves work to another device.

Codewords are bytes (uint8), but for RS codes of symbols wider than a
byte, whose symbols are 16-bit words (int16, read as unsigned): the
codec's `symbol_dtype`, which follows from the config.  RS(544,514) over
GF(2^10), the KP4 code of 400G Ethernet, is

    codec = create(RSConfig(10, 0x409, 0, 1, 30))    # symbol_dtype int16
    parity = codec.encode(data).parity               # data [B, 514], each < 1024
    res = codec.decode(data, parity)

Past m = 8 an RS codec encodes and runs the plain decode; erasure and
external-syndrome decodes and `reconstruct` raise ValueError there, and
no symbol is ever cut to a byte.

As in the JAX package, LDPC `encode` returns the interleaved data where
the config interleaves, and LDPC `decode` reports the iterations used in
`corrected` (reference quirk, decode.c:535-537).  BCH `encode` returns
the caller's data unchanged beside the parity; BCH `decode` writes the
corrected data_bytes over the row as the JAX package does, so a row
longer than data_bytes gets them broadcast when data_bytes is 1 and
raises ValueError otherwise (ROADMAP.md Queue 3, F7), and gives the
per-row error counts, -1 on a failed row, in `last_num_errors`.  A
shortened BCH code of whole data bytes on the card (NAND's BCH-8 on
512-byte sectors, `BchConfig(13, 0x201b, 8, data_length=4096)`) decodes
rows of exactly data_bytes and parity_bytes in one kernel launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import BchConfig, FecType, LdpcConfig, RSConfig
from .erasure import Erasure
from .models.bch import BCHCodec
from .models.ldpc import LDPCCodec
from .models.rs import RSCodec
from .utils.profiling import span
from .utils.tensors import as_symbols, as_tensor


@dataclasses.dataclass
class DecodeResult:
    ok: torch.Tensor          # bool [B] (or scalar)
    data: torch.Tensor        # symbol_dtype [B, info]
    parity: torch.Tensor      # symbol_dtype [B, parity]
    corrected: torch.Tensor   # int32 [B]; for LDPC the iterations used

    def __iter__(self):
        return iter((self.ok, self.data, self.parity, self.corrected))


@dataclasses.dataclass
class ReconstructResult:
    ok: torch.Tensor          # bool [L]
    rebuilt: torch.Tensor     # uint8 [e, L], the lost cells in the order named
    corrected: torch.Tensor   # uint8 [L]
    failed: torch.Tensor      # int32 [], the columns not ok

    def __iter__(self):
        return iter((self.ok, self.rebuilt, self.corrected, self.failed))


@dataclasses.dataclass
class EncodeResult:
    data: torch.Tensor
    parity: torch.Tensor

    def __iter__(self):
        return iter((self.data, self.parity))


class Codec:
    def __init__(self, config, device: str | torch.device = "cuda"):
        if not isinstance(config, (RSConfig, LdpcConfig, BchConfig)):
            raise TypeError(f"unknown config type {type(config)}")
        self.config = config
        self.fec_type = config.fec_type
        self.last_corrected = 0
        self.iterations_used = 0
        # bits a symbol of the codewords in and out: RS's m, else bytes
        self._m = config.symbol_size if isinstance(config, RSConfig) else 8
        if isinstance(config, RSConfig):
            self._rs = RSCodec(config, device)
            self.device = self._rs.device
        elif isinstance(config, LdpcConfig):
            self._ldpc = LDPCCodec(config, device)
            self.device = self._ldpc.device
        else:
            self._bch = BCHCodec(config, device)
            self.device = self._bch.device

    # -------------------------------------------------------- getters

    @property
    def parity_size(self) -> int:
        """poporon_get_parity_size (poporon.c:324-345)."""
        if self.fec_type == FecType.RS:
            return self._rs.num_roots
        if self.fec_type == FecType.LDPC:
            return self._ldpc.parity_bytes
        return self._bch.parity_bytes

    @property
    def info_size(self) -> int:
        """poporon_get_info_size (poporon.c:347-363)."""
        if self.fec_type == FecType.RS:
            return self._rs.fs - self._rs.num_roots
        if self.fec_type == FecType.LDPC:
            return self._ldpc.info_bytes
        return self._bch.data_bytes

    @property
    def symbol_dtype(self) -> torch.dtype:
        """The dtype of codewords in and out: uint8, or for RS symbols of
        more than 8 bits int16 (models/rs.py RSCodec)."""
        if self.fec_type == FecType.RS:
            return self._rs.symbol_dtype
        return torch.uint8

    # --------------------------------------------------------- encode

    def encode(self, data) -> EncodeResult:
        data = as_symbols(data, self._m, self.device)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
        if self.fec_type == FecType.RS:
            out = EncodeResult(data, self._rs.encode(data))
        elif self.fec_type == FecType.LDPC:
            out = self._encode_ldpc(data)
        else:
            out = self._encode_bch(data)
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

    def _encode_bch(self, data) -> EncodeResult:
        c = self._bch
        if data.shape[-1] < c.data_bytes:
            raise ValueError("BCH encode: data too short (encode.c:211)")
        cw_bits = c.encode_bits(c.pack_data(data))
        return EncodeResult(data, c.unpack_parity(cw_bits[:, : c.parity_bits]))

    # --------------------------------------------------------- decode

    def decode(self, data, parity, erasures=None, ext_syndrome=None,
               soft_llr=None) -> DecodeResult:
        with span("poporon.facade.decode"):
            data = as_symbols(data, self._m, self.device)
            parity = as_symbols(parity, self._m, self.device)
            if soft_llr is not None:
                soft_llr = as_tensor(soft_llr, torch.int8, self.device)
            squeeze = data.ndim == 1
            if squeeze:
                data = data[None]
                parity = parity[None]
                if soft_llr is not None and soft_llr.ndim == 1:
                    soft_llr = soft_llr[None]
            if parity.shape[:-1] != data.shape[:-1]:
                # the JAX package fails here, joining the two in its codecs
                raise ValueError(f"data {tuple(data.shape)} and parity "
                                 f"{tuple(parity.shape)} differ in their batch")
            if self.fec_type == FecType.RS:
                if isinstance(erasures, Erasure):
                    erasures = erasures.positions.astype(np.int32)
                res = DecodeResult(*self._rs.decode(
                    data, parity, erasures=erasures, ext_syndrome=ext_syndrome))
            elif self.fec_type == FecType.LDPC:
                res = self._decode_ldpc(data, parity, soft_llr)
            else:
                res = self._decode_bch(data, parity)
            self.last_corrected = res.corrected
            if squeeze:
                res = DecodeResult(
                    res.ok[0], res.data[0], res.parity[0], res.corrected[0])
                self.last_corrected = res.corrected
            return res

    def reconstruct(self, cells, lost) -> ReconstructResult:
        """Rebuild the lost cells of shard-major RS stripes, as storage
        does after losing disks: cells uint8 [n, L] (data cells, then
        num_roots parity cells; byte t of each cell is codeword t), lost
        the 1..num_roots cells missing from every stripe, whose contents
        are ignored.  Column for column: the ok and the count of `decode`
        of that codeword with the lost cells zeroed and given as erasures,
        and the lost cells' bytes, data and parity, of the codeword it
        finds, in the order named (models/rs.py `RSCodec.reconstruct`).
        On the card one kernel launch, whatever the columns hold."""
        with span("poporon.facade.reconstruct"):
            if self.fec_type != FecType.RS:
                raise TypeError(f"reconstruct takes an RS configuration, not {self.fec_type.name}")
            return ReconstructResult(*self._rs.reconstruct(cells, lost))

    def _decode_ldpc(self, data, parity, soft_llr) -> DecodeResult:
        c = self._ldpc
        cfg = self.config
        if data.shape[-1] != c.info_bytes:
            raise ValueError(f"LDPC decode size must be {c.info_bytes} (decode.c:497)")
        if parity.shape[-1] != c.parity_bytes:
            # the C reads parity_bytes; JAX gathers past the end of a short
            # word and decodes a longer one misaligned
            raise ValueError(f"LDPC parity size must be {c.parity_bytes}")
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

    def _decode_bch(self, data, parity) -> DecodeResult:
        c = self._bch
        if data.shape[-1] < c.data_bytes:
            raise ValueError("BCH decode: data too short (decode.c:555)")
        ok, data_out, corrected = c.decode_bytes(data, parity)
        self._bch_last = (ok, corrected)
        return DecodeResult(ok, data_out, parity, corrected)

    @property
    def last_num_errors(self) -> torch.Tensor:
        """The last BCH decode's per-row error counts, -1 on a failed row,
        computed when read (AttributeError before any BCH decode)."""
        last = getattr(self, "_bch_last", None)
        if last is None:
            raise AttributeError("no BCH decode has run: last_num_errors is unset")
        ok, corrected = last
        return torch.where(ok, corrected, -1)


def create(config, device: str | torch.device = "cuda") -> Codec:
    """poporon_create (poporon.c:172-188), on `device` (default the card;
    raises RuntimeError where torch sees none)."""
    return Codec(config, device)
