"""MSB-first bit pack/unpack, on NumPy arrays and torch tensors.

Counterpart of libpoporon_tpu/utils/bits.py.  The reference library
addresses bits MSB-first within each byte (reference src/ldpc.c:71-86).
Packing pads the slack bits of a last partial byte with 0.
"""

from __future__ import annotations

import numpy as np
import torch


def unpack_np(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """uint8 [..., nbytes] -> uint8 bits [..., nbytes*8 (or nbits)]."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1, bitorder="big")
    return bits if nbits is None else bits[..., :nbits]


def pack_np(bits: np.ndarray) -> np.ndarray:
    """0/1 bits [..., nbits] -> uint8 [..., ceil(nbits/8)]."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1, bitorder="big")


def unpack(data: torch.Tensor, nbits: int | None = None) -> torch.Tensor:
    """uint8 [..., nbytes] -> int8 bits [..., nbytes*8 (or nbits)]."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., :, None] >> shifts) & 1
    bits = bits.reshape(*data.shape[:-1], data.shape[-1] * 8)
    if nbits is not None:
        bits = bits[..., :nbits]
    return bits.to(torch.int8)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits [..., nbits] -> uint8 [..., ceil(nbits/8)]."""
    nbits = bits.shape[-1]
    nbytes = (nbits + 7) // 8
    pad = nbytes * 8 - nbits
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(*bits.shape[:-1], nbytes, 8).to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    return (b << shifts).sum(dim=-1, dtype=torch.uint8)
