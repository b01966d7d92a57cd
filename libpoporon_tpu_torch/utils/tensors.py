"""Inputs onto a codec's device, and kernel arguments checked."""

from __future__ import annotations

import numpy as np
import torch

_NP_DTYPES = {torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32}


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """x (an array-like or a tensor) as a `dtype` tensor on `device`; an
    array-like is copied, so no result aliases the caller's array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x, dtype=_NP_DTYPES[dtype]), device=device)


def symbol_dtype(m: int) -> torch.dtype:
    """The dtype that holds RS symbols of m bits: bytes for m <= 8, 16-bit
    words (int16, read as unsigned) for 8 < m <= 16."""
    return torch.uint8 if m <= 8 else torch.int16


def as_symbols(x, m: int, device) -> torch.Tensor:
    """x (an array-like or a tensor) as RS symbols of m bits on `device`,
    in `symbol_dtype(m)`; an array-like is copied.  For m <= 8 exactly
    `as_tensor(x, torch.uint8, device)`.  For m > 8 an input already of
    that dtype, or of uint8, is taken as it is; one of another integer
    dtype must hold symbols in [0, 2^m), else ValueError: a symbol is never
    cut to fit."""
    if m <= 8:
        return as_tensor(x, torch.uint8, device)
    dtype = symbol_dtype(m)
    if isinstance(x, torch.Tensor):
        if x.dtype not in (dtype, torch.uint8):
            if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
                raise ValueError(f"RS symbols of {m} bits must be integers, got {x.dtype}")
            if x.numel() and bool(((x < 0) | (x >= 1 << m)).any()):
                raise ValueError(f"RS symbols of {m} bits must lie in [0, {1 << m}); "
                                 f"a {x.dtype} input holds others")
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if a.dtype not in (np.int16, np.uint8):
        if a.dtype.kind not in "iu":
            raise ValueError(f"RS symbols of {m} bits must be integers, got {a.dtype}")
        if a.size and bool(((a < 0) | (a >= 1 << m)).any()):
            raise ValueError(f"RS symbols of {m} bits must lie in [0, {1 << m}); "
                             f"a {a.dtype} input holds others")
    return torch.tensor(a.astype(np.int16), device=device)


def checked(t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """t as a contiguous tensor of `dtype` on `device`, shape checked."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.to(device=device, dtype=dtype).contiguous()
