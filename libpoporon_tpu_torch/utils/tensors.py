"""Inputs onto a codec's device, and kernel arguments checked."""

from __future__ import annotations

import numpy as np
import torch

_NP_DTYPES = {torch.uint8: np.uint8, torch.int8: np.int8, torch.int32: np.int32}


def as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """x (an array-like or a tensor) as a `dtype` tensor on `device`; an
    array-like is copied, so no result aliases the caller's array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x, dtype=_NP_DTYPES[dtype]), device=device)


def checked(t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """t as a contiguous tensor of `dtype` on `device`, shape checked."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.to(device=device, dtype=dtype).contiguous()
