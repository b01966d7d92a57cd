"""Mod-2 matrix multiplication (counterpart of libpoporon_tpu/ops/gf2.py).

All GF(2^m)-linear maps with fixed constants (RS encode, syndromes, the
evaluations at every field point) reduce to ``bits @ M mod 2`` with a 0/1
matrix M.
"""

from __future__ import annotations

import torch


def gf2_matmul(x_bits: torch.Tensor, mat_bits: torch.Tensor) -> torch.Tensor:
    """(x_bits @ mat_bits) mod 2 as int32 0/1.

    x_bits: [..., K] 0/1 of any dtype; mat_bits: [K, N] 0/1.  Exact in
    float32: the products are 0/1 and every partial sum is an integer
    below K + 1 <= 2041 < 2^24.  TF32 keeps that exactness too, since it
    rounds only the 0/1 inputs.
    """
    acc = x_bits.float() @ mat_bits.float()
    return acc.to(torch.int32) & 1
