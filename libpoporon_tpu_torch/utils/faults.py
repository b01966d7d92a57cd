"""Codec-level fault injection (analogue of reference tests/util.h:29-94).

A copy of libpoporon_tpu/utils/faults.py (NumPy only), so that the port
imports nothing of the JAX package; the tests hold the two equal.

Batched error/erasure injection helpers used by tests and benchmarks:
`break_data` flips whole symbols (XOR 0xFF like the reference helper, or
random nonzero patterns), `break_data_erasure` additionally records the
positions, `flip_bits` flips individual bits for LDPC/BCH workloads.
"""

from __future__ import annotations

import numpy as np


def break_data(data: np.ndarray, num_errors: int, rng=None, pattern: int = 0xFF):
    """Corrupt `num_errors` distinct symbol positions per codeword.

    data: uint8 [B, size] (modified copy returned).
    pattern: XOR pattern; None -> random nonzero per error.
    Returns (corrupted, positions [B, num_errors]).
    """
    rng = np.random.default_rng(rng)
    data = np.asarray(data, dtype=np.uint8).copy()
    B, size = data.shape
    positions = np.stack(
        [rng.choice(size, num_errors, replace=False) for _ in range(B)]
    ).astype(np.int32)
    for b in range(B):
        for p in positions[b]:
            v = pattern if pattern is not None else int(rng.integers(1, 256))
            data[b, p] ^= v
    return data, positions


def break_data_erasure(data: np.ndarray, num_errors: int, rng=None):
    """Like break_data but returns sorted positions suitable for the
    erasure decode path (positions are known to the receiver)."""
    corrupted, positions = break_data(data, num_errors, rng)
    return corrupted, np.sort(positions, axis=1)


def flip_bits(codewords: np.ndarray, nbits: int, total_bits: int, rng=None):
    """Flip `nbits` random distinct bits (MSB-first order) per codeword.

    codewords: uint8 [B, nbytes]; returns (corrupted, bit_positions).
    """
    rng = np.random.default_rng(rng)
    cw = np.asarray(codewords, dtype=np.uint8).copy()
    B = cw.shape[0]
    positions = np.stack(
        [rng.choice(total_bits, nbits, replace=False) for _ in range(B)]
    ).astype(np.int32)
    for b in range(B):
        for p in positions[b]:
            cw[b, p // 8] ^= 1 << (7 - (p % 8))
    return cw, positions


def awgn_llrs(codeword_bits: np.ndarray, snr_db: float, rng=None) -> np.ndarray:
    """Map 0/1 bits through BPSK + AWGN to int8 channel LLRs.

    Returns int8 [B, nbits] LLRs scaled to the reference's convention
    (positive = bit 0 more likely; magnitude ~ 4*y*Es/N0 clipped to
    [-127, 127]).
    """
    rng = np.random.default_rng(rng)
    bits = np.asarray(codeword_bits)
    snr = 10.0 ** (snr_db / 10.0)
    sigma = 1.0 / np.sqrt(2.0 * snr)
    tx = 1.0 - 2.0 * bits  # bit 0 -> +1, bit 1 -> -1
    y = tx + rng.normal(0.0, sigma, bits.shape)
    llr = 2.0 * y / (sigma**2)
    scale = 16.0  # fixed-point scale into int8 range
    return np.clip(llr * scale, -127, 127).astype(np.int8)
