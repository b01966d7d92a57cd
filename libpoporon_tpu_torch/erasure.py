"""Erasure-position tracking (reference: src/erasure.c).

The reference keeps a growable uint32 position list plus a parallel
uint16 corrections array.  Here it is a small host-side helper that also
batches: `positions_batch` produces the padded [B, e_max] tensor + per-
element counts the batched RS erasure decoder consumes.
"""

from __future__ import annotations

import numpy as np


class Erasure:
    def __init__(self, num_roots: int, initial_capacity: int = 0):
        # capacity semantics per erasure.c:27-57 (kept for API parity;
        # Python lists grow on their own).
        self.capacity = initial_capacity if initial_capacity > 0 else int(num_roots)
        self._positions: list[int] = []

    @classmethod
    def from_positions(cls, num_roots: int, positions) -> "Erasure":
        e = cls(num_roots, max(len(positions), num_roots))
        e._positions = [int(p) for p in positions]
        return e

    def add_position(self, position: int) -> None:
        self._positions.append(int(position))

    def reset(self) -> None:
        self._positions.clear()

    @property
    def count(self) -> int:
        return len(self._positions)

    @property
    def positions(self) -> np.ndarray:
        return np.asarray(self._positions, dtype=np.uint32)

    def __len__(self) -> int:
        return len(self._positions)


def positions_batch(erasures, e_max: int, batch: int):
    """Normalise erasure inputs to padded ([B, e_max] int32, [B] int32).

    `erasures` may be an Erasure, a 1-D position list (broadcast over the
    batch), or a (positions [B, <=e_max], counts [B]) pair.
    """
    if isinstance(erasures, Erasure):
        pos = erasures.positions.astype(np.int32)
        counts = np.full(batch, len(pos), dtype=np.int32)
        padded = np.zeros((batch, e_max), dtype=np.int32)
        padded[:, : len(pos)] = pos[None, :]
        return padded, counts
    if isinstance(erasures, tuple) and len(erasures) == 2:
        pos, counts = erasures
        pos = np.asarray(pos, dtype=np.int32)
        counts = np.asarray(counts, dtype=np.int32)
        padded = np.zeros((batch, e_max), dtype=np.int32)
        padded[:, : pos.shape[1]] = pos
        return padded, counts
    pos = np.asarray(erasures, dtype=np.int32)
    if pos.ndim == 1:
        counts = np.full(batch, len(pos), dtype=np.int32)
        padded = np.zeros((batch, e_max), dtype=np.int32)
        padded[:, : len(pos)] = pos[None, :]
        return padded, counts
    raise ValueError("unsupported erasure specification")
