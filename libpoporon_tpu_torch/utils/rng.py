"""Deterministic RNG: Xoshiro128++ seeded via a SplitMix32 chain.

Counterpart of libpoporon_tpu/utils/rng.py, in plain Python and NumPy:
the reference's seeding chain, 32-bit wraparound and per-draw order
(reference src/rng.c:27-132).  The LDPC graphs and interleavers are
built from this stream on the host, once per config; at 128-byte blocks
their construction draws about 5k values and at 8192 bytes about 200k, so a
Python loop is fast enough and no native core is loaded.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF

# Seeding-chain additive constants (reference: src/rng.c:17-20).
_CHAIN = (0x6C078965, 0x9D2C5680, 0xEFC60000, 0x12345678)


def _splitmix32(z: int) -> int:
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return (z ^ (z >> 16)) & _M32


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def _seed_to_u32(seed) -> int:
    """The C library's memcpy of up to 4 little-endian seed bytes into a
    zero-initialised uint32 (src/rng.c:43-46)."""
    if seed is None:
        return 0
    if isinstance(seed, (bytes, bytearray)):
        b = bytes(seed[:4])
        return int.from_bytes(b.ljust(4, b"\x00"), "little")
    return int(seed) & _M32


class Xoshiro128pp:
    """Sequential Xoshiro128++ stream (reference: src/rng.c:61-76)."""

    __slots__ = ("s0", "s1", "s2", "s3")

    def __init__(self, seed=0):
        z = (_seed_to_u32(seed) + _CHAIN[0]) & _M32
        self.s0 = _splitmix32(z)
        self.s1 = _splitmix32((self.s0 + _CHAIN[1]) & _M32)
        self.s2 = _splitmix32((self.s1 + _CHAIN[2]) & _M32)
        self.s3 = _splitmix32((self.s2 + _CHAIN[3]) & _M32)

    def next_u32(self) -> int:
        s0, s1, s2, s3 = self.s0, self.s1, self.s2, self.s3
        result = (_rotl((s0 + s3) & _M32, 7) + s0) & _M32
        t = (s1 << 9) & _M32
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        self.s0, self.s1, self.s2, self.s3 = s0, s1, s2, _rotl(s3, 11)
        return result

    def draw_u32(self, count: int) -> np.ndarray:
        """Bulk draw of `count` sequential uint32 values."""
        return np.fromiter((self.next_u32() for _ in range(count)),
                           dtype=np.uint32, count=count)

    def fill_bytes(self, size: int) -> bytes:
        """`size` bytes, 4 little-endian bytes per draw, with a final
        partial draw for the remainder (reference: src/rng.c:106-132)."""
        if size <= 0:
            return b""
        vals = self.draw_u32((size + 3) // 4)
        return vals.astype("<u4").tobytes()[:size]
