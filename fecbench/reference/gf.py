"""GF(2^m) log/antilog tables and GF(2)-linear matrices (NumPy), built
from the field's polynomial as the reference C library builds them
(src/gf.c:29-86): ``exp2log[0] == field_size`` is the log of zero and
``log2exp[field_size] == 0``.
"""

from __future__ import annotations

import numpy as np


class GF:
    def __init__(self, m: int, poly: int):
        n = (1 << m) - 1
        self.m, self.field_size, self.poly = m, n, poly
        log2exp = np.zeros(n + 1, dtype=np.int64)
        exp2log = np.zeros(n + 1, dtype=np.int64)
        exp2log[0] = n
        e = 1
        for i in range(n):
            exp2log[e] = i
            log2exp[i] = e
            e <<= 1
            if e & (1 << m):
                e ^= poly
            e &= n
        if e != 1 or np.unique(log2exp[:n]).size != n:
            raise ValueError(f"{poly:#x} is not a primitive polynomial of GF(2^{m})")
        self.log2exp, self.exp2log = log2exp, exp2log

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.log2exp[(self.exp2log[a] + self.exp2log[b]) % self.field_size])

    def linear_matrix(self, constants: np.ndarray) -> np.ndarray:
        """The [I*m, O*m] 0/1 matrix of y_o = XOR_i C[i, o] * x_i on
        MSB-first bit vectors."""
        C = np.asarray(constants)
        m = self.m
        blocks = {}
        for c in np.unique(C):
            blk = np.zeros((m, m), dtype=np.uint8)
            for j in range(m):
                prod = self.mul(int(c), 1 << (m - 1 - j))
                blk[j] = (prod >> np.arange(m - 1, -1, -1)) & 1
            blocks[int(c)] = blk
        out = np.stack([np.stack([blocks[int(c)] for c in row]) for row in C])  # [I, O, m, m]
        return out.transpose(0, 2, 1, 3).reshape(C.shape[0] * m, C.shape[1] * m)
