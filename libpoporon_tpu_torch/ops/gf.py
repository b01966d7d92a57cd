"""GF(2^m) tables and GF(2)-linear matrix builders (host, NumPy only).

A jax-free copy of libpoporon_tpu/ops/gf.py.  Table construction is
bit-exact with the reference (src/gf.c:29-86): log/antilog tables with
the sentinel convention ``exp2log[0] == field_size`` ("log of zero") and
``log2exp[field_size] == 0``, plus the primitivity check (the build must
wrap back to 1).

Two representations feed the device code:

1. **log-domain tables** (`log2exp` / `exp2log`) for index lookups
   (ops/gfint.py, csrc/gf8.cuh);
2. **bit-linear matrices**: multiplication by a *constant* c in GF(2^m)
   is a GF(2)-linear map on the m bits of the operand, so whole
   encode/syndrome/Chien evaluations become 0/1 matrices applied with a
   single batched matmul mod 2 (ops/gf2.py).  `mul_matrix(c)` returns
   that m x m matrix (MSB-first bit order).

`gf_mod` note: the reference's shift-add folding loop
(src/internal/common.h:102-110) computes exactly ``value % field_size``
(both the subtraction and the fold preserve the residue mod 2^m - 1 and
the loop exits inside [0, field_size)), so device code simply uses `%`.
"""

from __future__ import annotations

import numpy as np


class GFError(ValueError):
    pass


class GF:
    """GF(2^m) log/antilog tables.

    Supports m in [1, 16].  NOTE: the reference stores field_size in a
    uint8 (common.h:48), so its behaviour for m > 8 is undefined; this
    implementation is correct for all m <= 16, and bit-exactness with
    the reference is guaranteed (and tested) for m <= 8.
    """

    def __init__(self, symbol_size: int, generator_polynomial: int):
        if symbol_size < 1 or symbol_size > 16:
            raise GFError(f"symbol_size must be in [1, 16], got {symbol_size}")
        self.symbol_size = int(symbol_size)
        self.field_size = (1 << symbol_size) - 1  # = 2^m - 1
        self.generator_polynomial = int(generator_polynomial)

        n = self.field_size
        log2exp = np.zeros(n + 1, dtype=np.uint16)  # log -> element
        exp2log = np.zeros(n + 1, dtype=np.uint16)  # element -> log
        exp2log[0] = n          # sentinel: "log of zero"
        log2exp[n] = 0          # sentinel row: gathers of the sentinel yield 0

        e = 1
        for i in range(n):
            exp2log[e] = i
            log2exp[i] = e
            e <<= 1
            if e & (1 << symbol_size):
                e ^= self.generator_polynomial
            e &= n
        if e != int(log2exp[0]):
            raise GFError(
                f"generator polynomial {generator_polynomial:#x} is not "
                f"primitive over GF(2^{symbol_size})"
            )

        self.log2exp = log2exp
        self.exp2log = exp2log

    # ---- scalar host helpers (construction-time) ----

    def gf_mod(self, value: int) -> int:
        return int(value) % self.field_size

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(
            self.log2exp[(int(self.exp2log[a]) + int(self.exp2log[b])) % self.field_size]
        )

    def pow_alpha(self, e: int) -> int:
        """alpha^(e mod field_size)."""
        return int(self.log2exp[int(e) % self.field_size])

    # ---- bit-linear (GF(2)) matrix representations ----

    def mul_matrix(self, c: int) -> np.ndarray:
        """[m, m] 0/1 matrix M with bits(c*x) = bits(x) @ M (mod 2).

        Bit order is MSB-first: row j corresponds to input bit
        2^(m-1-j), column k to output bit 2^(m-1-k).
        """
        m = self.symbol_size
        out = np.zeros((m, m), dtype=np.uint8)
        for j in range(m):
            basis = 1 << (m - 1 - j)
            prod = self.mul(c, basis)
            for k in range(m):
                out[j, k] = (prod >> (m - 1 - k)) & 1
        return out

    def linear_matrix(self, constants: np.ndarray) -> np.ndarray:
        """Stack mul_matrix over a [I, O] grid of constants.

        Given constants C[i, o], returns the [I*m, O*m] 0/1 matrix of the
        GF(2)-linear map  y_o = XOR_i C[i,o] * x_i  on bit-vectors.
        """
        C = np.asarray(constants)
        I, O = C.shape
        m = self.symbol_size
        M = np.zeros((I * m, O * m), dtype=np.uint8)
        cache: dict[int, np.ndarray] = {}
        for i in range(I):
            for o in range(O):
                c = int(C[i, o])
                if c == 0:
                    continue
                blk = cache.get(c)
                if blk is None:
                    blk = self.mul_matrix(c)
                    cache[c] = blk
                M[i * m : (i + 1) * m, o * m : (o + 1) * m] = blk
        return M

    def linear_matrix_bits_in(self, constants: np.ndarray) -> np.ndarray:
        """Like linear_matrix, but each INPUT is a single GF(2) bit.

        Given constants C[i, o], returns the [I, O*m] 0/1 matrix of
        y_o = XOR_i bit_i * C[i,o]: row i holds the MSB-first bits of
        each C[i, o].  (Used where the received word is a plain bit
        vector, e.g. binary BCH syndromes, bch.c:38-42.)
        """
        C = np.asarray(constants)
        I, O = C.shape
        m = self.symbol_size
        M = np.zeros((I, O * m), dtype=np.uint8)
        for k in range(m):
            M[:, k::m] = (C >> (m - 1 - k)) & 1
        return M
