"""Plain binary BCH encode and decode over GF(2^m), shortened or not, the
benchmark's yardstick for BCH cells.

Written from the textbook (Lin and Costello, ch. 6) on the field's log
and antilog tables alone (reference/gf.py), with no bit matrix of the
program's: g(x) is the LCM of the minimal polynomials of alpha^1 ..
alpha^2t, each the product of (x - beta) over its conjugates; the
encoder divides data(x) x^deg g by g(x) in an LFSR a byte a step, over
all rows at once; the decoder takes the syndromes S_i = sum of
alpha^(i p) over the word's set bits p (odd i directly, S_2j = S_j^2),
runs Berlekamp's binary algorithm (Massey's with the even steps, whose
discrepancy is zero for a binary word, folded in: t steps), searches the
locator's roots at alpha^-p over the word's own positions p only, in
blocks of positions, fails a row whose roots are fewer than the
locator's length L or whose L exceeds t, verifies that the corrected
word's syndromes are zero, and flips the found bits.  A word of
`data_length` data bits (the configuration's, else the full length; a
whole number of bytes) is parity_bits + data_length bits: bit p <
parity_bits is parity bit p, bit p >= parity_bits data bit p -
parity_bits, and bytes are big-endian, the first data byte holding the
highest bits, as the port's facade packs them.  It returns what the facade returns: ok; the data corrected on an
ok row and as given on any other; the parity as given; the count of
corrected bits, 0 on clean and failed rows.

`bm_steps` cuts the binary algorithm to fewer steps than t; `control`
cuts it to t - 1, so that a row of exactly t errors is no longer
corrected: the guarantee of the configuration (t bit errors a word)
broken.
"""

from __future__ import annotations

import numpy as np
import torch

from .gf import GF

POSITIONS = 1024       # Chien's positions a block


def _clmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        b >>= 1
    return out


def generator(gf: GF, t: int) -> int:
    """g(x) = LCM of the minimal polynomials of alpha^1 .. alpha^2t, bit j
    the coefficient of x^j."""
    fs = gf.field_size
    seen, g = set(), 1
    for i in range(1, 2 * t + 1):
        if i % fs in seen:
            continue
        conj, e = [], i % fs
        while e not in conj:
            conj.append(e)
            e = 2 * e % fs
        seen.update(conj)
        poly = [1]                                   # coefficients in GF(2^m), x^0 first
        for e in conj:                               # poly *= (x + alpha^e)
            beta = int(gf.log2exp[e])
            nxt = [0] * (len(poly) + 1)
            for k, c in enumerate(poly):
                nxt[k + 1] ^= c
                nxt[k] ^= gf.mul(c, beta)
            poly = nxt
        if any(c not in (0, 1) for c in poly):
            raise ValueError("a minimal polynomial with coefficients outside GF(2)")
        g = _clmul(g, sum(c << k for k, c in enumerate(poly)))
    return g


class BCHReference:
    """Plain binary BCH of one configuration on one torch device.  cfg:
    the configuration file's keys."""

    def __init__(self, cfg: dict, device="cpu", bm_steps: int | None = None):
        self.device = dev = torch.device(device)
        self.gf = gf = GF(int(cfg["symbol_size"]), int(cfg["generator_polynomial"]))
        self.m, self.fs = gf.m, gf.field_size
        self.t = int(cfg["correction_capability"])
        self.gen = generator(gf, self.t)
        self.pb = self.gen.bit_length() - 1
        self.k = int(cfg.get("data_length") or 0) or self.fs - self.pb
        if not (8 <= self.pb and 0 < self.k <= self.fs - self.pb and self.k % 8 == 0):
            raise ValueError(f"no word of {self.k} data bits (whole bytes) and {self.pb} "
                             f"parity bits (8 or more) in GF(2^{self.m})")
        self.n = self.pb + self.k
        self.info_bytes = (self.k + 7) // 8
        self.parity_bytes = (self.pb + 7) // 8
        self.bm_steps = self.t if bm_steps is None else bm_steps
        self.log = torch.tensor(gf.exp2log, device=dev)        # log[0] = fs
        self.alog = torch.tensor(gf.log2exp, device=dev)       # alog[fs] = 0
        # the LFSR's byte table: row u the bits of u(x) x^pb mod g, x^0 first
        rem, r = [], self.gen ^ (1 << self.pb)
        for _ in range(8):
            rem.append(r)
            r = (r << 1) ^ (self.gen if r >> (self.pb - 1) & 1 else 0)
        rows = []
        for u in range(256):
            v = 0
            for b in range(8):
                if u >> b & 1:
                    v ^= rem[b]
            rows.append([(v >> j) & 1 for j in range(self.pb)])
        self.lfsr = torch.tensor(rows, dtype=torch.uint8, device=dev)         # [256, pb]
        # alpha^(i p) for odd i, each value's bit planes: [n, t, m]
        p = np.arange(self.n)[:, None]
        odd = 2 * np.arange(self.t)[None, :] + 1
        val = gf.log2exp[(odd * p) % self.fs]
        planes = (val[:, :, None] >> np.arange(self.m)) & 1
        self.odd_planes = torch.tensor(planes.reshape(self.n, -1), dtype=torch.float64, device=dev)

    # ------------------------------------------------------------ bits

    def _data_bits(self, data: torch.Tensor) -> torch.Tensor:
        """uint8 [B, info_bytes] big-endian -> bits [B, k], bit j data bit j."""
        bits = ((data[:, :, None].to(torch.int64) >> torch.arange(8, device=data.device)) & 1)
        return bits.flip(1).reshape(data.shape[0], -1)[:, : self.k]

    def _parity_bits(self, parity: torch.Tensor) -> torch.Tensor:
        bits = ((parity[:, :, None].to(torch.int64) >> torch.arange(8, device=parity.device)) & 1)
        return bits.flip(1).reshape(parity.shape[0], -1)[:, : self.pb]

    def _bits_to_bytes(self, bits: torch.Tensor, nbytes: int) -> torch.Tensor:
        pad = nbytes * 8 - bits.shape[1]
        bits = torch.cat([bits, bits.new_zeros(bits.shape[0], pad)], dim=1)
        w = 1 << torch.arange(8, device=bits.device)
        return (bits.reshape(bits.shape[0], nbytes, 8) * w).sum(2).flip(1).to(torch.uint8)

    # ------------------------------------------------------------ encode

    def encode(self, data: torch.Tensor):
        """The systematic encode of data uint8 [B, info_bytes]: (data,
        parity uint8 [B, parity_bytes]), parity(x) = data(x) x^pb mod g,
        the register's bits x^0 first, a data byte a step, the first byte
        (the highest powers) first."""
        B = data.shape[0]
        reg = torch.zeros(B, self.pb, dtype=torch.uint8, device=data.device)
        w = 1 << torch.arange(8, device=data.device)
        for i in range(self.info_bytes):
            top = (reg[:, self.pb - 8:].to(torch.int64) * w).sum(1) ^ data[:, i].to(torch.int64)
            reg = torch.cat([reg.new_zeros(B, 8), reg[:, : self.pb - 8]], dim=1) ^ self.lfsr[top]
        return data, self._bits_to_bytes(reg.to(torch.int64), self.parity_bytes)

    # ------------------------------------------------------------ decode

    def _mul(self, a, b):
        s = (self.log[a] + self.log[b]) % self.fs
        return torch.where((a == 0) | (b == 0), 0, self.alog[s])

    def _syndromes(self, word: torch.Tensor) -> torch.Tensor:
        """S_1 .. S_2t [B, 2t] of the rows' bits [B, n]: the odd ones as
        sums over the set bits, each bit plane's parity, the even ones
        squares."""
        sums = word.to(torch.float64) @ self.odd_planes                   # [B, t m]
        planes = (sums.round().to(torch.int64) & 1).reshape(-1, self.t, self.m)
        odd = (planes << torch.arange(self.m, device=word.device)).sum(2)  # [B, t]
        s = torch.zeros(word.shape[0], 2 * self.t, dtype=torch.int64, device=word.device)
        s[:, 0::2] = odd
        for j in range(1, self.t + 1):                                      # S_2j = S_j^2
            s[:, 2 * j - 1] = self._mul(s[:, j - 1], s[:, j - 1])
        return s

    def _locator(self, s: torch.Tensor):
        """Berlekamp's binary algorithm over S_1..S_2t [B, 2t]: (the
        locator [B, 2t + 2], its length L [B])."""
        B, dev = s.shape[0], s.device
        lanes = 2 * self.t + 2
        c = torch.zeros(B, lanes, dtype=torch.int64, device=dev)
        c[:, 0] = 1
        bx = torch.zeros_like(c)          # x^shift b(x): b = 1, shift 1
        bx[:, 1] = 1
        L = torch.zeros(B, dtype=torch.int64, device=dev)
        bd = torch.ones(B, dtype=torch.int64, device=dev)      # the discrepancy b was saved at
        lane = torch.arange(lanes, device=dev)

        def times_x(p, k):
            return torch.cat([p.new_zeros(B, k), p[:, : lanes - k]], dim=1)

        for step in range(self.bm_steps):
            r = 2 * step                                  # S_(r+1), 0-based r
            idx = (r - lane).clamp(min=0)
            terms = self._mul(c, s.gather(1, idx.expand(B, lanes).contiguous()))
            terms = torch.where((lane <= r)[None, :] & (lane <= L[:, None]), terms, 0)
            d = terms[:, 0]
            for j in range(1, lanes):
                d = d ^ terms[:, j]
            f = self._mul(d, self.alog[(self.fs - self.log[bd]) % self.fs])      # d / b
            new_c = c ^ self._mul(bx, f[:, None])
            change = (d != 0) & (2 * L <= r)
            bx = torch.where(change[:, None], times_x(c, 2), times_x(bx, 2))
            bd = torch.where(change, d, bd)
            L = torch.where(change, r + 1 - L, L)
            c = torch.where((d != 0)[:, None], new_c, c)
        return c, L

    def _roots(self, c: torch.Tensor, L: torch.Tensor):
        """Roots alpha^-p of the locators c over the word's positions p <
        n, in blocks of positions: (positions [B, t], ascending, padded
        with n; their count [B])."""
        B, dev, fs = c.shape[0], c.device, self.fs
        lc = self.log[c[:, 1: self.t + 1]]                               # [B, t], fs for zero
        pos = torch.full((B, self.t), self.n, dtype=torch.int64, device=dev)
        count = torch.zeros(B, dtype=torch.int64, device=dev)
        for p0 in range(0, self.n, POSITIONS):
            p = torch.arange(p0, min(p0 + POSITIONS, self.n), device=dev)        # [P]
            acc = torch.zeros(B, p.numel(), dtype=torch.int64, device=dev)
            for j in range(1, self.t + 1):
                e = (lc[:, j - 1: j] - j * p[None, :]) % fs                     # [B, P]
                acc ^= torch.where(lc[:, j - 1: j] == fs, 0, self.alog[e])
            root = acc == 1                                                   # lambda_0 = 1
            rank = count[:, None] + torch.cumsum(root.to(torch.int64), 1) - 1
            keep = root & (rank < self.t)
            slot = torch.where(keep, rank, self.t)
            wide = torch.cat([pos, pos.new_full((B, 1), self.n)], dim=1)
            wide.scatter_(1, slot, torch.where(keep, p[None, :].expand_as(slot), self.n))
            pos = wide[:, : self.t]
            count = count + root.sum(1)
        return pos, count

    def decode(self, data: torch.Tensor, parity: torch.Tensor):
        """Plain decode of data uint8 [B, info_bytes] and parity uint8 [B,
        parity_bytes]: (ok bool [B], data, parity, corrected int32 [B])."""
        B, dev = data.shape[0], data.device
        word = torch.cat([self._parity_bits(parity), self._data_bits(data)], dim=1)  # [B, n]
        s = self._syndromes(word)
        dirty = (s != 0).any(1)
        c, L = self._locator(s)
        pos, count = self._roots(c, L)
        found = (count == L) & (L <= self.t)
        # verify: the corrected word's syndromes, S_i + sum_k alpha^(i p_k)
        live = pos < self.n
        i = torch.arange(1, 2 * self.t + 1, device=dev)
        e = (i[None, None, :] * torch.where(live, pos, 0)[:, :, None]) % self.fs   # [B, t, 2t]
        v = torch.where(live[:, :, None], self.alog[e], 0)
        acc = s.clone()
        for k in range(self.t):
            acc = acc ^ v[:, k]
        ok_fix = dirty & found & ~(acc != 0).any(1)
        # flip the found data bits of the rows corrected
        bit = pos - self.pb
        flip = ok_fix[:, None] & live & (bit >= 0)
        byte = torch.where(flip, self.info_bytes - 1 - bit.clamp(min=0) // 8, self.info_bytes)
        mask = torch.where(flip, 1 << (bit.clamp(min=0) % 8), 0)
        delta = torch.zeros(B, self.info_bytes + 1, dtype=torch.int64, device=dev)
        delta.scatter_add_(1, byte, mask)
        out = (data.to(torch.int64) ^ delta[:, : self.info_bytes]).to(torch.uint8)
        ok = ~dirty | ok_fix
        corrected = torch.where(ok_fix, count, 0).to(torch.int32)
        return ok, out, parity, corrected


Reference = BCHReference


def control(cfg: dict, device="cpu") -> BCHReference:
    """The reference with Berlekamp's algorithm cut to t - 1 steps."""
    return BCHReference(cfg, device, bm_steps=int(cfg["correction_capability"]) - 1)
