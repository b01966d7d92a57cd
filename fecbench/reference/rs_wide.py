"""Plain Reed-Solomon encode and decode over GF(2^m), m <= 16, the
benchmark's yardstick for RS cells whose symbols are wider than a byte.

Written from the C library's row decode (decode.c:17-230, as the port's
docstrings cite it) on the field's log and antilog tables alone, with no
bit matrix: the encoder divides by g(x) in the C library's LFSR
(encode.c:120-144); the decoder takes the syndromes by Horner's rule
(S_i = r(b_i), b_i = alpha^((fcr + i) prim), a product table of each b_i
a step), Berlekamp-Massey in nr fixed trips with the C's 8-bit degree
registers, Chien over every point alpha^i, i = 1..fs, in scan order (the
first deg roots, a root whose location lies in the shortened word's pad
or fewer roots than the degree failing the row), Omega, Forney with
inv[0] = 1 and the second numerator's uint16-truncated exponent (sec),
the verify (the syndromes of the corrections equal S) and the
application in order, stopping at the first location outside the word.
A row that fails is left as given, its count kept where only the verify
or the application failed.  It takes nothing from the program or from
the other references but the field's tables (reference/gf.py); at m = 8
it equals reference/rs.py row for row.

Symbols are uint8 for m <= 8 and int16 (read as unsigned) past it, as the
port holds them; a symbol's bits past m are ignored.  `k` is the data
symbols a codeword of the configuration (its `data_symbols`, else the
unshortened fs - nr).

`bm_trips` bounds Berlekamp-Massey to fewer trips than num_roots;
`control` cuts it to half, the guarantee the configuration gives (t =
num_roots / 2 errors corrected) broken.  `LowByte` decodes every symbol
cut to its low byte, what a codec that stores symbols as bytes does.
"""

from __future__ import annotations

import numpy as np
import torch

from .gf import GF


def _genpoly_log(gf: GF, fcr: int, prim: int, nr: int) -> np.ndarray:
    """prod_{i<nr} (x - alpha^((fcr+i) prim)) in log form, highest power
    first as the C library builds it (rs.c:59-80)."""
    fs = gf.field_size
    g = np.zeros(nr + 1, dtype=np.int64)
    g[0] = 1
    root = fcr * prim
    for i in range(nr):
        g[i + 1] = 1
        for j in range(i, 0, -1):
            g[j] = g[j - 1] ^ (gf.mul(int(g[j]), int(gf.log2exp[root % fs])) if g[j] else 0)
        g[0] = gf.mul(int(g[0]), int(gf.log2exp[root % fs]))
        root += prim
    return gf.exp2log[g]


class RSWideReference:
    """Plain RS over one primitive field GF(2^m), m <= 16, on one torch
    device.  cfg: the configuration file's keys."""

    def __init__(self, cfg: dict, device="cpu", bm_trips: int | None = None):
        self.device = dev = torch.device(device)
        self.gf = gf = GF(int(cfg["symbol_size"]), int(cfg["generator_polynomial"]))
        self.m, self.fs = gf.m, gf.field_size
        self.fcr = int(cfg["first_consecutive_root"])
        self.prim = int(cfg["primitive_element"])
        self.nr = int(cfg["num_roots"])
        self.k = int(cfg.get("data_symbols", self.fs - self.nr))
        self.info_bytes = self.k
        self.symbol_dtype = torch.uint8 if self.m <= 8 else torch.int16
        self.bm_trips = self.nr if bm_trips is None else bm_trips
        v, it = 1, 0                               # poporon.c:84-93
        while v % self.prim:
            v += self.fs
            it += 1
            if it > 2 * self.fs:
                raise ValueError("primitive_element has no inverse")
        self.prim_inv = v // self.prim
        fs, nr = self.fs, self.nr
        self.genrev = torch.tensor(_genpoly_log(gf, self.fcr, self.prim, nr)[nr - 1:: -1].copy(),
                                   device=dev)
        self.log = torch.tensor(gf.exp2log, device=dev)        # log[0] = fs
        self.alog = torch.tensor(gf.log2exp, device=dev)       # alog[fs] = 0
        L = gf.log2exp
        self.inv = torch.tensor([1] + [int(L[(fs - gf.exp2log[x]) % fs]) for x in range(1, fs + 1)],
                                device=dev)
        r = np.arange(fs + 1)
        self.sec = torch.tensor(L[((r * (self.fcr - 1) + fs) % 65536) % fs], device=dev)
        self.va = torch.tensor([((self.fcr + i) * self.prim) % fs for i in range(nr)], device=dev)
        # row i: x * b_i for every x, flattened, for Horner's steps
        x = torch.arange(fs + 1, device=dev)
        self.mul_b = self._mul_alpha(x[None, :], self.va[:, None]).reshape(-1)
        self.mul_b_base = torch.arange(nr, device=dev) * (fs + 1)

    # ------------------------------------------------------------ field

    def _mul(self, a, b):
        s = (self.log[a] + self.log[b]) % self.fs
        return torch.where((a == 0) | (b == 0), 0, self.alog[s])

    def _mul_alpha(self, a, e):
        """a * alpha^e, e >= 0."""
        return torch.where(a == 0, 0, self.alog[(self.log[a] + e) % self.fs])

    @staticmethod
    def _xor_sum(x, dim):
        out = torch.zeros_like(x.select(dim, 0))
        for t in x.unbind(dim):
            out ^= t
        return out

    # ------------------------------------------------------------ encode

    def encode(self, data: torch.Tensor):
        """The systematic encode of data [B, size <= fs - nr] symbols on the
        device: (data, parity [B, nr]) in `symbol_dtype`."""
        fs = self.fs
        d = data.to(torch.int64) & fs
        parity = torch.zeros(d.shape[0], self.nr, dtype=torch.int64, device=d.device)
        zero = parity[:, :1]
        for i in range(d.shape[1]):
            fb = self.log[d[:, i] ^ parity[:, 0]]
            contrib = torch.where((fb != fs)[:, None], self.alog[(fb[:, None] + self.genrev) % fs], 0)
            parity = torch.cat([parity[:, 1:], zero], dim=1) ^ contrib
        return data, parity.to(self.symbol_dtype)

    # ------------------------------------------------------------ decode

    def syndromes(self, word: torch.Tensor) -> torch.Tensor:
        """S [B, nr] of the rows `word` [B, n] (int64 symbols), by Horner."""
        s = torch.zeros(word.shape[0], self.nr, dtype=torch.int64, device=word.device)
        for j in range(word.shape[1]):
            s = self.mul_b[s + self.mul_b_base] ^ word[:, j: j + 1]
        return s

    def _bm(self, s):
        """Fixed-trip BM (decode.c:49-96), `bm_trips` trips, the degree
        registers 8 bits wide: the error locator [B, nr + 1]."""
        B, nr = s.shape
        el = torch.zeros(B, nr + 1, dtype=torch.int64, device=s.device)
        el[:, 0] = 1
        bpoly = el
        pd = torch.zeros(B, dtype=torch.int64, device=s.device)
        for it in range(1, self.bm_trips + 1):
            disc = self._xor_sum(self._mul(el[:, :it], s[:, :it].flip(1)), 1)
            xb = torch.cat([torch.zeros_like(bpoly[:, :1]), bpoly[:, :-1]], dim=1)
            new_el = el ^ self._mul(disc[:, None], xb)
            grow = (disc != 0) & (((2 * pd) & 0xFF) <= ((it - 1) & 0xFF))
            bpoly = torch.where(grow[:, None], self._mul(el, self.inv[disc][:, None]), xb)
            pd = torch.where(grow, (it - pd) & 0xFF, pd)
            el = new_el
        return el

    def decode(self, data: torch.Tensor, parity: torch.Tensor):
        """Plain decode of data [B, size] and parity [B, nr] symbols on the
        device: (ok bool [B], data, parity, corrected int32 [B])."""
        B, size = data.shape
        fs, nr, dev = self.fs, self.nr, data.device
        pad = fs - nr - size
        word = torch.cat([data, parity], dim=1).to(torch.int64) & fs
        s = self.syndromes(word)
        has_err = (s != 0).any(dim=1)

        el = self._bm(s)
        lane = torch.arange(nr + 1, device=dev)
        deg = torch.where(el != 0, lane, 0).amax(dim=1)
        fail_deg = deg == 0

        # Chien: el(alpha^i) = 0 where the terms j >= 1 sum to el_0 = 1
        i_vals = torch.arange(1, fs + 1, device=dev)
        terms = torch.zeros(B, fs, dtype=torch.int64, device=dev)
        for j in range(1, nr + 1):
            terms ^= self._mul_alpha(el[:, j: j + 1], (j * i_vals) % fs)
        root_mask = terms == 1
        del terms
        cum = torch.cumsum(root_mask.to(torch.int64), dim=1)
        selected = root_mask & (cum <= deg[:, None])
        k_vals = (i_vals * self.prim_inv - 1) % fs
        fail_pad = (selected & (k_vals < pad)).any(dim=1)
        fail_count = selected.sum(dim=1) != deg

        jlane = torch.arange(nr, device=dev)
        jvalid = jlane < deg[:, None]
        rank = torch.where(selected, cum - 1, nr)
        roots = torch.zeros(B, nr + 1, dtype=torch.int64, device=dev)
        roots = roots.scatter_(1, rank, i_vals.expand(B, fs).contiguous())[:, :nr]
        roots = torch.where(jvalid, roots, 0)
        locs = torch.where(jvalid, (roots * self.prim_inv - 1) % fs, 0)

        # Omega = S el mod x^nr, of degree below deg; Forney
        omega = torch.zeros_like(s)
        for j in range(nr):
            omega[:, j:] ^= self._mul(el[:, j: j + 1], s[:, : nr - j])
        omega = torch.where(jlane <= deg[:, None] - 1, omega, 0)
        num = torch.zeros_like(roots)
        for i in range(nr):
            num ^= self._mul_alpha(omega[:, i: i + 1], (i * roots) % fs)
        den = torch.zeros_like(roots)
        for j in range(1, nr + 1, 2):
            den ^= self._mul_alpha(el[:, j: j + 1], ((j - 1) * roots) % fs)
        coef = self._mul(self._mul(num, self.sec[roots]), self.inv[den])
        live = jvalid & (num != 0)
        coef = torch.where(live, coef, 0)
        corrected = live.sum(dim=1, dtype=torch.int32)

        # verify: the syndromes of the corrections, at their locations
        expo = (self.va[None, None, :] * (fs - 1 - locs)[:, :, None]) % fs      # [B, t, i]
        v = self._xor_sum(self._mul_alpha(coef[:, :, None], expo), 1)
        fail_verify = (v != s).any(dim=1)

        # apply in order, up to the first location outside the word
        loc_pad = locs - pad
        in_data = (loc_pad >= 0) & (loc_pad < size) & jvalid
        in_parity = (loc_pad >= size) & (loc_pad < size + nr) & jvalid
        bad = jvalid & ~(in_data | in_parity)
        first_bad = torch.where(bad, jlane, nr).amin(dim=1)
        app = jvalid & (jlane < first_bad[:, None])
        cval = torch.where(app, coef, 0)

        def place(at, length):
            out = torch.zeros(B, length + 1, dtype=torch.int64, device=dev)
            return out.scatter_add_(1, torch.where(at >= 0, at, length), cval)[:, :length]

        d_out = data.to(torch.int64) ^ place(torch.where(in_data & app, loc_pad, -1), size)
        p_out = parity.to(torch.int64) ^ place(torch.where(in_parity & app, loc_pad - size, -1), nr)

        fail_pre = fail_deg | fail_pad | fail_count
        ok = ~(fail_pre | fail_verify | bad.any(dim=1))
        corrected = torch.where(fail_pre, 0, corrected)
        revert = (fail_pre | fail_verify | ~has_err)[:, None]
        d_out = torch.where(revert, data.to(torch.int64), d_out).to(data.dtype)
        p_out = torch.where(revert, parity.to(torch.int64), p_out).to(parity.dtype)
        return (torch.where(has_err, ok, True), d_out, p_out, torch.where(has_err, corrected, 0))


Reference = RSWideReference


class LowByte(RSWideReference):
    """The reference decoding each symbol cut to its low byte, as a codec
    that holds symbols in bytes would: a control."""

    def decode(self, data, parity):
        return super().decode(data & 0xFF, parity & 0xFF)


def control(cfg: dict, device="cpu") -> RSWideReference:
    """The reference with Berlekamp-Massey cut to num_roots / 2 trips."""
    return RSWideReference(cfg, device, bm_trips=int(cfg["num_roots"]) // 2)


def control_low_byte(cfg: dict, device="cpu") -> RSWideReference:
    """The reference on symbols cut to their low byte."""
    return LowByte(cfg, device)
