"""Plain Reed-Solomon encode and decode, the benchmark's yardstick for the
RS cells.

A frozen, trimmed copy of the plain PyTorch RS path that the port keeps
beside its kernels (its `models/rs.py`, plain decode only, primitive
fields only), which the port's CPU tests hold bit for bit equal to the
JAX package and the C library, quirks included: the generator polynomial
and the encode matrix from the C library's LFSR (encode.c:120-144), the
syndromes, a fixed-trip Berlekamp-Massey with 8-bit degree registers,
Chien over every field point, Omega, Forney with `inv[0] = 1` and the
uint16-truncated second numerator, the syndrome re-verification and the
sequential application that stops at the first bad location
(decode.c:17-230).  It takes nothing from the program: every table is
worked out here from the configuration.

`bm_trips` bounds Berlekamp-Massey to fewer trips than the code's
2t = num_roots, which corrects at most bm_trips / 2 errors.  `control`
cuts it to half, num_roots / 2 trips, so that a codeword with more than
num_roots / 4 errors is no longer corrected (the configuration corrects
num_roots / 2): the control that breaks the configuration's guarantee.
"""

from __future__ import annotations

import numpy as np
import torch

from .gf import GF


def _bits(sym: torch.Tensor, m: int) -> torch.Tensor:
    """[..., n] symbols -> [..., n*m] int32 bits, MSB first."""
    shifts = torch.arange(m - 1, -1, -1, dtype=torch.int32, device=sym.device)
    bits = (sym.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*sym.shape[:-1], sym.shape[-1] * m)


def _symbols(bits: torch.Tensor, m: int) -> torch.Tensor:
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // m, m).to(torch.int32)
    w = 1 << torch.arange(m - 1, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * w).sum(dim=-1, dtype=torch.int32)


def _gf2_matmul(x_bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(x_bits @ mat) mod 2; exact in float32 (sums below 2^24)."""
    return (x_bits.float() @ mat).to(torch.int32) & 1


def _xor_reduce(x: torch.Tensor, m: int) -> torch.Tensor:
    shifts = torch.arange(m, dtype=torch.int32, device=x.device)
    parity = ((x.to(torch.int32)[..., None] >> shifts) & 1).sum(dim=-2) & 1
    return (parity << shifts).sum(dim=-1, dtype=torch.int32)


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _compact(values, rank, slots):
    out = torch.zeros(values.shape[0], slots + 1, dtype=values.dtype, device=values.device)
    return out.scatter_(1, rank, values)[:, :slots]


def _scatter_add(values, index, length):
    """out[:, p] = sum of values[:, t] with index[:, t] == p; indices
    outside [0, length) drop."""
    keep = (index >= 0) & (index < length)
    out = torch.zeros(values.shape[0], length + 1, dtype=torch.int32, device=values.device)
    idx = torch.where(keep, index, length).long()
    return out.scatter_add_(1, idx, values.to(torch.int32))[:, :length]


def _genpoly_log(gf: GF, fcr: int, prim: int, nr: int) -> np.ndarray:
    """prod_{i<nr} (x - alpha^((fcr+i) prim)) in log form (rs.c:59-80)."""
    fs = gf.field_size
    g = np.zeros(nr + 1, dtype=np.int64)
    g[0] = 1
    root = fcr * prim
    for i in range(nr):
        g[i + 1] = 1
        for j in range(i, 0, -1):
            if g[j] != 0:
                g[j] = g[j - 1] ^ int(gf.log2exp[(int(gf.exp2log[g[j]]) + root) % fs])
            else:
                g[j] = g[j - 1]
        g[0] = int(gf.log2exp[(int(gf.exp2log[g[0]]) + root) % fs])
        root += prim
    return gf.exp2log[g]


def _lfsr_parity(gf: GF, genlog: np.ndarray, nr: int, data: np.ndarray) -> np.ndarray:
    """The C library's systematic LFSR encode (encode.c:120-144), batched."""
    fs = gf.field_size
    genrev = genlog[nr - 1:: -1]
    parity = np.zeros((data.shape[0], nr), dtype=np.int64)
    for i in range(data.shape[1]):
        fb = gf.exp2log[(data[:, i] & fs) ^ parity[:, 0]]
        contrib = np.where((fb != fs)[:, None], gf.log2exp[(fb[:, None] + genrev) % fs], 0)
        parity = np.concatenate([parity[:, 1:], np.zeros_like(parity[:, :1])], axis=1) ^ contrib
    return parity


class RSReference:
    """Plain RS(2^m - 1, 2^m - 1 - nr) over one primitive field, on one
    torch device.  cfg: the configuration file's keys."""

    def __init__(self, cfg: dict, device="cpu", bm_trips: int | None = None):
        self.device = torch.device(device)
        self.gf = gf = GF(int(cfg["symbol_size"]), int(cfg["generator_polynomial"]))
        self.m, self.fs = gf.m, gf.field_size
        self.fcr = int(cfg["first_consecutive_root"])
        self.prim = int(cfg["primitive_element"])
        self.nr = int(cfg["num_roots"])
        self.k = self.info_bytes = self.fs - self.nr
        self.bm_trips = self.nr if bm_trips is None else bm_trips
        v, it = 1, 0                               # poporon.c:84-93
        while v % self.prim:
            v += self.fs
            it += 1
            if it > 2 * self.fs:
                raise ValueError("primitive_element has no inverse")
        self.prim_inv = v // self.prim
        self.genlog = _genpoly_log(gf, self.fcr, self.prim, self.nr)
        self._decode_tables = None
        m, nr, k = self.m, self.nr, self.k
        basis = np.zeros((k * m, k), dtype=np.int64)
        for p in range(k):
            for b in range(m):
                basis[p * m + b, p] = 1 << (m - 1 - b)
        g_enc = _bits(torch.from_numpy(_lfsr_parity(gf, self.genlog, nr, basis)), m)
        self.G_enc = g_enc.to(torch.float32).to(self.device)

    def _tables(self):
        """The decode's matrices and tables, built at the first decode."""
        if self._decode_tables is None:
            gf, fs, nr, fcr, prim = self.gf, self.fs, self.nr, self.fcr, self.prim
            L = gf.log2exp
            pos = np.arange(fs)[:, None]
            i = np.arange(nr)[None, :]
            i2 = np.arange(1, fs + 1)[None, :]
            g_syn = gf.linear_matrix(L[((fcr + i) * prim * (fs - 1 - pos)) % fs])
            m_chien = gf.linear_matrix(L[(np.arange(1, nr + 1)[:, None] * i2) % fs])
            m_omega = gf.linear_matrix(L[(np.arange(nr)[:, None] * i2) % fs])
            den = np.zeros((nr + 1, fs), dtype=np.int64)
            for j in range(1, nr + 1, 2):
                den[j] = L[((j - 1) * np.arange(1, fs + 1)) % fs]
            m_den = gf.linear_matrix(den)
            inv = np.array([1] + [L[(fs - gf.exp2log[x]) % fs] for x in range(1, fs + 1)])
            r = np.arange(fs + 1)
            sec = L[((r * (fcr - 1) + fs) % 65536) % fs]

            def f32(a):
                return torch.tensor(np.asarray(a, dtype=np.float32), device=self.device)

            def i32(a):
                return torch.tensor(np.asarray(a, dtype=np.int32), device=self.device)

            self._decode_tables = dict(
                G_syn=f32(g_syn), M_chien=f32(m_chien), M_omega=f32(m_omega),
                M_den=f32(m_den), inv=i32(inv), sec=i32(sec), log2exp=i32(gf.log2exp),
                exp2log=i32(gf.exp2log))
        return self._decode_tables

    # ------------------------------------------------------------ encode

    def encode(self, data: torch.Tensor):
        """The facade's encode of data uint8 [B, size <= k] on the device:
        (data, parity uint8 [B, nr])."""
        size = data.shape[-1]
        bits = _bits(data.to(torch.int32) & self.fs, self.m)
        return data, _symbols(_gf2_matmul(bits, self.G_enc[(self.k - size) * self.m:]),
                              self.m).to(torch.uint8)

    # ------------------------------------------------------------ decode

    def _mul(self, a, b):
        t = self._tables()
        s = t["exp2log"][a.long()] + t["exp2log"][b.long()]
        s = torch.where(s >= self.fs, s - self.fs, s)
        return torch.where((a == 0) | (b == 0), 0, t["log2exp"][s.long()])

    def _eval(self, coeffs, matrix):
        return _symbols(_gf2_matmul(_bits(coeffs, self.m), matrix), self.m)

    def _bm(self, s):
        """Fixed-trip BM (decode.c:49-96), `bm_trips` trips, degree
        registers wrapping at 256."""
        B = s.shape[0]
        el = torch.zeros(B, self.nr + 1, dtype=torch.int32, device=s.device)
        el[:, 0] = 1
        bpoly = el
        pd = torch.zeros(B, dtype=torch.int32, device=s.device)
        for it in range(1, self.bm_trips + 1):
            disc = _xor_reduce(self._mul(el[:, :it], s[:, :it].flip(1)), self.m)
            xb = _shift_right(bpoly)
            new_el = el ^ self._mul(disc[:, None], xb)
            grow = (disc != 0) & (((2 * pd) & 0xFF) <= ((it - 1) & 0xFF))
            inv = self._tables()["inv"][disc.long()]
            bpoly = torch.where(grow[:, None], self._mul(el, inv[:, None]), xb)
            pd = torch.where(grow, (it - pd) & 0xFF, pd)
            el = new_el
        return el

    def decode(self, data: torch.Tensor, parity: torch.Tensor):
        """Plain decode of data uint8 [B, size] and parity uint8 [B, nr] on
        the device: (ok bool [B], data, parity, corrected int32 [B])."""
        t = self._tables()
        B, size = data.shape
        fs, nr, m, dev = self.fs, self.nr, self.m, data.device
        pad = fs - nr - size
        word = torch.cat([data, parity], dim=1).to(torch.int32) & fs
        s = self._eval(word, t["G_syn"][pad * m:])
        has_err = (s != 0).any(dim=1)

        el = self._bm(s)
        lane = torch.arange(nr + 1, dtype=torch.int32, device=dev)
        deg = torch.where(el != 0, lane, 0).amax(dim=1)
        fail_deg = deg == 0
        root_mask = self._eval(el[:, 1:], t["M_chien"]) == 1
        i_vals = torch.arange(1, fs + 1, dtype=torch.int32, device=dev)
        cum = torch.cumsum(root_mask.to(torch.int32), dim=1)
        selected = root_mask & (cum <= deg[:, None])
        k_vals = (i_vals * self.prim_inv - 1) % fs
        fail_pad = (selected & (k_vals < pad)).any(dim=1)
        fail_count = selected.sum(dim=1) != deg

        jlane = torch.arange(nr, dtype=torch.int32, device=dev)
        jvalid = jlane < deg[:, None]
        rank = torch.where(selected, cum - 1, nr).long()
        roots = torch.where(jvalid, _compact(i_vals.expand(B, fs).contiguous(), rank, nr), 0)
        locs = torch.where(jvalid, (roots * self.prim_inv - 1) % fs, 0)

        omega = torch.zeros_like(s)                        # S * lambda mod x^nr
        for j in range(nr):
            omega[:, j:] ^= self._mul(el[:, j: j + 1], s[:, : nr - j])
        omega = torch.where(jlane <= deg[:, None] - 1, omega, 0)
        num = _compact(self._eval(omega, t["M_omega"]), rank, nr)
        den = _compact(self._eval(el, t["M_den"]), rank, nr)
        coeff = self._mul(self._mul(num, t["sec"][roots.long()]), t["inv"][den.long()])
        live = jvalid & (num != 0)
        coeff = torch.where(live, coeff, 0)
        corrected = live.sum(dim=1, dtype=torch.int32)

        corr = _scatter_add(coeff, torch.where(jvalid, locs, -1), fs)
        fail_verify = (self._eval(corr, t["G_syn"]) != s).any(dim=1)

        loc_pad = locs - pad
        in_data = (loc_pad >= 0) & (loc_pad < size) & jvalid
        in_parity = (loc_pad >= size) & (loc_pad < size + nr) & jvalid
        bad = jvalid & ~(in_data | in_parity)
        first_bad = torch.where(bad, jlane, nr).amin(dim=1)
        app = jvalid & (jlane < first_bad[:, None])
        cval = torch.where(app, coeff, 0)
        d_out = data.to(torch.int32) ^ _scatter_add(cval, torch.where(in_data & app, loc_pad, -1),
                                                    size)
        p_out = parity.to(torch.int32) ^ _scatter_add(
            cval, torch.where(in_parity & app, loc_pad - size, -1), nr)

        fail_pre = fail_deg | fail_pad | fail_count
        ok = ~(fail_pre | fail_verify | bad.any(dim=1))
        corrected = torch.where(fail_pre, 0, corrected)
        revert = (fail_pre | fail_verify)[:, None]
        d_out = torch.where(revert, data.to(torch.int32), d_out)
        p_out = torch.where(revert, parity.to(torch.int32), p_out)
        # rows with zero syndromes pass through untouched
        keep = ~has_err[:, None]
        return (torch.where(has_err, ok, True),
                torch.where(keep, data, d_out.to(torch.uint8)),
                torch.where(keep, parity, p_out.to(torch.uint8)),
                torch.where(has_err, corrected, 0))


Reference = RSReference


def control(cfg: dict, device="cpu") -> RSReference:
    """The reference with Berlekamp-Massey cut to num_roots / 2 trips."""
    return RSReference(cfg, device, bm_trips=int(cfg["num_roots"]) // 2)
