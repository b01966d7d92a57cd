"""Plain Reed-Solomon erasure decode of shard-major stripes, the
benchmark's yardstick for the stripe cells (the facade's
`Codec.reconstruct`).

cells are uint8 [n, L]: byte t of each of the n cells is a symbol of
codeword t (column t), n - nr data cells and nr parity cells, a code
shortened from 2^m - 1.  The cells `lost` are erased in every column;
their contents are ignored and read as zero.  `decode(cells, lost)`
decodes every column as libpoporon's errors-and-erasures decode does
(decode.c:17-230, erasure form, as the port's CPU path has it), and
gives each column's verdict, the bytes of the lost cells in the codeword
it finds, and the count of corrections:

1. the syndromes S_i = sum_j r_j alpha^{((fcr + i) prim mod fs)(n-1-j)};
   a column whose syndromes are all zero comes back as given: ok, the
   lost cells zero, nothing corrected;
2. the erasure locator, the product of (1 + X_q x) over the lost cells in
   the order named, X_q = alpha^{(prim (n-1-q) mod 2^16) mod fs};
3. Berlekamp-Massey from it, nr trips of which the first e are skipped,
   its degree registers 8 bits wide;
4. Chien over all fs points, the first deg roots in scan order, their
   locations (root prim_inv - 1) mod fs; fewer than deg roots, or a
   location in the shortened-away part, fails the column;
5. Omega = S * locator mod x^nr below the degree, Forney's coefficients
   num sec[root] inv[den] with inv[0] = 1;
6. the verify: the syndromes of the corrections, XORed at their
   locations, must equal S, else the column fails, untouched;
7. the apply: each coefficient at its location, so that a lost cell,
   data or parity, holds its own; a lost cell is zero, so that is its
   byte, its true byte wherever the survivors hold at most (nr - e) / 2
   errors.

It takes nothing from the program: every table is worked out here from
the configuration, and the encoder is `rs.py`'s.  Steps 1 to 6 keep the
port's quirks; departures from the C library, which holds one codeword
at a time, are these:

- the apply (step 7) is the C library's plain form, at the roots'
  locations; its erasure form puts the t-th coefficient on the t-th
  erasure named (position 0 past the e named) and only into data cells,
  which would leave a lost parity cell zero and, on a column with errors
  besides the erasures, put coefficients on cells not theirs;
- the columns of a block are decoded together, and Chien (with the
  denominators of Forney, which depend on nothing else) runs once for
  each distinct locator of the block: a column's result depends on its
  locator only through those;
- the verify XORs the corrections of the roots, where the port's plain
  path sums them at their locations; the two differ only where two roots
  share a location, which a primitive element coprime to fs rules out.

The control does not cut Berlekamp-Massey as rs.py's does.  The columns
this cell sends hold no errors besides the erasures (HDFS checks every
chunk's CRC and treats a bad one as lost), so every discrepancy is zero
and a cut in BM changes no answer.  `control` breaks the configuration's
precision instead: it decodes in GF(2^7) (polynomial 0x89), the field one
bit narrower than the configuration's 8-bit symbols.
"""

from __future__ import annotations

import torch

from .gf import GF
from .rs import RSReference

COLUMNS = 1 << 22        # columns a block of the decode
CHIEN_ROWS = 1 << 18     # distinct locators a block of Chien


class StripeReference:
    """Plain erasure decode of shard-major cells over one field, on one
    torch device.  cfg: the configuration file's keys; `data_cells` gives
    the stripe's data cells."""

    def __init__(self, cfg: dict, device="cpu"):
        self.device = torch.device(device)
        self.cfg = cfg
        self.gf = gf = GF(int(cfg["symbol_size"]), int(cfg["generator_polynomial"]))
        self.fs = gf.field_size
        self.fcr = int(cfg["first_consecutive_root"])
        self.prim = int(cfg["primitive_element"])
        self.nr = int(cfg["num_roots"])
        self.k = int(cfg["data_cells"])
        self.n = self.k + self.nr
        v, it = 1, 0                               # poporon.c:84-93
        while v % self.prim:
            v += self.fs
            it += 1
            if it > 2 * self.fs:
                raise ValueError("primitive_element has no inverse")
        self.prim_inv = v // self.prim
        fs = self.fs
        log = torch.tensor(gf.exp2log, dtype=torch.int64, device=self.device)
        alog = torch.tensor(gf.log2exp, dtype=torch.int64, device=self.device)
        self.log, self.alog = log, alog
        self.inv = torch.cat([torch.ones(1, dtype=torch.int64, device=self.device),
                              alog[(fs - log[1:]) % fs]])
        r = torch.arange(fs + 1, device=self.device)
        self.sec = alog[((r * (self.fcr - 1) + fs) % 65536) % fs]
        self._encoder = None

    # ------------------------------------------------------------ encode

    def encode(self, info: torch.Tensor) -> torch.Tensor:
        """Shard-major cells uint8 [n, L] of the data cells info uint8
        [k, L]: rs.py's encoder, column block by column block."""
        if self._encoder is None:
            self._encoder = RSReference(self.cfg, self.device)
        k, L = info.shape
        cells = torch.empty(self.n, L, dtype=torch.uint8, device=info.device)
        cells[:k] = info
        for c in range(0, L, COLUMNS):
            block = info[:, c: c + COLUMNS].t()
            cells[k:, c: c + COLUMNS] = self._encoder.encode(block)[1].t()
        return cells

    # ------------------------------------------------------------ decode

    def _mul(self, a, b):
        """Products of field elements (int64 tensors, broadcast)."""
        s = self.log[a] + self.log[b]
        return torch.where((a == 0) | (b == 0), 0, self.alog[s % self.fs])

    def _mul_alpha(self, a, x):
        """a alpha^x, x >= 0 (int64 tensors, broadcast)."""
        return torch.where(a == 0, 0, self.alog[(self.log[a] + x) % self.fs])

    def _locator(self, lost):
        """The erasure locator, nr + 1 coefficients (decode.c:34-47)."""
        fs, nr, n = self.fs, self.nr, self.n
        el = [1] + [0] * nr
        for i, q in enumerate(lost):
            term = int(self.gf.log2exp[((self.prim * (n - 1 - q)) & 0xFFFF) % fs])
            for j in range(min(i + 1, nr), 0, -1):
                el[j] ^= self.gf.mul(term, el[j - 1])
        return el

    def _chien(self, el: torch.Tensor, deg: torch.Tensor):
        """Roots int64 [U, nr] (0 past the found ones), found [U] and the
        denominators [U, nr] of locators el [U, nr + 1] of degree deg."""
        fs, nr = self.fs, self.nr
        i = torch.arange(1, fs + 1, device=el.device)
        ev = torch.zeros(el.shape[0], fs, dtype=torch.int64, device=el.device)
        for j in range(1, nr + 1):
            ev ^= self._mul_alpha(el[:, j: j + 1], (j * i) % fs)
        hit = ev == 1
        rank = torch.cumsum(hit, dim=1)
        hit &= rank <= deg[:, None]
        roots = torch.stack([torch.where(hit & (rank == t + 1), i, 0).amax(dim=1)
                             for t in range(nr)], dim=1)
        den = torch.zeros_like(roots)
        for j in range(1, nr + 1, 2):
            den ^= self._mul_alpha(el[:, j: j + 1], ((j - 1) * roots) % fs)
        return roots, hit.sum(dim=1), den

    def _decode_block(self, r: torch.Tensor, lost, el0):
        """The decode of the columns r int64 [n, B] (lost cells zero)."""
        fs, nr, n, e = self.fs, self.nr, self.n, len(lost)
        B, dev = r.shape[1], r.device
        pad = fs - n
        va = [((self.fcr + i) * self.prim) % fs for i in range(nr)]

        # 1. syndromes
        S = torch.zeros(nr, B, dtype=torch.int64, device=dev)
        for j in range(n):
            if j in lost:
                continue
            for i in range(nr):
                S[i] ^= self._mul_alpha(r[j], (va[i] * (n - 1 - j)) % fs)
        has_err = (S != 0).any(dim=0)

        # 2, 3. BM from the erasure locator; trips it <= ec skipped
        el = torch.tensor(el0, dtype=torch.int64, device=dev)[:, None].repeat(1, B)
        bp = el.clone()
        ec = e & 0xFF
        pd = torch.full((B,), ec, dtype=torch.int64, device=dev)
        for it in range(1, nr + 1):
            if it <= ec:
                continue
            disc = torch.zeros(B, dtype=torch.int64, device=dev)
            for j in range(it):
                disc ^= self._mul(el[j], S[it - 1 - j])
            xb = torch.cat([torch.zeros_like(bp[:1]), bp[:-1]])
            new_el = el ^ self._mul(disc[None], xb)
            it_ec = (it + ec) & 0xFF
            grow = (disc != 0) & (((2 * pd) & 0xFF) <= ((it_ec - 1) & 0xFF))
            bp = torch.where(grow[None], self._mul(el, self.inv[disc][None]), xb)
            pd = torch.where(grow, (it_ec - pd) & 0xFF, pd)
            el = new_el
        lane = torch.arange(nr + 1, device=dev)[:, None]
        deg = torch.where(el != 0, lane, 0).amax(dim=0)

        # 4. Chien (and Forney's denominators) once a distinct locator
        if nr < 7:      # a locator's coefficients as one key
            shift = 8 * torch.arange(nr + 1, device=dev)[:, None]
            keys, back = torch.unique((el << shift).sum(dim=0), return_inverse=True)
            uniq = (keys[:, None] >> shift.t()) & 0xFF
        else:
            uniq, back = torch.unique(el.t(), dim=0, return_inverse=True)
        udeg = torch.where(uniq != 0, lane.t(), 0).amax(dim=1)
        parts = [self._chien(uniq[u: u + CHIEN_ROWS], udeg[u: u + CHIEN_ROWS])
                 for u in range(0, uniq.shape[0], CHIEN_ROWS)]
        roots, found, den = (torch.cat(p)[back] for p in zip(*parts))
        tlane = torch.arange(nr, device=dev)
        valid = tlane[None] < deg[:, None]                   # [B, nr]
        locs = (roots * self.prim_inv - 1) % fs
        fail_pad = (valid & (tlane[None] < found[:, None]) & (locs < pad)).any(dim=1)
        fail_pre = (deg == 0) | fail_pad | (found != deg)

        # 5. Omega below the degree, Forney
        num = torch.zeros(B, nr, dtype=torch.int64, device=dev)
        for i in range(nr):
            om = torch.zeros(B, dtype=torch.int64, device=dev)
            for l in range(i + 1):
                om ^= self._mul(el[l], S[i - l])
            om = torch.where(deg > i, om, 0)
            num ^= self._mul_alpha(om[:, None], (i * roots) % fs)
        coef = self._mul(self._mul(num, self.sec[roots]), self.inv[den])
        live = valid & (num != 0)
        coef = torch.where(live, coef, 0)
        corrected = torch.where(fail_pre, 0, live.sum(dim=1))

        # 6. verify
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(nr):
            v = torch.zeros(B, dtype=torch.int64, device=dev)
            for t in range(nr):
                v ^= torch.where(valid[:, t], self._mul_alpha(coef[:, t], (va[i] * (fs - 1 - locs[:, t])) % fs), 0)
            bad |= v != S[i]

        # 7. apply, at the roots' locations; a failed column stays as given
        keep = fail_pre | bad
        rebuilt = torch.zeros(e, B, dtype=torch.int64, device=dev)
        for u, q in enumerate(lost):
            for t in range(nr):
                rebuilt[u] ^= torch.where(valid[:, t] & (locs[:, t] == q + pad), coef[:, t], 0)
        rebuilt = torch.where(keep[None] | ~has_err[None], 0, rebuilt)
        ok = torch.where(has_err, ~keep, True)
        corrected = torch.where(has_err, corrected, 0)
        return ok, rebuilt.to(torch.uint8), corrected.to(torch.uint8)

    def decode(self, cells: torch.Tensor, lost):
        """The decode of every column of cells uint8 [n, L] with the cells
        `lost` erased: (ok bool [L], rebuilt uint8 [e, L] in lost's order,
        an empty parity, corrected uint8 [L])."""
        lost = [int(q) for q in lost]
        n, L = cells.shape
        if n != self.n:
            raise ValueError(f"{n} cells, the configuration has {self.n}")
        el0 = self._locator(lost)
        parts = []
        for c in range(0, L, COLUMNS):
            r = cells[:, c: c + COLUMNS].to(torch.int64) & self.fs
            r[lost] = 0
            parts.append(self._decode_block(r, lost, el0))
        ok, rebuilt, corrected = (torch.cat(p, dim=-1) for p in zip(*parts))
        return ok, rebuilt, torch.zeros(0, dtype=torch.uint8, device=cells.device), corrected


Reference = StripeReference


def control(cfg: dict, device="cpu") -> StripeReference:
    """The reference one bit narrower: symbols of GF(2^7) (0x89) in place
    of the configuration's GF(2^8)."""
    return StripeReference({**cfg, "symbol_size": 7, "generator_polynomial": 0x89}, device)
