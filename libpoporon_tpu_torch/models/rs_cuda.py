"""Launcher of the hand-written CUDA RS kernels (csrc/rs_decode.cu).

Counterpart of libpoporon_tpu/models/rs_pallas.py.  Two kernels serve the
plain, erasure and external-syndrome decode paths: a syndrome kernel
(each row divided by the factors of g(x) a byte a step, from the tables of
`syndrome_tables`) and a decode kernel that starts from log-form
syndromes.  Both come in GF(2^8), symbols as bytes, and in GF(2^10)
(`WIDE_M`), symbols as 16-bit words, without the erasure form: there the
syndrome kernel is `rs_syndrome_wide_kernel` (a ten-bit step, tables from
`wide_syndrome_tables`) and the decode kernel its m = 10 instantiation.
A third, the stripe kernel, rebuilds the lost cells of shard-major
stripes (`reconstruct`) from a plan worked out on the host once a loss
pattern (`stripe_plan`); the JAX package has no counterpart.  `RSCudaDecoder` launches them on CUDA
tensors through utils/build.py `launch`, and raises if a launch fails;
it knows nothing of the codec.  models/rs.py `RSCodec` builds one for a
codec on a card inside the gate (`RSCudaDecoder.supports`); every other
codec runs the plain PyTorch version there.  The kernels take any batch
size, masking the ragged last block themselves, so no host-side padding
is needed.  `gf_tables`, `syndrome_tables`, `wide_syndrome_tables` and
`stripe_plan` make the kernels' host data, for the launcher and the tests
alike.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator

import numpy as np
import torch

from ..utils import build
from ..utils.cache import LruCache
from ..utils.profiling import span
from ..utils.tensors import checked, symbol_dtype

MODE_PLAIN, MODE_ERASURE, MODE_EXT = 0, 1, 2
MAX_ROOTS = 64       # the kernel's per-thread arrays
FS = 255             # the byte field GF(2^8), of the stripe kernel
WIDE_M = 10          # the kernels' other field: GF(2^10), symbols as 16-bit words

STRIPE_CHUNK = 256 * 16        # columns a stripe kernel's block takes at a time
SYNDROME_TILE = 256            # rows a syndrome kernel's block takes at a time


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """What the stripe kernel needs of a loss pattern (`stripe_plan`).

    fast: the erasure-only columns take the tables (where the card's
    shared memory holds them); else every column takes the
    errors-and-erasures path.  nibbles: uint32 [n - e, 2, 16], for
    survivor surv[r] and each value v of its low (0) and high (1) nibble,
    the outputs of that byte packed a byte each: the coefficients of the
    e lost cells, in the order named, then the Forney syndromes
    T_e..T_{nr-1}.  tmask covers the Forney syndromes' bytes."""

    lost: tuple[int, ...]
    surv: tuple[int, ...]
    fast: bool
    nibbles: np.ndarray
    tmask: int
    arrays: torch.Tensor | None = None   # on the card: lost, surv, nibbles (int32)
    pointers: tuple[int, ...] = ()       # their addresses


def _xor(values) -> int:
    return functools.reduce(operator.xor, values, 0)


def stripe_plan(tables: np.ndarray, nr: int, fcr: int, prim: int, prim_inv: int,
                n: int, lost: tuple[int, ...]) -> StripePlan:
    """The stripe kernel's plan for codewords of n symbols (shortened from
    255) whose symbols `lost` are erased and zero, from the kernel's GF
    tables [4, 256] (log, antilog, sec, inv).

    The decode of such a column (decode.c:17-230 as models/rs.py
    `_correct` has it, erasure form) starts BM from the erasure locator
    el, skipping the trips it <= e, so its discrepancies are the Forney
    syndromes T_r = sum_{l <= min(deg, r)} el_l S_{r-l}, r = e..nr-1.
    Where they are all zero BM changes nothing, and Chien, Forney and the
    verify see the same locator in every such column: fixed roots, and
    coefficients coef_t = num_t(S) sec[r_t] inv[den_t], linear in S.
    Both T and coef are linear in the column's bytes (S is), and are the
    outputs the tables pack, each coefficient in the slot of the lost cell
    at its root's location; a lost cell reads as zero, so its coefficient
    is its byte.  The plan is checked on the unit errors at the e lost
    cells, whose syndromes span the columns where T is zero: each must
    give T = 0 and pass the verify; a pattern where that, or Chien finding
    one root at each lost cell, or the erasure terms' 16-bit wrap leaving
    them exact, fails is not fast."""
    log, alog, sec, inv = ([int(v) for v in row] for row in np.asarray(tables))
    e, pad = len(lost), FS - n
    surv = tuple(j for j in range(n) if j not in lost)

    def mul(a, b):
        return 0 if a == 0 or b == 0 else alog[(log[a] + log[b]) % FS]

    def mul_alpha(a, x):
        return 0 if a == 0 else alog[(log[a] + x) % FS]

    def dot(row, vec):
        return _xor(mul(a, b) for a, b in zip(row, vec))

    va = [((fcr + i) * prim) % FS for i in range(nr)]
    # S_i's coefficient of symbol j
    H = [[alog[(va[i] * (n - 1 - j)) % FS] for j in range(n)] for i in range(nr)]
    # the erasure locator as locate_row builds it, wrap of erasure_term included
    raw = [prim * (n - 1 - q) for q in lost]
    el = [1] + [0] * nr
    for i, r in enumerate(raw):
        term = alog[(r & 0xFFFF) % FS]
        for j in range(min(i + 1, nr), 0, -1):
            el[j] ^= mul(term, el[j - 1])
    deg = max(j for j in range(nr + 1) if el[j])
    # Chien over every point, in scan order, as chien_sweep
    roots = [i for i in range(1, FS + 1)
             if _xor(mul_alpha(el[j], (j * i) % FS) for j in range(1, deg + 1)) == 1]
    at = {(i * prim_inv - 1) % FS - pad: i for i in roots}   # cell -> its root
    fast = (nr <= 4 and max(raw) < 1 << 16 and deg == e == len(roots)
            and sorted(at) == sorted(lost))
    if fast:     # the roots in the order the lost cells are named
        roots = [at[q] for q in lost]
    locs = [(i * prim_inv - 1) % FS for i in roots]

    # rows over S: the Forney syndromes, Omega (degree < deg), the coefficients
    forney = []
    for r in range(e, nr):
        row = [0] * nr
        for l in range(min(deg, r) + 1):
            row[r - l] ^= el[l]
        forney.append(row)
    coef = []
    if fast:
        omega = []
        for i in range(deg):
            row = [0] * nr
            for l in range(i + 1):
                row[i - l] ^= el[l]
            omega.append(row)
        for r in roots:
            num = [_xor(mul_alpha(omega[i][s], (i * r) % FS) for i in range(deg))
                   for s in range(nr)]
            den = _xor(mul_alpha(el[j], ((j - 1) * r) % FS) for j in range(1, deg + 1, 2))
            c = mul(sec[r], inv[den])
            coef.append([mul(x, c) for x in num])
        for q in lost:          # the unit error at each lost symbol
            su = [H[i][q] for i in range(nr)]
            cu = [dot(row, su) for row in coef]
            verify = [_xor(mul_alpha(cu[t], (va[i] * (FS - 1 - locs[t])) % FS)
                           for t in range(e)) for i in range(nr)]
            fast &= not any(dot(row, su) for row in forney) and verify == su

    nibbles = np.zeros((len(surv), 2, 16), dtype=np.uint32)
    if fast:
        out = [[dot(row, [H[s][j] for s in range(nr)]) for j in range(n)]
               for row in coef + forney]
        for r, j in enumerate(surv):
            for h in range(2):
                for v in range(16):
                    nibbles[r, h, v] = sum(mul(out[b][j], v << 4 * h) << 8 * b
                                           for b in range(nr))
    return StripePlan(lost=tuple(lost), surv=surv, fast=bool(fast), nibbles=nibbles,
                      tmask=sum(0xFF << 8 * b for b in range(e, min(nr, 4))))


FACTOR_ROOTS = 16    # roots of g(x) a factor: the syndrome kernel's remainders are 16 bytes
FACTOR_ENTRIES = 256 + FACTOR_ROOTS * 2 * 16   # a factor's 16-byte entries: T, then the tail


def syndrome_tables(exp2log, log2exp, nr: int, fcr: int, prim: int) -> np.ndarray:
    """The syndrome kernel's tables, uint8 [F, FACTOR_ENTRIES, 16], F =
    ceil(nr / 16), from the field's log and antilog tables.

    S_i = r(b_i), b_i = alpha^((fcr + i) prim), r(x) the row's polynomial
    (its first symbol the highest power), and g(b_i) = 0, so S_i is also
    the remainder of r modulo any multiple of x - b_i, evaluated at b_i.
    Factor f takes the roots i = 16 f .. 16 f + r_f - 1 (r_f <= 16) and
    divides by h_f(x) = x^(16 - r_f) prod (x - b_i), monic of degree 16:
    the kernel keeps r mod h_f in 16 bytes, byte b the coefficient of x^b.
    Entries 0..255 of factor f are T_f[v] = v (h_f(x) - x^16), byte b the
    coefficient of x^b: a step with top byte v adds T_f[v].  Entry
    256 + (2 b + h) 16 + u is the tail's: byte j the product of the
    nibble value u << 4h at byte b of the remainder by b_{16f+j}^b, for
    j < r_f, and zero past it; the XOR of the entries of the remainder's
    32 nibbles is S_{16f}..S_{16f+r_f-1}."""
    log = np.asarray(exp2log, dtype=np.int64)
    alog = np.asarray(log2exp, dtype=np.int64)
    fs = len(alog) - 1

    def mul(a, b):
        a, b = np.broadcast_arrays(np.asarray(a, np.int64), np.asarray(b, np.int64))
        return np.where((a == 0) | (b == 0), 0, alog[(log[a] + log[b]) % fs])

    va = [((fcr + i) * prim) % fs for i in range(nr)]
    factors = -(-nr // FACTOR_ROOTS)
    out = np.zeros((factors, FACTOR_ENTRIES, 16), dtype=np.uint8)
    for f in range(factors):
        roots = va[FACTOR_ROOTS * f:FACTOR_ROOTS * (f + 1)]
        h = np.zeros(FACTOR_ROOTS + 1, dtype=np.int64)     # ascending powers of x
        h[FACTOR_ROOTS - len(roots)] = 1
        for e in roots:                                     # h *= x + b_i
            h = np.concatenate([[0], h[:-1]]) ^ mul(h, alog[e])
        v = np.arange(256)
        out[f, :256] = mul(v[:, None], h[None, :FACTOR_ROOTS])
        u = np.arange(16)
        for b in range(FACTOR_ROOTS):
            powers = alog[[(e * b) % fs for e in roots]]    # b_i^b
            for half in range(2):
                at = 256 + (2 * b + half) * 16
                out[f, at:at + 16, :len(roots)] = mul((u << 4 * half)[:, None], powers[None, :])
    return out


def wide_syndrome_tables(exp2log, log2exp, nr: int, fcr: int, prim: int) -> np.ndarray:
    """The wide syndrome kernel's tables (m = 10) from the field's log and
    antilog tables, as bytes in the order the kernel reads them
    (rs_decode.cu `rs_syndrome_wide_kernel`).  First the half tables,
    uint32 [F, 2, 32, 5], F = ceil(nr / 16): with T_f[v] = v (h_f(x) -
    x^16), h_f as in `syndrome_tables`, entry e of half 0 is A_f[e] =
    T_f[32 e] and of half 1 B_f[e] = T_f[e], so that T_f[32 a + b] =
    A_f[a] ^ B_f[b] (T_f is GF(2)-linear in v); each entry the 16
    coefficients packed ten bits each, coefficient c at bits 10 c .. 10 c
    + 9 of its five words (word 0 the lowest).  The kernel's blocks expand
    them into lane copies in shared memory.  Then, uint16: the antilog
    table thrice over [3 * 1024], the last third zero; the log table
    [1024] with the log of zero 2 fs, so that a zero coefficient's terms
    land in that third; and va_i b mod fs [nr, 16], va_i = (fcr + i) prim
    mod fs.  The tail's S_i is then the XOR over b of antilog[log R_b +
    va_i b]."""
    log = np.asarray(exp2log, dtype=np.int64)
    alog = np.asarray(log2exp, dtype=np.int64)
    fs = len(alog) - 1
    m = fs.bit_length()

    def mul(a, b):
        a, b = np.broadcast_arrays(np.asarray(a, np.int64), np.asarray(b, np.int64))
        return np.where((a == 0) | (b == 0), 0, alog[(log[a] + log[b]) % fs])

    va = np.array([((fcr + i) * prim) % fs for i in range(nr)], dtype=np.int64)
    factors = -(-nr // FACTOR_ROOTS)
    tops = np.stack([32 * np.arange(32), np.arange(32)])             # the halves' tops
    coef = np.zeros((factors, 2, 32, FACTOR_ROOTS), dtype=np.int64)
    for f in range(factors):
        h = np.zeros(FACTOR_ROOTS + 1, dtype=np.int64)     # ascending powers of x
        roots = va[FACTOR_ROOTS * f:FACTOR_ROOTS * (f + 1)]
        h[FACTOR_ROOTS - len(roots)] = 1
        for e in roots:                                     # h *= x + b_i
            h = np.concatenate([[0], h[:-1]]) ^ mul(h, alog[e])
        coef[f] = mul(tops[:, :, None], h[None, None, :FACTOR_ROOTS])
    words = np.zeros((factors, 2, 32, m * FACTOR_ROOTS // 32), dtype=np.uint64)
    for c in range(FACTOR_ROOTS):
        q, sh = divmod(m * c, 32)
        words[..., q] |= (coef[..., c] << sh).astype(np.uint64) & 0xFFFFFFFF
        if sh + m > 32:
            words[..., q + 1] |= (coef[..., c] >> (32 - sh)).astype(np.uint64)
    alog3 = np.zeros(3 * (fs + 1), dtype=np.uint16)
    alog3[:2 * fs] = alog[np.arange(2 * fs) % fs]
    log16 = log.astype(np.uint16)
    log16[0] = 2 * fs
    expo = (va[:, None] * np.arange(FACTOR_ROOTS)[None, :]) % fs
    tail = np.concatenate([alog3, log16, expo.reshape(-1).astype(np.uint16)])
    return np.concatenate([words.astype(np.uint32).reshape(-1).view(np.uint8), tail.view(np.uint8)])


def gf_tables(rs) -> np.ndarray:
    """The kernels' GF(2^m) tables of the codec `rs` (models/rs.py
    RSCodec), int32 [4, 2^m] on the host: log, antilog, sec and inv."""
    return torch.stack([rs.exp2log, rs.log2exp, rs.sec_tbl, rs.inv_tbl]).cpu().numpy()


class RSCudaDecoder:
    """rs_decode (plain / erasure / external-syndrome) as CUDA kernels.

    A plain or erasure decode is two launches (syndromes, then decode), an
    external-syndrome decode one, a stripe decode (`reconstruct`) one.
    `launches` counts every kernel launch, `syndrome_launches` those of
    the syndrome kernel and `stripe_launches` those of the stripe kernel,
    so that a run can show that its decodes went through the kernels; a
    launcher serves one field (`m`), so its counts are that field's.
    Every entry takes CUDA tensors on the launcher's card, and raises
    ValueError for any other.  At m = 10 the erasure form and
    `reconstruct` raise ValueError (models/rs.py sends such a codec only
    plain decodes).
    """

    @staticmethod
    def supports(rs) -> bool:
        """Config gate, as rs_pallas.py's but for the field: m = 8 or 10,
        nr <= 64 and (fcr + nr) * prim < 2^15; and, past it, a primitive
        polynomial.
        The kernel's Chien steps logs (log el_j + j) and so needs a log
        table that names every nonzero element once; a polynomial whose
        powers of x miss elements (0x11B) runs the plain version, which
        the kernel disagreed with there (ROADMAP.md Queue 3, F8)."""
        return (
            rs.m in (8, WIDE_M)
            and rs.num_roots <= MAX_ROOTS
            and (rs.fcr + rs.num_roots) * rs.prim < (1 << 15)
            and rs.gf.primitive
        )

    def __init__(self, tables: np.ndarray, nr: int, k: int, fcr: int, prim: int,
                 prim_inv: int, device):
        """tables: the code's `gf_tables` [4, 2^m], m = 8 or WIDE_M; nr
        roots, k = 2^m - 1 - nr data symbols at most, fcr, prim and
        prim_inv as models/rs.py RSCodec has them; device: the card the
        kernels run on."""
        self.nr, self.k, self.fcr, self.prim, self.prim_inv = nr, k, fcr, prim, prim_inv
        self.launches = 0
        self.syndrome_launches = 0
        self.stripe_launches = 0
        self._host_tables = np.asarray(tables, dtype=np.int32)
        self.m = self._host_tables.shape[1].bit_length() - 1
        self.dtype = symbol_dtype(self.m)                            # a symbol in memory
        self.tables = torch.from_numpy(self._host_tables).to(device)   # [4, 2^m] int32
        make = syndrome_tables if self.m == 8 else wide_syndrome_tables
        # the syndrome kernel's tables: int32 [F, FACTOR_ENTRIES, 4] (syndrome_tables)
        # or the wide kernel's half tables and tail, as int32 (wide_syndrome_tables)
        self.syndrome_tables = torch.from_numpy(make(
            self._host_tables[0], self._host_tables[1], nr, fcr, prim).view(np.int32)).to(device)
        self._plans = LruCache(capacity=16)   # (n, lost) -> StripePlan, arrays on the card
        self._work = {}                       # (card, stream) -> the stripe kernel's ticket
        self._shapes = {}                     # (card, n_surv, fast, vec) -> its launch shape
        self._syndrome_shapes = {}            # card -> the syndrome kernel's launch shape
        self._decode_shapes = {}              # (card, erasure) -> the decode kernel's launch shape

    def supports_erasure(self, E: int) -> bool:
        """Erasure lists 1..nr wide ride the kernel, at m = 8."""
        return self.m == 8 and 0 < E <= self.nr

    def syndromes(self, data, parity):
        """Log-form syndromes int32 [B, nr] (fs where S_i = 0) of the rows
        data [B, size] | parity [B, nr]."""
        return self._syndromes(*self._rows(data, parity))

    def decode_plain(self, data, parity):
        return self._launch(MODE_PLAIN, data, parity)

    def decode_erasure(self, data, parity, eras_pos, eras_count):
        return self._launch(MODE_ERASURE, data, parity,
                            eras_pos=eras_pos, eras_count=eras_count)

    def decode_ext(self, data, parity, s_log):
        return self._launch(MODE_EXT, data, parity, s_log=s_log)

    def reconstruct(self, cells, lost: tuple[int, ...]):
        """The stripe decode of shard-major cells uint8 [n, L] whose cells
        `lost` (distinct indices, 1..nr of them) are lost: (ok bool [L],
        rebuilt uint8 [e, L], corrected uint8 [L], failed int32 []) as
        models/rs.py `RSCodec._reconstruct` gives them, in one launch of
        the stripe kernel."""
        with span("poporon.launch.rs_stripe"):
            if self.m != 8:
                raise ValueError(f"the stripe kernel takes bytes, not {self.m}-bit symbols")
            dev = self._card(cells)
            n, L = cells.shape
            cells = checked(cells, torch.uint8, (n, L), dev)
            plan = self._stripe_plan(n, tuple(lost))
            e = len(lost)
            rebuilt = torch.empty(e, L, dtype=torch.uint8, device=dev)
            ok = torch.empty(L, dtype=torch.bool, device=dev)
            corrected = torch.empty(L, dtype=torch.uint8, device=dev)
            if L == 0:
                return ok, rebuilt, corrected, torch.zeros((), dtype=torch.int32, device=dev)
            failed = torch.empty((), dtype=torch.int32, device=dev)
            vec = L % 16 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (cells, rebuilt, ok, corrected))
            blocks, smem, fast = self._stripe_shape(dev, len(plan.surv), plan.fast, vec)
            work = self._stripe_work(dev, blocks)
            grid = min(blocks, -(-L // STRIPE_CHUNK))
            build.launch("pp_rs_stripe", dev, cells, *plan.pointers, self.tables, rebuilt, ok,
                         corrected, failed, work, grid, smem, L, n, e, self.nr, self.fcr,
                         self.prim, self.prim_inv, int(fast), plan.tmask, int(vec))
            self.launches += 1
            self.stripe_launches += 1
            return ok, rebuilt, corrected, failed

    def _stripe_plan(self, n: int, lost: tuple[int, ...]) -> StripePlan:
        """The plan of a loss pattern with its arrays on the card, int32
        [lost, surv, nibbles] (`arrays`, `pointers` to the three), built
        once a pattern."""
        def build_plan():
            plan = stripe_plan(self._host_tables, self.nr, self.fcr, self.prim,
                               self.prim_inv, n, lost)
            flat = np.concatenate([np.asarray(plan.lost, dtype=np.int32),
                                   np.asarray(plan.surv, dtype=np.int32),
                                   plan.nibbles.reshape(-1).view(np.int32)])
            arrays = torch.from_numpy(flat).to(self.tables.device)
            base = arrays.data_ptr()
            return dataclasses.replace(
                plan, arrays=arrays, pointers=(base, base + 4 * len(lost), base + 4 * n))

        return self._plans.get_or_build((n, lost), build_plan)

    def _stripe_shape(self, dev, n_surv: int, fast: bool, vec: bool):
        """The stripe kernel's launch on `dev` for n_surv surviving cells:
        (blocks the card holds at once, dynamic shared bytes a block,
        whether the erasure-only columns take the tables), from the
        library, which sizes the shared memory and asks the occupancy
        calculator, once a shape.  Tables past the card's shared memory
        a block leave every column to the errors-and-erasures path."""
        card = dev.index or 0
        key = (card, n_surv, fast, vec)
        if key not in self._shapes:
            smem = ctypes.c_int(0)
            per_sm = build.occupancy("pp_rs_stripe_blocks_per_sm", dev, n_surv, int(fast),
                                     int(vec), card, ctypes.addressof(smem))
            if per_sm == 0 and fast:
                self._shapes[key] = self._stripe_shape(dev, n_surv, False, vec)
            elif per_sm == 0:
                raise RuntimeError(f"rs_stripe kernel: no block fits an SM at "
                                   f"{smem.value} B of shared memory")
            else:
                self._shapes[key] = (build.sm_count(card) * per_sm, smem.value, fast)
        return self._shapes[key]

    def _stripe_work(self, dev, blocks: int) -> torch.Tensor:
        """The stripe kernel's ticket and per-block counts, int32 [1 +
        blocks] at least, on the current stream of `dev`: zeroed when made,
        and left at zero by every launch, so that launches on one stream,
        which run in turn, share it."""
        key = build.stream(dev)
        if key not in self._work or self._work[key].numel() < 1 + blocks:
            self._work[key] = torch.zeros(1 + blocks, dtype=torch.int32, device=dev)
        return self._work[key]

    def _card(self, t: torch.Tensor) -> torch.device:
        """t's device, which must be the launcher's card."""
        dev = t.device
        if dev.type != "cuda" or dev != self.tables.device:
            raise ValueError(f"the RS kernels take CUDA tensors on {self.tables.device}, "
                             f"got {dev}")
        return dev

    def _rows(self, data, parity):
        """data and parity checked for the kernels: CUDA tensors on the
        launcher's card, of its symbol dtype, contiguous."""
        dev = self._card(data)
        B, size = data.shape
        if not 0 < size <= self.k:
            raise ValueError(f"size {size} outside 1..{self.k}")
        return (checked(data, self.dtype, (B, size), dev),
                checked(parity, self.dtype, (B, self.nr), dev))

    def _syndrome_shape(self, dev):
        """The syndrome kernel's launch on `dev`: (blocks the card holds at
        once, copies of T, dynamic shared bytes a block), from the library,
        which picks the copies and asks the occupancy calculator, once a
        card."""
        card = dev.index or 0
        if card not in self._syndrome_shapes:
            copies, smem = ctypes.c_int(0), ctypes.c_int(0)
            per_sm = build.occupancy("pp_rs_syndrome_shape", dev, self.m, self.nr, card,
                                     ctypes.addressof(copies), ctypes.addressof(smem))
            if per_sm == 0:
                raise RuntimeError(f"rs_syndrome kernel: no block fits an SM at "
                                   f"{smem.value} B of shared memory")
            self._syndrome_shapes[card] = (build.sm_count(card) * per_sm, copies.value,
                                           smem.value)
        return self._syndrome_shapes[card]

    def decode_shape(self, dev, erasure: bool):
        """The decode kernel's launch on `dev` (erasure: its erasure form):
        (blocks an SM holds, dynamic shared bytes a block, the shared-memory
        carveout in percent), from the library, which sets that carveout,
        the least that keeps the blocks an SM, once a card and form."""
        key = (dev.index or 0, erasure)
        if key not in self._decode_shapes:
            smem, carveout = ctypes.c_int(0), ctypes.c_int(0)
            per_sm = build.occupancy("pp_rs_decode_shape", dev, self.m, int(erasure), self.nr,
                                     key[0], ctypes.addressof(smem), ctypes.addressof(carveout))
            if per_sm == 0:
                raise RuntimeError(f"rs_decode kernel: no block fits an SM at "
                                   f"{smem.value} B of shared memory")
            self._decode_shapes[key] = (per_sm, smem.value, carveout.value)
        return self._decode_shapes[key]

    def _syndromes(self, data, parity):
        with span("poporon.launch.rs_syndrome"):
            dev = data.device
            B, size = data.shape
            s_log = torch.empty(B, self.nr, dtype=torch.int32, device=dev)
            if B == 0:
                return s_log
            blocks, copies, smem = self._syndrome_shape(dev)
            grid = min(blocks, -(-B // SYNDROME_TILE))
            build.launch("pp_rs_syndrome", dev, self.m, data, parity, self.syndrome_tables,
                         self.tables,
                         s_log, B, size, self.nr, copies, grid, smem)
        self.launches += 1
        self.syndrome_launches += 1
        return s_log

    def _launch(self, mode, data, parity, eras_pos=None, eras_count=None,
                s_log=None):
        """The decode: in plain and erasure mode the syndrome kernel, then
        the decode kernel from the syndromes."""
        with span("poporon.launch.rs_decode"):
            data, parity = self._rows(data, parity)
            dev = data.device
            B, size = data.shape
            nr = self.nr
            eras_width = 0
            if mode == MODE_ERASURE:
                eras_width = eras_pos.shape[1]
                if not self.supports_erasure(eras_width):
                    raise ValueError(f"erasure width {eras_width} outside 1..{nr}")
                eras_pos = checked(eras_pos, torch.int32, (B, eras_width), dev)
                eras_count = checked(eras_count, torch.int32, (B,), dev)
            if mode == MODE_EXT:
                s_log = checked(s_log, torch.int32, (B, nr), dev)
            else:
                s_log = self._syndromes(data, parity)

            data_out = torch.empty_like(data)
            parity_out = torch.empty_like(parity)
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            corrected = torch.empty(B, dtype=torch.int32, device=dev)
            if B == 0:
                return ok, data_out, parity_out, corrected
            self.decode_shape(dev, mode == MODE_ERASURE)
            build.launch("pp_rs_decode", dev, self.m, int(mode == MODE_ERASURE), data, parity,
                         eras_pos, eras_count, eras_width, s_log, self.tables, data_out,
                         parity_out, ok, corrected, B, size, nr, self.fcr, self.prim,
                         self.prim_inv)
            self.launches += 1
            return ok, data_out, parity_out, corrected
