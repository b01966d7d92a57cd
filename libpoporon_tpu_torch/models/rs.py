"""Reed-Solomon codec in PyTorch.

Counterpart of libpoporon_tpu/models/rs.py, and bit-identical to its XLA
path (`RSCodec._decode_plain`, `_decode_erasure`, `_decode_ext_syndrome`)
on every input.

* The host builders (generator polynomial, NumPy LFSR encode, the
  `prim_inv` trial loop, the bit matrices and the `inv`/`sec` quirk
  tables) are value-identical copies; `host_arrays` returns them by the
  JAX codec's attribute names, and `RSCodec.from_arrays` builds a codec
  from a JAX codec's arrays.
* Encode and the evaluations at every field point (syndromes, Chien,
  Omega, the formal derivative) are mod-2 matmuls against those
  matrices (ops/gf2.py).
* Data-dependent products (erasure locator, Berlekamp-Massey, Omega,
  Forney) are log/antilog index lookups (ops/gfint.py); in a field whose
  log table repeats (`GF.primitive` false, e.g. 0x11B) they, and BM's
  inverse, are the JAX package's carry-less products instead.  Root
  compaction and the scatters are plain `scatter_` / `scatter_add_`.

The decode functions here are the plain version of the CUDA kernels
(models/rs_cuda.py).  A codec decides once, when it is built, which of
the two it runs: a codec on a card whose config the kernels support
(`RSCudaDecoder.supports`) builds their launcher (`kernel`) and sends
every decode and `reconstruct` through it, erasure lists past its width
excepted; every other codec, and every codec on the CPU, has `kernel`
None and runs these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RSConfig
from ..ops.gf import GF, GFError
from ..ops.gf2 import gf2_matmul
from ..ops.gfint import gf_inv_clmul, gf_mul, gf_mul_clmul
from ..utils.cache import LruCache
from ..utils.profiling import span
from ..utils.tensors import as_symbols, as_tensor, symbol_dtype
from .rs_cuda import RSCudaDecoder, gf_tables

# The arrays a codec is built from, by the JAX codec's attribute names
# (`gf.log2exp` and `gf.exp2log` there).
ARRAY_NAMES = ("G_enc", "G_syn", "M_chien", "M_omega", "M_den", "inv_tbl",
               "sec_tbl", "alpha_tbl", "log2exp", "exp2log", "genlog")


def _symbols_to_bits_np(sym: np.ndarray, m: int) -> np.ndarray:
    """[..., n] symbols -> [..., n*m] bits, MSB-first within each symbol."""
    shifts = np.arange(m - 1, -1, -1)
    bits = (sym[..., :, None] >> shifts) & 1
    return bits.reshape(*sym.shape[:-1], sym.shape[-1] * m).astype(np.uint8)


def _build_genpoly(gf: GF, fcr: int, prim: int, num_roots: int) -> np.ndarray:
    """Generator polynomial prod_{i<nr}(x - alpha^{(fcr+i)*prim}), returned
    in LOG form (reference rs.c:59-80)."""
    fs = gf.field_size
    g = np.zeros(num_roots + 1, dtype=np.int64)
    g[0] = 1
    root = fcr * prim
    for i in range(num_roots):
        g[i + 1] = 1
        for j in range(i, 0, -1):
            if g[j] != 0:
                g[j] = g[j - 1] ^ int(
                    gf.log2exp[(int(gf.exp2log[g[j]]) + root) % fs]
                )
            else:
                g[j] = g[j - 1]
        g[0] = int(gf.log2exp[(int(gf.exp2log[g[0]]) + root) % fs])
        root += prim
    return gf.exp2log[g].astype(np.int64)  # log form; sentinel fs for zero coeffs


def _encode_np(gf: GF, genlog: np.ndarray, num_roots: int, data: np.ndarray,
               parity: np.ndarray | None = None) -> np.ndarray:
    """Batched NumPy systematic LFSR — value-identical to encode.c:120-144,
    from the all-zero register, or from `parity` [B, nr] where given.
    Derives the encode bit-matrix, and is an independent encode reference."""
    fs = gf.field_size
    log2exp = gf.log2exp.astype(np.int64)
    exp2log = gf.exp2log.astype(np.int64)
    B, size = data.shape
    genrev = genlog[num_roots - 1 :: -1].copy()  # genrev[l] = genlog[nr-1-l]
    if parity is None:
        parity = np.zeros((B, num_roots), dtype=np.int64)
    for i in range(size):
        fb = exp2log[(data[:, i] & fs) ^ parity[:, 0]]
        valid = (fb != fs)[:, None]
        contrib = np.where(valid, log2exp[(fb[:, None] + genrev[None, :]) % fs], 0)
        shifted = np.concatenate(
            [parity[:, 1:], np.zeros((B, 1), dtype=np.int64)], axis=1
        )
        parity = shifted ^ contrib
    return parity


def _basis_parity(gf: GF, genlog: np.ndarray, nr: int, k: int) -> np.ndarray:
    """`_encode_np` of the k*m unit words, [k*m, nr]: row p*m + b the parity
    of the word whose only nonzero symbol is 2^(m-1-b) at position p.  The
    register stays zero through leading zero symbols, so that row is the
    register after that one symbol, then k-1-p zero symbols: the same
    steps, run once for every position instead of once a row."""
    m = gf.symbol_size
    state = _encode_np(gf, genlog, nr, (1 << np.arange(m - 1, -1, -1))[:, None])   # [m, nr]
    zero = np.zeros((m, 1), dtype=np.int64)
    out = np.empty((k, m, nr), dtype=np.int64)
    for p in range(k - 1, -1, -1):
        out[p] = state
        state = _encode_np(gf, genlog, nr, zero, state)
    return out.reshape(k * m, nr)


def _prim_inverse(prim: int, fs: int) -> int:
    """Primitive-element inverse by the reference's trial loop
    (poporon.c:84-93)."""
    v, it = 1, 0
    while v % prim != 0:
        v += fs
        it += 1
        if it > fs * 2:
            raise GFError("primitive_element has no inverse")
    return v // prim


def _build_matrices(gf: GF, fcr: int, prim: int, nr: int, genlog: np.ndarray):
    m, fs = gf.symbol_size, gf.field_size
    k = fs - nr
    # Encode matrix: parity response of every data-bit basis vector,
    # obtained by running the (NumPy) LFSR — captures encode.c exactly.
    parity = _basis_parity(gf, genlog, nr, k)                 # [k*m, nr]
    g_enc = _symbols_to_bits_np(parity, m)                    # [k*m, nr*m]

    # Syndrome matrix: S_i = sum_j r_j alpha^{(fcr+i)*prim*(fs-1-j)}
    # over the full-length (zero-padded) word (decode.c:375-415).
    pos = np.arange(fs, dtype=np.int64)[:, None]              # j
    i = np.arange(nr, dtype=np.int64)[None, :]
    expnt = ((fcr + i) * prim * (fs - 1 - pos)) % fs
    g_syn = gf.linear_matrix(gf.log2exp[expnt])               # [fs*m, nr*m]

    # Chien evaluation matrix: terms(i) = sum_{j>=1} lam_j alpha^{j*i},
    # i = 1..fs (decode.c:115-141).
    j = np.arange(1, nr + 1, dtype=np.int64)[:, None]
    i2 = np.arange(1, fs + 1, dtype=np.int64)[None, :]
    m_chien = gf.linear_matrix(gf.log2exp[(j * i2) % fs])     # [nr*m, fs*m]

    # Omega evaluation: num_j = sum_i Omega_i alpha^{i*root_j}
    # (decode.c:160-169) at all root points r = 1..fs.
    ji = np.arange(nr, dtype=np.int64)[:, None]
    m_omega = gf.linear_matrix(gf.log2exp[(ji * i2) % fs])    # [nr*m, fs*m]

    # Denominator (formal derivative): sum_{even i} lam_{i+1}
    # alpha^{i*r} (decode.c:179-185) — rows for odd lambda indices.
    den_consts = np.zeros((nr + 1, fs), dtype=np.int64)
    for jj in range(1, nr + 1, 2):  # lambda_j with j odd, exponent (j-1)*r
        den_consts[jj] = gf.log2exp[((jj - 1) * np.arange(1, fs + 1)) % fs]
    m_den = gf.linear_matrix(den_consts)                      # [(nr+1)*m, fs*m]

    # inverse table with the reference's zero-denominator quirk:
    # den == 0 contributes alpha^{fs - exp2log[0]} = alpha^0 = 1
    # (decode.c:187-189 with the sentinel).
    inv_tbl = np.zeros(fs + 1, dtype=np.int64)
    inv_tbl[0] = 1
    for x in range(1, fs + 1):
        inv_tbl[x] = gf.log2exp[(fs - int(gf.exp2log[x])) % fs]

    # second-numerator by Chien root index r (decode.c:175-176):
    # alpha^{((r*(fcr-1) + fs) mod 2^16) mod fs} — int arithmetic then
    # uint16 truncation, matching the C.
    r = np.arange(fs + 1, dtype=np.int64)
    sec_arg = ((r * (fcr - 1) + fs) % 65536) % fs
    sec_tbl = gf.log2exp[sec_arg]

    alpha_tbl = gf.log2exp[np.arange(fs, dtype=np.int64)]
    return dict(G_enc=g_enc, G_syn=g_syn, M_chien=m_chien, M_omega=m_omega,
                M_den=m_den, inv_tbl=inv_tbl, sec_tbl=sec_tbl,
                alpha_tbl=alpha_tbl)


_ARRAY_CACHE = LruCache(capacity=16)


def host_arrays(cfg: RSConfig) -> dict[str, np.ndarray]:
    """Every host-built array of the codec for `cfg`, keyed by
    ARRAY_NAMES.  Cached; treat the arrays as read-only."""
    key = (cfg.symbol_size, cfg.generator_polynomial,
           cfg.first_consecutive_root, cfg.primitive_element, cfg.num_roots)

    def build():
        gf = GF(cfg.symbol_size, cfg.generator_polynomial)
        fcr, prim = int(cfg.first_consecutive_root), int(cfg.primitive_element)
        nr = int(cfg.num_roots)
        genlog = _build_genpoly(gf, fcr, prim, nr)
        arrays = _build_matrices(gf, fcr, prim, nr, genlog)
        arrays.update(log2exp=gf.log2exp, exp2log=gf.exp2log, genlog=genlog)
        return arrays

    return _ARRAY_CACHE.get_or_build(key, build)


# ------------------------------------------------------- tensor helpers


def _symbols_to_bits(sym: torch.Tensor, m: int) -> torch.Tensor:
    """[..., n] int symbols -> [..., n*m] int32 bits, MSB-first."""
    shifts = torch.arange(m - 1, -1, -1, dtype=torch.int32, device=sym.device)
    bits = (sym.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*sym.shape[:-1], sym.shape[-1] * m)


def _bits_to_symbols(bits: torch.Tensor, m: int) -> torch.Tensor:
    n = bits.shape[-1] // m
    b = bits.reshape(*bits.shape[:-1], n, m).to(torch.int32)
    weights = 1 << torch.arange(m - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    return (b * weights).sum(dim=-1, dtype=torch.int32)


def _xor_reduce(x: torch.Tensor, m: int) -> torch.Tensor:
    """XOR over the last axis of m-bit ints: per-bit parity of the sum."""
    shifts = torch.arange(m, dtype=torch.int32, device=x.device)
    parity = ((x.to(torch.int32)[..., None] >> shifts) & 1).sum(dim=-2) & 1
    return (parity << shifts).sum(dim=-1, dtype=torch.int32)


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """Coefficients times x: out[:, j] = x[:, j-1], out[:, 0] = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _compact(values: torch.Tensor, rank: torch.Tensor, slots: int) -> torch.Tensor:
    """out[:, t] = values[:, p] where rank[:, p] == t (0 where no p has
    rank t).  rank == slots drops the entry; ranks below slots are
    distinct within a row."""
    out = torch.zeros(values.shape[0], slots + 1, dtype=values.dtype,
                      device=values.device)
    return out.scatter_(1, rank, values)[:, :slots]


def _scatter_add(values: torch.Tensor, index: torch.Tensor, length: int) -> torch.Tensor:
    """out[:, p] = SUM of values[:, t] over t with index[:, t] == p; an
    index outside [0, length) drops.  The sum (not XOR) is the JAX
    package's `scatter_mod2` placement, kept where slots can collide."""
    keep = (index >= 0) & (index < length)
    out = torch.zeros(values.shape[0], length + 1, dtype=torch.int32,
                      device=values.device)
    idx = torch.where(keep, index, length).long()
    return out.scatter_add_(1, idx, values.to(torch.int32))[:, :length]


class RSCodec:
    """Batched Reed-Solomon over GF(2^m), m <= 16, on one torch device, the
    card by default.  Symbols are bytes for m <= 8 and 16-bit words
    (`symbol_dtype`, int16 read as unsigned) past it, in and out.  Past
    m = 8 the codec encodes and runs the plain decode only: erasure and
    external-syndrome decodes and `reconstruct` raise ValueError there."""

    def __init__(self, cfg: RSConfig, device: str | torch.device = "cuda",
                 arrays: dict[str, np.ndarray] | None = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        gf = GF(cfg.symbol_size, cfg.generator_polynomial)
        if cfg.primitive_element == 0:
            raise GFError("primitive_element must be nonzero (poporon.c:78-82)")
        self.device = device
        self.gf = gf
        self.m = gf.symbol_size
        self.fs = gf.field_size
        self.symbol_dtype = symbol_dtype(self.m)
        self.fcr = int(cfg.first_consecutive_root)
        self.prim = int(cfg.primitive_element)
        self.num_roots = int(cfg.num_roots)
        self.k = self.fs - self.num_roots  # max data symbols
        if self.k <= 0:
            raise GFError("num_roots >= field size")
        if self.num_roots < 1:
            # the JAX package fails here with an IndexError in its builders
            raise GFError("num_roots must be >= 1")
        self.prim_inv = _prim_inverse(self.prim, self.fs)

        if arrays is None:
            arrays = host_arrays(cfg)
        self.genlog = np.asarray(arrays["genlog"], dtype=np.int64)

        def f32(name):
            return torch.tensor(np.asarray(arrays[name], dtype=np.float32),
                                device=device)

        def i32(name):
            return torch.tensor(np.asarray(arrays[name], dtype=np.int32),
                                device=device)

        self.G_enc = f32("G_enc")        # [k*m, nr*m]
        self.G_syn = f32("G_syn")        # [fs*m, nr*m]
        self.M_chien = f32("M_chien")    # [nr*m, fs*m]
        self.M_omega = f32("M_omega")    # [nr*m, fs*m]
        self.M_den = f32("M_den")        # [(nr+1)*m, fs*m]
        self.inv_tbl = i32("inv_tbl")    # [fs+1], inv[0] = 1
        self.sec_tbl = i32("sec_tbl")    # [fs+1], by Chien root index
        self.alpha_tbl = i32("alpha_tbl")  # [fs]
        self.log2exp = i32("log2exp")    # [fs+1], log2exp[fs] = 0
        self.exp2log = i32("exp2log")    # [fs+1], exp2log[0] = fs

        # The kernels' launcher: on a card, for configs the kernels support.
        self.kernel = None
        if device.type == "cuda" and RSCudaDecoder.supports(self):
            self.kernel = RSCudaDecoder(gf_tables(self), self.num_roots, self.k, self.fcr,
                                        self.prim, self.prim_inv, device)

    @classmethod
    def from_arrays(cls, cfg: RSConfig, arrays: dict[str, np.ndarray],
                    device: str | torch.device = "cuda") -> "RSCodec":
        """A codec built from given arrays (ARRAY_NAMES), e.g. a JAX
        codec's, taken with np.asarray."""
        return cls(cfg, device, arrays)

    def _bytes_only(self, what: str) -> None:
        """ValueError naming `what` where the symbols are wider than a byte."""
        if self.m > 8:
            raise ValueError(f"{what} takes symbols of at most 8 bits; this code's are "
                             f"{self.m} (only encode and the plain decode run past m = 8)")

    # ----------------------------------------------------------- encode

    def encode(self, data) -> torch.Tensor:
        """data: symbols [B, size] (or [size]) -> parity [B, nr], both in
        `symbol_dtype`."""
        data = as_symbols(data, self.m, self.device)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
        size = data.shape[-1]
        if size > self.k:
            raise ValueError(f"size {size} exceeds k={self.k}")
        bits = _symbols_to_bits(data.to(torch.int32) & self.fs, self.m)
        pbits = gf2_matmul(bits, self.G_enc[(self.k - size) * self.m:])
        out = _bits_to_symbols(pbits, self.m).to(self.symbol_dtype)
        return out[0] if squeeze else out

    # ------------------------------------------------------ decode core

    def _gf_mul(self, a, b):
        if self.gf.primitive:
            return gf_mul(a, b, self.exp2log, self.log2exp)
        return gf_mul_clmul(a, b, self.m, self.gf.generator_polynomial)

    def _gf_inv(self, a):
        """The inverse of a nonzero a (BM's discrepancy)."""
        if self.gf.primitive:
            return self.inv_tbl[a.long()]
        return gf_inv_clmul(a, self.m, self.gf.generator_polynomial)

    def _syndrome(self, data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
        """Normal-domain syndromes [B, nr] int32 of the shortened word."""
        m, fs = self.m, self.fs
        pad = fs - self.num_roots - data.shape[-1]
        word = torch.cat([data, parity], dim=1).to(torch.int32) & fs
        return _bits_to_symbols(
            gf2_matmul(_symbols_to_bits(word, m), self.G_syn[pad * m:]), m)

    def _eval_at_all_points(self, coeffs: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        """coeffs [B, C] -> values [B, fs] at every field point."""
        bits = _symbols_to_bits(coeffs, self.m)
        return _bits_to_symbols(gf2_matmul(bits, matrix), self.m)

    def _erasure_locator(self, eras_pos, eras_count, pad):
        """Erasure-locator product (decode.c:34-47): [B, nr+1] int32."""
        B, E = eras_pos.shape
        fs, nr = self.fs, self.num_roots
        # term_i = alpha^{(prim*(fs-1-(pos+pad)) mod 2^16) mod fs}, in
        # wrapping int32 arithmetic as in the JAX package
        raw = self.prim * (fs - 1 - (eras_pos + pad))
        terms = self.alpha_tbl[((raw & 0xFFFF) % fs).long()]          # [B, E]
        el = torch.zeros(B, nr + 1, dtype=torch.int32, device=self.device)
        el[:, 0] = 1
        if E > 0:
            el[:, 1] = torch.where(eras_count > 0, terms[:, 0], 0)
        lane = torch.arange(nr + 1, device=self.device)
        for i in range(1, E):
            contrib = self._gf_mul(terms[:, i : i + 1], _shift_right(el))
            mask = (i < eras_count)[:, None] & (lane >= 1) & (lane <= i + 1)
            el = el ^ torch.where(mask, contrib, 0)
        return el

    def _berlekamp_massey(self, s, el0, eras_count):
        """Fixed-trip BM (decode.c:49-96): nr trips, branchless.

        eras_count None means no erasures (the start degree is then 0 and
        no trip is skipped).  The degree L and it + ec live in 8-bit
        registers in the JAX package's bit-sliced BM, so they wrap at 256
        here as well.  Returns the error locator [B, nr+1] int32.
        """
        nr = self.num_roots
        if eras_count is None:
            ec = torch.zeros(s.shape[0], dtype=torch.int32, device=self.device)
        else:
            ec = eras_count & 0xFF
        el, bpoly, pd = el0, el0, ec
        for it in range(1, nr + 1):
            # discrepancy: XOR_{j < it} el_j * S_{it-1-j}
            disc = _xor_reduce(self._gf_mul(el[:, :it], s[:, :it].flip(1)), self.m)
            xb = _shift_right(bpoly)
            new_el = el ^ self._gf_mul(disc[:, None], xb)
            it_ec = (it + ec) & 0xFF
            grow = (disc != 0) & (((2 * pd) & 0xFF) <= ((it_ec - 1) & 0xFF))
            b_grow = self._gf_mul(el, self._gf_inv(disc)[:, None])
            new_b = torch.where(grow[:, None], b_grow, xb)
            new_pd = torch.where(grow, (it_ec - pd) & 0xFF, pd)
            # trips it <= ec are skipped (the C loop starts at r = ec + 1)
            act = (it > ec)[:, None]
            el = torch.where(act, new_el, el)
            bpoly = torch.where(act, new_b, bpoly)
            pd = torch.where(act[:, 0], new_pd, pd)
        return el

    def _omega(self, el, s):
        """Omega = S * lambda mod x^nr (decode.c:147-158): [B, nr]."""
        nr = self.num_roots
        acc = torch.zeros_like(s)
        for j in range(nr):
            prod = self._gf_mul(el[:, j : j + 1], s[:, : nr - j])
            acc[:, j:] ^= prod
        return acc

    def _correct(self, data, parity, s, eras_pos, eras_count, pad, at_locations=False):
        """error_correction_u8 (decode.c:17-230), batched.

        eras_pos None selects the plain / external-syndrome form (no
        erasure locator, corrections at the Chien locations); otherwise
        the erasure form (corrections at the caller's positions, or, with
        at_locations, at the Chien locations as in the plain form).
        Returns (ok [B] bool, data, parity, corrected [B] int32).
        """
        B, size = data.shape
        fs, nr = self.fs, self.num_roots
        dev = self.device
        erasure = eras_pos is not None

        if erasure:
            el0 = self._erasure_locator(eras_pos, eras_count, pad)
        else:
            el0 = torch.zeros(B, nr + 1, dtype=torch.int32, device=dev)
            el0[:, 0] = 1
        el = self._berlekamp_massey(s, el0, eras_count if erasure else None)

        lane = torch.arange(nr + 1, dtype=torch.int32, device=dev)
        deg = torch.where(el != 0, lane, 0).amax(dim=1)                # [B]
        fail_deg = deg == 0

        # --- Chien: roots at alpha^i, i = 1..fs, in scan order ---
        terms = self._eval_at_all_points(el[:, 1:], self.M_chien)      # [B, fs]
        root_mask = terms == 1
        i_vals = torch.arange(1, fs + 1, dtype=torch.int32, device=dev)
        cum = torch.cumsum(root_mask.to(torch.int32), dim=1)
        selected = root_mask & (cum <= deg[:, None])
        found = selected.sum(dim=1)
        k_vals = (i_vals * self.prim_inv - 1) % fs
        fail_pad = (selected & (k_vals < pad)).any(dim=1)
        fail_count = found != deg

        jlane = torch.arange(nr, dtype=torch.int32, device=dev)
        jvalid = jlane < deg[:, None]
        rank = torch.where(selected, cum - 1, nr).long()
        roots = _compact(i_vals.expand(B, fs).contiguous(), rank, nr)
        roots = torch.where(jvalid, roots, 0)
        locs = torch.where(jvalid, (roots * self.prim_inv - 1) % fs, 0)

        # --- Omega masked to degree < deg, Forney (decode.c:160-191) ---
        omega = torch.where(jlane <= deg[:, None] - 1, self._omega(el, s), 0)
        numerator = _compact(self._eval_at_all_points(omega, self.M_omega), rank, nr)
        denominator = _compact(self._eval_at_all_points(el, self.M_den), rank, nr)
        coeff = self._gf_mul(
            self._gf_mul(numerator, self.sec_tbl[roots.long()]),
            self.inv_tbl[denominator.long()],
        )
        live = jvalid & (numerator != 0)
        coeff = torch.where(live, coeff, 0)
        corrected = live.sum(dim=1, dtype=torch.int32)

        # --- syndrome re-verification (decode.c:193-209) ---
        corr_vec = _scatter_add(coeff, torch.where(jvalid, locs, -1), fs)
        v = _bits_to_symbols(
            gf2_matmul(_symbols_to_bits(corr_vec, self.m), self.G_syn), self.m)
        fail_verify = (v != s).any(dim=1)

        # --- apply corrections ---
        if erasure and not at_locations:
            # decode.c:211-214: coeff_j at the caller's j-th erasure
            # position, data region only.  Slots past E read position 0
            # (masked only by jvalid), as in the XLA path.
            E = eras_pos.shape[1]
            posj = torch.zeros(B, nr, dtype=torch.int32, device=dev)
            posj[:, : min(E, nr)] = eras_pos[:, :nr]
            posj = torch.where(jvalid, posj, -1)
            data_out = data.to(torch.int32) ^ _scatter_add(coeff, posj, size)
            parity_out = parity.to(torch.int32)
            fail_apply = torch.zeros(B, dtype=torch.bool, device=dev)
        else:
            loc_pad = locs - pad
            in_data = (loc_pad >= 0) & (loc_pad < size) & jvalid
            in_parity = (loc_pad >= size) & (loc_pad < size + nr) & jvalid
            bad = jvalid & ~(in_data | in_parity)
            fail_apply = bad.any(dim=1)
            # the C applies sequentially and stops at the first bad location
            first_bad = torch.where(bad, jlane, nr).amin(dim=1)
            app = jvalid & (jlane < first_bad[:, None])
            cval = torch.where(app, coeff, 0)
            dvec = _scatter_add(cval, torch.where(in_data & app, loc_pad, -1), size)
            pvec = _scatter_add(
                cval, torch.where(in_parity & app, loc_pad - size, -1), nr)
            data_out = data.to(torch.int32) ^ dvec
            parity_out = parity.to(torch.int32) ^ pvec

        fail_pre = fail_deg | fail_pad | fail_count
        ok = ~(fail_pre | fail_verify | fail_apply)
        corrected = torch.where(fail_pre, 0, corrected)
        # any failure leaves the word untouched, except the partial
        # application that `app` already encodes for fail_apply
        revert = (fail_pre | fail_verify)[:, None]
        data_out = torch.where(revert, data.to(torch.int32), data_out)
        parity_out = torch.where(revert, parity.to(torch.int32), parity_out)
        return ok, data_out.to(self.symbol_dtype), parity_out.to(self.symbol_dtype), corrected

    # ------------------------------------------------------ decode paths

    def _finish(self, has_err, data, parity, ok_c, d, p, corr):
        ok = torch.where(has_err, ok_c, True)
        keep = ~has_err[:, None]
        d = torch.where(keep, data, d)
        p = torch.where(keep, parity, p)
        corr = torch.where(has_err, corr, 0)
        return ok, d, p, corr

    def _decode_plain(self, data, parity):
        pad = self.fs - self.num_roots - data.shape[-1]
        s = self._syndrome(data, parity)
        has_err = (s != 0).any(dim=1)
        out = self._correct(data, parity, s, None, None, pad)
        return self._finish(has_err, data, parity, *out)

    def _decode_erasure(self, data, parity, eras_pos, eras_count):
        pad = self.fs - self.num_roots - data.shape[-1]
        s = self._syndrome(data, parity)
        has_err = (s != 0).any(dim=1)
        out = self._correct(data, parity, s, eras_pos, eras_count, pad)
        return self._finish(has_err, data, parity, *out)

    def _decode_ext_syndrome(self, data, parity, s_log):
        """External log-form syndromes (decode.c:446-464): sentinel fs =
        "no error"; a log outside [0, fs] reads as zero."""
        fs = self.fs
        pad = fs - self.num_roots - data.shape[-1]
        has_err = (s_log != fs).any(dim=1)
        in_range = (s_log >= 0) & (s_log <= fs)
        s = torch.where(in_range, self.log2exp[s_log.clamp(0, fs).long()], 0)
        out = self._correct(data, parity, s, None, None, pad)
        return self._finish(has_err, data, parity, *out)

    def _reconstruct(self, cells, lost):
        """The stripe decode's plain version: the rows of cells.T with the
        lost cells zeroed, through the erasure decode with `lost` as every
        row's erasures (`_decode_erasure`), its corrections applied at
        their locations."""
        n, L = cells.shape
        k, dev = n - self.num_roots, cells.device
        idx = torch.tensor(lost, dtype=torch.long, device=dev)
        words = cells.t().contiguous()              # [L, n], a codeword a row
        words[:, idx] = 0
        data, parity = words[:, :k], words[:, k:]
        pos = idx.to(torch.int32)[None].expand(L, len(lost))
        cnt = torch.full((L,), len(lost), dtype=torch.int32, device=dev)
        s = self._syndrome(data, parity)
        out = self._correct(data, parity, s, pos, cnt, self.fs - n, at_locations=True)
        ok, data, parity, corrected = self._finish((s != 0).any(dim=1), data, parity, *out)
        rebuilt = torch.cat([data, parity], dim=1)[:, idx].t().contiguous()
        return ok, rebuilt, corrected.to(torch.uint8), (~ok).sum(dtype=torch.int32)

    def reconstruct(self, cells, lost):
        """Rebuild lost cells of shard-major stripes.

        cells: uint8 [n, L], byte t of each cell one codeword (column t):
        the first n - nr cells data, the last nr parity, nr < n <= fs.
        lost: 1..nr distinct cell indices, the same in every column; the
        contents of those cells are ignored (read as zero).  Moved to the
        codec's device.

        Returns (ok bool [L], rebuilt uint8 [e, L] in `lost`'s order,
        corrected uint8 [L], failed int32 [], the columns not ok): column
        for column the ok and the count of `decode(cells[:k, t],
        cells[k:, t], erasures=lost)` with the lost cells zeroed, and the
        lost cells' bytes of the codeword that decode finds, data and
        parity cells alike, each correction at its own location: the
        cells' true bytes wherever the survivors hold at most
        (nr - e) / 2 errors.  A column that is not ok comes back as given,
        its lost cells zero; so does one whose syndromes are zero, whose
        lost cells are zero indeed.  (The row decode's erasure form puts
        its t-th correction on the t-th erasure named, data cells only,
        decode.c:211-214; here each lands where its root says.)  One
        launch of the stripe kernel on the card.
        """
        with span("poporon.codec.reconstruct"):
            self._bytes_only("reconstruct")
            cells = as_tensor(cells, torch.uint8, self.device)
            if cells.ndim != 2:
                raise ValueError(f"cells must be [n, L], got {tuple(cells.shape)}")
            n = cells.shape[0]
            if not self.num_roots < n <= self.fs:
                raise ValueError(f"{n} cells: a codeword of {self.num_roots} roots "
                                 f"needs {self.num_roots + 1}..{self.fs}")
            lost = tuple(int(x) for x in lost)
            if not 0 < len(lost) <= self.num_roots or len(set(lost)) != len(lost) \
                    or not all(0 <= x < n for x in lost):
                raise ValueError(f"lost must be 1..{self.num_roots} distinct cells of "
                                 f"0..{n - 1}, got {lost}")
            if self.kernel is not None:
                return self.kernel.reconstruct(cells, lost)
            return self._reconstruct(cells, lost)

    def decode(self, data, parity, erasures=None, ext_syndrome=None):
        """Batched decode.

        data [B, size] / [size]; parity [B, nr] / [nr]: symbols, moved to
        the codec's device in `symbol_dtype`.
        erasures: optional (positions [B, E], counts [B]) int32 arrays, or
        a 1-D position list broadcast over the batch.
        ext_syndrome: optional log-form syndromes [B, nr] (sentinel fs =
        "no error"), the external-syndrome path of decode.c:446-464.
        Both for m <= 8 only (ValueError past it).

        Returns (ok [B] bool, data, parity, corrected [B] int32).
        """
        with span("poporon.codec.decode"):
            if erasures is not None:
                self._bytes_only("an erasure decode")
            if ext_syndrome is not None:
                self._bytes_only("an external-syndrome decode")
            data = as_symbols(data, self.m, self.device)
            parity = as_symbols(parity, self.m, self.device)
            squeeze = data.ndim == 1
            if squeeze:
                data = data[None]
                parity = parity[None]
            B, size = data.shape
            pad = self.fs - self.num_roots - size
            if pad < 0 or pad >= self.fs - self.num_roots:
                z = torch.zeros(B, dtype=torch.int32, device=self.device)
                out = (torch.zeros(B, dtype=torch.bool, device=self.device),
                       data, parity, z)
                return tuple(o[0] for o in out) if squeeze else out
            if parity.shape[-1] != self.num_roots:
                # the C reads num_roots parity bytes; the JAX package raises
                # here too, where the widths fail to meet in its matmuls
                raise ValueError(f"parity must be {self.num_roots} bytes, got {parity.shape[-1]}")

            kern = self.kernel
            if ext_syndrome is not None:
                s = as_tensor(ext_syndrome, torch.int32, self.device)
                if s.ndim == 1:
                    s = s[None].expand(B, self.num_roots)
                if kern is not None:
                    out = kern.decode_ext(data, parity, s)
                else:
                    out = self._decode_ext_syndrome(data, parity, s)
            elif erasures is not None:
                if isinstance(erasures, tuple):
                    pos, cnt = erasures
                    pos = as_tensor(pos, torch.int32, self.device)
                    cnt = as_tensor(cnt, torch.int32, self.device)
                else:
                    pos = as_tensor(erasures, torch.int32, self.device)
                    if pos.ndim == 1:
                        pos = pos[None].expand(B, pos.shape[0])
                    cnt = torch.full((B,), pos.shape[1], dtype=torch.int32,
                                     device=self.device)
                if kern is not None and kern.supports_erasure(pos.shape[1]):
                    out = kern.decode_erasure(data, parity, pos, cnt)
                else:
                    out = self._decode_erasure(data, parity, pos, cnt)
            elif kern is not None:
                out = kern.decode_plain(data, parity)
            else:
                out = self._decode_plain(data, parity)
            if squeeze:
                return tuple(o[0] for o in out)
            return out
