"""Binary BCH codec in PyTorch.

Counterpart of libpoporon_tpu/models/bch.py, and bit-identical to it on
every input: ok flags, codeword bits and words, error counts and bytes.
The JAX package runs BCH through XLA with no Pallas kernel, so the plain
version here is plain PyTorch ops on whatever device the codec lives on.

* The host builders (minimal polynomials, the generator as the LCM over
  the conjugacy classes of alpha^1..alpha^2t, the encoder's remainders
  and the matrices `R_enc`, `G_syn`, `M_chien`, `inv_tbl`) give the JAX
  codec's values; `host_arrays` returns them by the JAX codec's
  attribute names, and `BCHCodec.from_arrays` builds a codec from a JAX
  codec's arrays.
* Encode, syndromes and the Chien search are mod-2 matmuls against those
  matrices (ops/gf2.py).
* Berlekamp-Massey runs the JAX package's fixed 2t trips on 64 locator
  lanes, with branchless selects; its GF products are log/antilog lookups
  (ops/gfint.py), which equal the JAX carry-less products for every
  element of a field with a primitive polynomial (`_field` rejects any
  other), and its per-row shift of the b polynomial is one gather.

A config's `data_length` shortens the code: the word is then
parity_bits + data_length bits, its missing high data bits zero, and
Chien searches the word's own positions only, so a locator root in the
pad finds fewer roots than the locator's degree and the row fails (as
Linux's lib/bch.c returns -EBADMSG for an error beyond the data).
`data_length` 0 is the full length, 2^m - 1 - deg g, as in the JAX
package.

Codewords are LSB-first bit tensors [B, n] (bit j is the coefficient of
x^j; bits[:parity_bits] are the parity, bits[parity_bits:] the data),
defined for every m in [3, 16]; the int32 word API is an adapter for
n <= 31, and the byte layer packs big-endian bytes as the C facade does.

The decode of bytes (`decode_bytes`, the facade's) is chosen once, when
the codec is built: a codec on a card whose config the CUDA kernel
supports (models/bch_cuda.py `BCHCudaDecoder.supports`: shortened codes
of whole data bytes) holds its launcher (`kernel`) and decodes the
stored bytes in one launch, with no bit tensor; every other codec, and
every codec on the CPU, has `kernel` None and packs the bytes into bits
for the plain version.  A codec with the kernel never falls back to the
plain version: rows of another width than the kernel takes raise
ValueError.  `G_syn` and `M_chien`, which only the plain
version reads, are built when it first runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BchConfig
from ..ops.gf import GF, GFError
from ..ops.gf2 import gf2_matmul
from ..ops.gfint import gf_mul
from ..utils.cache import LruCache
from ..utils.profiling import span
from ..utils.tensors import as_tensor
from .bch_cuda import BCHCudaDecoder, bch_tables
from .rs import _bits_to_symbols, _symbols_to_bits, _xor_reduce

_BCH_MAX_POLY = 64
_BCH_MAX_T = 16

# The arrays a codec is built from, by the JAX codec's attribute names
# (`gf.log2exp` and `gf.exp2log` there).
ARRAY_NAMES = ("R_enc", "G_syn", "M_chien", "inv_tbl", "log2exp", "exp2log")


def _field(cfg: BchConfig) -> GF:
    """The config's field, after the JAX package's range checks.

    GF's check (the powers of x wrap back to 1 after fs steps) passes a
    polynomial whose root's order divides fs without being fs, such as
    0x1F for m = 4; its log table then repeats, and the JAX package,
    which multiplies carry-less, computes other products than these
    lookups.  So a field whose powers of x miss an element is rejected
    here (ROADMAP.md Queue 3, F8).
    """
    if cfg.symbol_size < 3 or cfg.symbol_size > 16:
        raise GFError("BCH symbol_size must be in [3, 16] (bch.c:293)")
    if not (1 <= cfg.correction_capability <= _BCH_MAX_T):
        raise GFError("BCH t must be in [1, 16] (bch.c:297)")
    if cfg.data_length < 0:
        raise GFError(f"BCH data_length must be 0 (full length) or positive, "
                      f"got {cfg.data_length}")
    gf = GF(cfg.symbol_size, cfg.generator_polynomial)
    if not gf.primitive:
        raise GFError(f"generator polynomial {cfg.generator_polynomial:#x} is not "
                      f"primitive over GF(2^{cfg.symbol_size})")
    return gf


def _min_poly(gf: GF, exp: int) -> int:
    """Binary minimal polynomial of alpha^exp (bch.c:168-207)."""
    fs = gf.field_size
    poly = [0] * _BCH_MAX_POLY
    poly[0] = 1
    deg = 0
    conj = exp
    while True:
        root = int(gf.log2exp[conj])
        for j in range(deg, -1, -1):
            if j + 1 < _BCH_MAX_POLY:
                poly[j + 1] ^= poly[j]
            if poly[j] != 0 and root != 0:
                lp = (int(gf.exp2log[poly[j]]) + int(gf.exp2log[root])) % fs
                poly[j] = int(gf.log2exp[lp])
            else:
                poly[j] = 0
        deg += 1
        conj = (conj * 2) % fs
        if conj == exp:
            break
    out = 0
    for i in range(deg + 1):
        if poly[i] == 1:
            out |= 1 << i
    return out


def _generator(gf: GF, t: int) -> int:
    """LCM of the minimal polynomials of alpha^1..alpha^2t, one per
    conjugacy class (bch.c:241-286), as a binary polynomial."""
    fs = gf.field_size
    used = [False] * (fs + 1)
    gen = 1
    for i in range(1, 2 * t + 1):
        r = i % fs
        if used[r]:
            continue
        c = r
        while True:
            used[c] = True
            c = (c * 2) % fs
            if c == r:
                break
        mp = _min_poly(gf, r)
        acc, a, sh = 0, gen, 0
        while a:                       # carry-less product gen * mp
            if a & 1:
                acc ^= mp << sh
            a >>= 1
            sh += 1
        gen = acc
    return gen


def _data_length(cfg: BchConfig, fs: int, gen: int) -> int:
    """The config's data bits a codeword: its `data_length`, or the full
    fs - deg g where that is 0; GFError past the full length."""
    full = fs - (gen.bit_length() - 1)
    if cfg.data_length > full:
        raise GFError(f"BCH data_length {cfg.data_length} exceeds the full length {full}")
    return int(cfg.data_length) or full


def _remainders(gen: int, count: int) -> np.ndarray:
    """uint8 [count, deg]: row i the LSB-first bits of x^(deg + i) mod
    gen, the parity of the data word whose only set bit is bit i (the
    systematic encoder's remainder, bch.c:352-380).  Each row is the
    last one times x, reduced once: a shift and at most one XOR."""
    deg = gen.bit_length() - 1
    nbytes = (deg + 7) // 8
    out = bytearray()
    r = gen ^ (1 << deg)                      # x^deg mod gen
    for _ in range(count):
        out += r.to_bytes(nbytes, "little")
        r <<= 1
        if r >> deg & 1:
            r ^= gen
    bits = np.unpackbits(np.frombuffer(bytes(out), dtype=np.uint8).reshape(count, nbytes),
                         axis=1, bitorder="little")
    return np.ascontiguousarray(bits[:, :deg])


def _encoder_arrays(gf: GF, gen: int, data_length: int) -> dict[str, np.ndarray]:
    """R_enc [data_length, deg] and inv_tbl [fs + 1] (inv[0] = 0)."""
    fs = gf.field_size
    inv = np.zeros(fs + 1, dtype=np.int64)
    log = gf.exp2log[1:].astype(np.int64)
    inv[1:] = gf.log2exp[(fs - log) % fs]
    return dict(R_enc=_remainders(gen, data_length), inv_tbl=inv)


def _decoder_matrices(gf: GF, t: int, n: int) -> dict[str, np.ndarray]:
    """G_syn [n, 2t m] and M_chien [64 m, n m] for words of n bits."""
    fs = gf.field_size
    # Syndromes: S_i ^= alpha^{((i+1) j) % fs} for each set bit j
    j = np.arange(n, dtype=np.int32)[:, None]
    i = np.arange(2 * t, dtype=np.int32)[None, :]
    g_syn = gf.linear_matrix_bits_in(gf.log2exp[((i + 1) * j) % fs])      # [n, 2t m]

    # Chien: the locator at x = alpha^{(fs - i) % fs}, i = 0..n-1, so
    # term_{c,i} = lambda_c alpha^{(c (fs - i)) % fs}
    c = np.arange(_BCH_MAX_POLY, dtype=np.int32)[:, None]
    ii = np.arange(n, dtype=np.int32)[None, :]
    logx = (fs - ii) % fs
    m_chien = gf.linear_matrix(gf.log2exp[(c * logx) % fs % fs])          # [64 m, n m]
    return dict(G_syn=g_syn, M_chien=m_chien)


_ARRAY_CACHE = LruCache(capacity=16)


def _key(cfg: BchConfig) -> tuple:
    return (cfg.symbol_size, cfg.generator_polynomial, cfg.correction_capability,
            cfg.data_length)


def _encoder_host_arrays(cfg: BchConfig) -> dict[str, np.ndarray]:
    """R_enc, inv_tbl, log2exp and exp2log of `cfg`.  Cached."""
    def build():
        gf = _field(cfg)
        gen = _generator(gf, int(cfg.correction_capability))
        arrays = _encoder_arrays(gf, gen, _data_length(cfg, gf.field_size, gen))
        arrays.update(log2exp=gf.log2exp, exp2log=gf.exp2log)
        return arrays

    return _ARRAY_CACHE.get_or_build(("encoder", *_key(cfg)), build)


def _decoder_host_arrays(cfg: BchConfig) -> dict[str, np.ndarray]:
    """G_syn and M_chien of `cfg`, for the plain decode.  Cached."""
    def build():
        gf = _field(cfg)
        t = int(cfg.correction_capability)
        gen = _generator(gf, t)
        n = gen.bit_length() - 1 + _data_length(cfg, gf.field_size, gen)
        return _decoder_matrices(gf, t, n)

    return _ARRAY_CACHE.get_or_build(("decoder", *_key(cfg)), build)


def host_arrays(cfg: BchConfig) -> dict[str, np.ndarray]:
    """Every host-built array of the codec for `cfg`, keyed by
    ARRAY_NAMES.  Cached; treat the arrays as read-only."""
    return {**_encoder_host_arrays(cfg), **_decoder_host_arrays(cfg)}


class BCHCodec:
    """Batched binary BCH over GF(2^m) on one torch device, the card by
    default."""

    def __init__(self, cfg: BchConfig, device: str | torch.device = "cuda",
                 arrays: dict[str, np.ndarray] | None = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        gf = _field(cfg)
        self.cfg = cfg
        self.device = device
        self.gf = gf
        self.m = gf.symbol_size
        self.fs = gf.field_size
        self.t = int(cfg.correction_capability)
        self.gen_poly = _generator(gf, self.t)
        self.gen_poly_deg = self.gen_poly.bit_length() - 1
        self.parity_bits = self.gen_poly_deg
        self.data_length = _data_length(cfg, self.fs, self.gen_poly)
        self.n = self.parity_bits + self.data_length   # codeword_length

        self._arrays = arrays
        if arrays is None:
            arrays = _encoder_host_arrays(cfg)

        def i32(name):
            return torch.tensor(np.asarray(arrays[name], dtype=np.int32), device=device)

        self.R_enc = torch.tensor(np.asarray(arrays["R_enc"], dtype=np.float32),
                                  device=device)   # [data_length, parity_bits]
        self.inv_tbl = i32("inv_tbl")    # [fs+1], inv[0] = 0
        self.log2exp = i32("log2exp")    # [fs+1], log2exp[fs] = 0
        self.exp2log = i32("exp2log")    # [fs+1], exp2log[0] = fs
        self._G_syn = self._M_chien = None

        # The kernel's launcher: on a card, for configs the kernel supports.
        self.kernel = None
        if device.type == "cuda" and BCHCudaDecoder.supports(self):
            self.kernel = BCHCudaDecoder(
                bch_tables(arrays["log2exp"], arrays["exp2log"], self.gen_poly, self.t),
                self.m, self.t, self.parity_bits, self.data_bytes, device)

    @classmethod
    def from_arrays(cls, cfg: BchConfig, arrays: dict[str, np.ndarray],
                    device: str | torch.device = "cuda") -> "BCHCodec":
        """A codec built from given arrays (ARRAY_NAMES), e.g. a JAX
        codec's, taken with np.asarray."""
        return cls(cfg, device, arrays)

    def _decoder_matrix(self, name: str) -> torch.Tensor:
        arrays = self._arrays if self._arrays is not None else _decoder_host_arrays(self.cfg)
        return torch.tensor(np.asarray(arrays[name], dtype=np.float32), device=self.device)

    @property
    def G_syn(self) -> torch.Tensor:
        """[n, 2t m]: the syndromes' bit matrix, built at first use."""
        if self._G_syn is None:
            self._G_syn = self._decoder_matrix("G_syn")
        return self._G_syn

    @property
    def M_chien(self) -> torch.Tensor:
        """[64 m, n m]: the Chien search's bit matrix, built at first use."""
        if self._M_chien is None:
            self._M_chien = self._decoder_matrix("M_chien")
        return self._M_chien

    # --------------------------------------------------- bit-tensor codec

    def _mul(self, a, b):
        return gf_mul(a, b, self.exp2log, self.log2exp)

    def _word_bits(self, w: torch.Tensor) -> torch.Tensor:
        """int32 words [B] -> LSB-first bits [B, n] (n <= 31 only);
        arithmetic shifts, as in the JAX package."""
        shifts = torch.arange(self.n, dtype=torch.int32, device=w.device)
        return (w[:, None] >> shifts) & 1

    def _bits_word(self, bits: torch.Tensor) -> torch.Tensor:
        """LSB-first bits [B, n] -> int32 words [B] (n <= 31 only)."""
        w = 1 << torch.arange(self.n, dtype=torch.int32, device=bits.device)
        return (bits.to(torch.int32) * w).sum(dim=1, dtype=torch.int32)

    def encode_bits(self, data_bits) -> torch.Tensor:
        """Batched bit encode: data bits [B, data_length] (LSB-first) ->
        codeword bits [B, n] int32, for every m."""
        bits = as_tensor(data_bits, torch.int32, self.device)
        return torch.cat([gf2_matmul(bits, self.R_enc), bits], dim=1)

    def _words(self, words) -> tuple[torch.Tensor, bool]:
        if self.n > 31:
            raise GFError(
                "BCH word API is limited to n <= 31; use the bit API or "
                "the byte facade for m >= 6 (the reference's uint32 packing "
                "is undefined there, encode.c:215)")
        w = as_tensor(words, torch.int32, self.device)
        return (w[None], True) if w.ndim == 0 else (w, False)

    def encode(self, data):
        """Batched word encode -> (ok [B] bool, codeword [B] int32).  A
        word of data_length bits or more gives ok False and codeword 0.
        Word adapter for n <= 31 (GFError otherwise)."""
        data, squeeze = self._words(data)
        ok = data < (1 << self.data_length)
        shifts = torch.arange(self.data_length, dtype=torch.int32, device=self.device)
        cw = self._bits_word(self.encode_bits((data[:, None] >> shifts) & 1))
        cw = torch.where(ok, cw, 0)
        return (ok[0], cw[0]) if squeeze else (ok, cw)

    def _syndromes(self, bits: torch.Tensor) -> torch.Tensor:
        """[B, n] bits -> normal-domain syndromes [B, 2t] int32."""
        return _bits_to_symbols(gf2_matmul(bits, self.G_syn), self.m)

    def _berlekamp_massey(self, S: torch.Tensor):
        """bch.c:78-142 as the JAX package runs it: a fixed 2t trips over
        64 lanes, branchless.  S: [B, 2t] normal-domain syndromes.
        Returns (error locator [B, 64], error count [B]) int32."""
        B, dev = S.shape[0], S.device
        P, t2 = _BCH_MAX_POLY, 2 * self.t
        lane = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
        # window buffer: at trip it, sbuf[:, t2-1-it+j] = S[it-j] for j <= it
        sbuf = torch.cat([S.flip(1), torch.zeros(B, P, dtype=torch.int32, device=dev)], 1)
        current = torch.zeros(B, P, dtype=torch.int32, device=dev)
        current[:, 0] = 1
        prev = current
        ec = torch.zeros(B, dtype=torch.int32, device=dev)
        shift = torch.ones(B, dtype=torch.int32, device=dev)
        prev_disc = torch.ones(B, dtype=torch.int32, device=dev)
        for it in range(t2):
            # discrepancy = S[it] ^ XOR_{1 <= i <= ec} current_i S[it-i]
            # (bch.c:98-105)
            w = sbuf[:, t2 - 1 - it: t2 - 1 - it + P]
            w = torch.where(lane <= it, w, 0)
            valid = (lane >= 1) & (lane <= ec[:, None])
            disc = w[:, 0] ^ _xor_reduce(torch.where(valid, self._mul(current, w), 0), self.m)
            no_disc = disc == 0
            # current[i + shift] ^= prev[i] * disc / prev_disc (bch.c:110-118);
            # prev_disc != 0, and lanes shifted past 63 drop
            multiplier = self._mul(disc, self.inv_tbl[prev_disc.long()])
            contrib = self._mul(prev, multiplier[:, None])
            src = lane - shift[:, None]
            upd = torch.where(src >= 0, contrib.gather(1, src.clamp(min=0).long()), 0)
            grow = 2 * ec <= it
            keep = no_disc | ~grow
            prev = torch.where(keep[:, None], prev, current)
            current = torch.where(no_disc[:, None], current, current ^ upd)
            ec = torch.where(keep, ec, it + 1 - ec)
            prev_disc = torch.where(keep, prev_disc, disc)
            shift = torch.where(keep, shift + 1, 1)
        return current, ec

    def decode_bits(self, received_bits):
        """Batched bit decode: received bits [B, n] -> (ok [B] bool,
        corrected bits [B, n] int32, num_errors [B] int32).  Clean and
        failed rows count 0 errors; failed rows return the input bits."""
        bits = as_tensor(received_bits, torch.int32, self.device)
        S = self._syndromes(bits)
        clean = ~(S != 0).any(dim=1)
        locator, ec = self._berlekamp_massey(S)
        fail_t = ec > self.t

        # Chien over all n points, the locator masked to degree ec (the
        # degree argument of bch_poly_eval); the first ec roots count
        lane = torch.arange(_BCH_MAX_POLY, dtype=torch.int32, device=bits.device)[None, :]
        lam = torch.where(lane <= ec[:, None], locator, 0)
        evals = _bits_to_symbols(gf2_matmul(_symbols_to_bits(lam, self.m), self.M_chien), self.m)
        root_mask = evals == 0
        cum = torch.cumsum(root_mask.to(torch.int32), dim=1)
        selected = root_mask & (cum <= ec[:, None])
        found = selected.sum(dim=1, dtype=torch.int32)
        fail_found = found != ec

        corrected = bits ^ selected.to(torch.int32)
        fail_verify = (self._syndromes(corrected) != 0).any(dim=1)

        ok = clean | ~(fail_t | fail_found | fail_verify)
        num_errors = torch.where(clean | ~ok, 0, found)
        out = torch.where((clean | ~ok)[:, None], bits, corrected)
        return ok, out, num_errors

    def decode(self, received):
        """Batched word decode -> (ok [B], corrected [B], num_errors [B]);
        the words are masked to n bits.  Word adapter for n <= 31."""
        received, squeeze = self._words(received)
        ok, out, ne = self.decode_bits(self._word_bits(received & ((1 << self.n) - 1)))
        cw = self._bits_word(out)
        return (ok[0], cw[0], ne[0]) if squeeze else (ok, cw, ne)

    def decode_bytes(self, data: torch.Tensor, parity: torch.Tensor):
        """The facade's decode of stored bytes: data uint8 [B, >= data_bytes]
        and parity uint8 [B, parity bytes] on the codec's device -> (ok [B]
        bool, data uint8 [B, data bytes], corrected [B] int32): each ok row's
        data corrected and every other row's as given, the count 0 on clean
        and failed rows.  A codec that holds the kernel takes rows of
        exactly data_bytes and at least parity_bytes, of which it reads the
        first parity_bytes as the plain version does, and raises ValueError
        on any other width.  Every other codec runs the plain version on
        packed bits, whose corrected data_bytes are broadcast over a longer
        row where data_bytes is 1 and raise ValueError otherwise
        (ROADMAP.md Queue 3, F7)."""
        with span("poporon.codec.decode"):
            if self.kernel is None:
                return self.decode_bytes_plain(data, parity)
            if data.shape[-1] != self.data_bytes or parity.shape[-1] < self.parity_bytes:
                raise ValueError(f"BCH decode on the kernel takes rows of {self.data_bytes} "
                                 f"data and {self.parity_bytes} parity bytes, got "
                                 f"{data.shape[-1]} and {parity.shape[-1]}")
            return self.kernel.decode(data, parity[..., : self.parity_bytes])

    def decode_bytes_plain(self, data: torch.Tensor, parity: torch.Tensor):
        """`decode_bytes` by the plain version, on packed bits."""
        received = torch.cat([self.pack_parity(parity), self.pack_data(data)], dim=1)
        ok, cw, nerr = self.decode_bits(received)
        out_bytes = self.unpack_data(cw[:, self.parity_bits:])
        if out_bytes.shape[-1] not in (1, data.shape[-1]):
            raise ValueError(f"Incompatible shapes for broadcasting: "
                             f"{tuple(out_bytes.shape)} and {tuple(data.shape)}")
        return ok, torch.where(ok[:, None], out_bytes, data), torch.where(ok, nerr, 0)

    def extract_data(self, codeword) -> torch.Tensor:
        """bch.c:437-444 (n <= 31 word form)."""
        cw = as_tensor(codeword, torch.int32, self.device)
        return (cw >> self.parity_bits) & ((1 << self.data_length) - 1)

    # ------------------------------------------------ facade byte layer

    @property
    def data_bytes(self) -> int:
        return (self.data_length + 7) // 8

    @property
    def parity_bytes(self) -> int:
        return (self.parity_bits + 7) // 8

    # Big-endian bytes, LSB-first bits, values masked to `length` bits
    # (encode.c:215-221, decode.c:559-575), without the C's 4-byte clamp:
    # the same mapping for n <= 31, and defined for every m.

    @staticmethod
    def _bytes_to_bits(bs: torch.Tensor, length: int) -> torch.Tensor:
        """int [..., nb] big-endian bytes -> LSB-first bits [..., length].

        Where nb is short of `length` bits, byte indices below 0 read as
        the JAX package's `jnp.take` reads them: -nb..-1 count from the
        end, and further ones read a value whose low bits are 0.
        """
        nb = bs.shape[-1]
        if nb == 0 and length > 0:
            raise ValueError("BCH byte input has no bytes")
        j = torch.arange(length, device=bs.device)
        byte_of = nb - 1 - j // 8
        idx = torch.where(byte_of < 0, byte_of + nb, byte_of).clamp(min=0)
        bits = (bs.to(torch.int32).index_select(-1, idx) >> (j % 8).to(torch.int32)) & 1
        return torch.where(byte_of >= -nb, bits, 0)

    @staticmethod
    def _bits_to_bytes(bits: torch.Tensor, length: int, nbytes: int) -> torch.Tensor:
        """LSB-first bits [..., length] -> big-endian uint8 [..., nbytes]."""
        bits = bits.to(torch.int32)
        pad = nbytes * 8 - length
        if pad:
            bits = torch.cat([bits, bits.new_zeros(*bits.shape[:-1], pad)], dim=-1)
        # byte i holds bits [8 (nbytes-1-i), 8 (nbytes-1-i) + 8), LSB-first
        b = bits.reshape(*bits.shape[:-1], nbytes, 8)
        w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
        return (b * w).sum(dim=-1, dtype=torch.int32).flip(-1).to(torch.uint8)

    def pack_data(self, data) -> torch.Tensor:
        """bytes [B, data_bytes] -> data bits [B, data_length]."""
        data = as_tensor(data, torch.int32, self.device)
        return self._bytes_to_bits(data[..., : self.data_bytes], self.data_length)

    def unpack_data(self, bits) -> torch.Tensor:
        """data bits [B, data_length] -> uint8 [B, data_bytes]."""
        return self._bits_to_bytes(as_tensor(bits, torch.int32, self.device),
                                   self.data_length, self.data_bytes)

    def pack_parity(self, parity) -> torch.Tensor:
        """bytes [B, parity_bytes] -> parity bits [B, parity_bits]."""
        parity = as_tensor(parity, torch.int32, self.device)
        return self._bytes_to_bits(parity[..., : self.parity_bytes], self.parity_bits)

    def unpack_parity(self, bits) -> torch.Tensor:
        """parity bits [B, parity_bits] -> uint8 [B, parity_bytes]."""
        return self._bits_to_bytes(as_tensor(bits, torch.int32, self.device),
                                   self.parity_bits, self.parity_bytes)
