"""The RS syndrome kernel's tables and loop against the JAX package.

`syndrome_tables` (libpoporon_tpu_torch/models/rs_cuda.py) packs, for
each factor of g(x) of up to 16 roots, the division table T and the
tail's nibble tables of the syndrome kernel in csrc/rs_decode.cu.  Here a
NumPy emulation of that kernel's loop (four symbols a little-endian 32-bit
read; a factor's remainder in four 32-bit words, byte b the coefficient of
x^b; a step takes the top byte, shifts the words up a byte with the
symbol entering byte 0 and XORs in T[top]; the tail XORs the entries of
the remainder's 32 nibbles, accumulator byte j read as S_{16f+j}) must
give the JAX package's `RSCodec._syndrome` exactly, over the configs
chip_smoke.py holds the kernel to on the card; and the codec's plain
syndromes (`RSCodec._syndrome`, the kernel's plain version) in log form
must give its log form.  Tolerance: exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import RSCodec  # noqa: E402
from libpoporon_tpu_torch.models.rs_cuda import (  # noqa: E402
    FACTOR_ENTRIES, FACTOR_ROOTS, syndrome_tables)

torch.set_num_threads(2)

B = 48
CONFIGS = {
    "default": {},
    "fcr0": {"first_consecutive_root": 0},
    "prim2": {"primitive_element": 2},
    "nr16": {"num_roots": 16},
    "nr64": {"num_roots": 64},
}
_CODECS = {}
_CASES = {}


def _codecs(name):
    """(port, JAX) codecs per config, built once per module."""
    if name not in _CODECS:
        kw = CONFIGS[name]
        _CODECS[name] = (RSCodec(RSConfig(**kw), "cpu"),
                         JaxRSCodec(JaxRSConfig(use_pallas="off", **kw)))
    return _CODECS[name]


def _sizes(name):
    """1, 100 and the two longest words: 222 and 223 at nr = 32."""
    k = _codecs(name)[0].k
    return (1, 100, k - 1, k)


def _case(name, which):
    """Rows of the `which`-th size of config `name`: 12 clean, 12 with t
    symbol errors, 4 junk, the rest 1..t errors; and the JAX syndromes."""
    key = (name, which)
    if key not in _CASES:
        rs, jax_rs = _codecs(name)
        size = _sizes(name)[which]
        nr = rs.num_roots
        rng = np.random.default_rng(100 * len(name) + which)
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        parity = rs.encode(data).numpy()
        word = np.concatenate([data, parity], axis=1)
        nerr = rng.integers(1, nr // 2 + 1, B)
        nerr[:12], nerr[12:24] = 0, nr // 2
        for i in range(B):
            q = rng.choice(word.shape[1], min(int(nerr[i]), word.shape[1]), replace=False)
            word[i, q] ^= rng.integers(1, 256, len(q)).astype(np.uint8)
        word[-4:] = rng.integers(0, 256, (4, word.shape[1]), dtype=np.uint8)
        data, parity = word[:, :size], word[:, size:]
        _CASES[key] = (data, parity, np.asarray(jax_rs._syndrome(data, parity)))
    return _CASES[key]


def _words(tab: np.ndarray) -> np.ndarray:
    """Table entries [..., 16] bytes as the kernel's four little-endian
    32-bit words (a uint4's x, y, z, w)."""
    return np.ascontiguousarray(tab).view("<u4")


def emulate_kernel(tables: np.ndarray, nr: int, word: np.ndarray) -> np.ndarray:
    """rs_syndrome_kernel's loop in NumPy over the rows of word [B, n]
    (data then parity), from the int32 tables [F, FACTOR_ENTRIES, 4]:
    normal-domain syndromes [B, nr]."""
    tab = tables.view(np.uint32)
    F = tab.shape[0]
    rows, n = word.shape
    R = np.zeros((rows, F, 4), np.uint32)
    padded = np.zeros((rows, (n + 3) // 4 * 4), np.uint8)
    padded[:, :n] = word

    def step(x, e):
        """divide_step: symbol byte e of x enters every factor's remainder."""
        for f in range(F):
            top = R[:, f, 3] >> np.uint32(24)
            for w in (3, 2, 1):       # __funnelshift_l(R[w - 1], R[w], 8)
                R[:, f, w] = (R[:, f, w] << np.uint32(8)) | (R[:, f, w - 1] >> np.uint32(24))
            v = (x >> np.uint32(8 * e)) & np.uint32(0xFF)   # __byte_perm(x, R0, 0x6540 | e)
            R[:, f, 0] = (R[:, f, 0] << np.uint32(8)) | v
            R[:, f] ^= tab[f, top]

    for j in range(0, n - n % 4, 4):
        x = padded[:, j:j + 4].copy().view("<u4")[:, 0]
        for e in range(4):
            step(x, e)
    for j in range(n - n % 4, n):
        step(word[:, j].astype(np.uint32), 0)

    syn = np.zeros((rows, F * 16), np.int32)
    for f in range(F):
        acc = np.zeros((rows, 4), np.uint32)
        for b in range(FACTOR_ROOTS):
            byte = (R[:, f, b // 4] >> np.uint32(8 * (b % 4))) & np.uint32(0xFF)
            acc ^= tab[f, 256 + 2 * b * 16 + (byte & 15)]
            acc ^= tab[f, 256 + (2 * b + 1) * 16 + (byte >> 4)]
        syn[:, 16 * f:16 * f + 16] = acc.view("<u1").reshape(rows, 16)
    return syn[:, :nr]


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("name", CONFIGS)
def test_emulated_kernel_loop_matches_jax_syndromes(name, which):
    rs, _ = _codecs(name)
    data, parity, want = _case(name, which)
    tables = syndrome_tables(rs.exp2log, rs.log2exp, rs.num_roots, rs.fcr, rs.prim).view(np.int32)
    got = emulate_kernel(tables, rs.num_roots, np.concatenate([data, parity], axis=1))
    assert got.shape == want.shape == (B, rs.num_roots)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_syndromes_plain_version_is_log_of_jax(name):
    rs, jax_rs = _codecs(name)
    exp2log = np.asarray(jax_rs.gf.exp2log)
    for which in range(4):
        data, parity, want = _case(name, which)
        got = rs.exp2log[rs._syndrome(torch.as_tensor(data), torch.as_tensor(parity)).long()]
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), exp2log[want])
        assert (got[:12] == 255).all()          # clean rows: the sentinel fs
        assert (got[12:] != 255).any(dim=1).all()


def _gf(rs):
    log = rs.exp2log.numpy().astype(np.int64)
    alog = rs.log2exp.numpy().astype(np.int64)

    def mul(a, b):
        return 0 if a == 0 or b == 0 else int(alog[(log[a] + log[b]) % 255])

    return mul, alog


def _poly_mul(mul, a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] ^= mul(x, y)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_division_table_is_the_generator_polynomial(name):
    """T_f[v] = v (h_f - x^16), h_f = x^(16 - r_f) g_f monic of degree 16,
    and the product of the g_f is g(x) of `genlog` (the encoder's): the
    kernel divides by the code's own generator, factor by factor."""
    rs, _ = _codecs(name)
    mul, alog = _gf(rs)
    nr = rs.num_roots
    tab = syndrome_tables(rs.exp2log, rs.log2exp, nr, rs.fcr, rs.prim)
    assert tab.shape[0] == -(-nr // FACTOR_ROOTS)
    g = [1]
    for f in range(tab.shape[0]):
        r_f = min(FACTOR_ROOTS, nr - FACTOR_ROOTS * f)
        h = [int(c) for c in tab[f, 1]] + [1]          # T_f[1]: h_f's low 16 coefficients
        pad = FACTOR_ROOTS - r_f
        assert not any(h[:pad])                        # x^pad divides h_f
        for v in range(256):
            assert [int(c) for c in tab[f, v]] == [mul(v, c) for c in h[:FACTOR_ROOTS]]
        g = _poly_mul(mul, g, h[pad:])
    genlog = rs.genlog                                 # log form, fs = zero
    want = [0 if e == 255 else int(alog[e]) for e in genlog]
    assert g == want


@pytest.mark.parametrize("nr", [10, 16, 20, 32, 33, 64])
def test_syndrome_tables_layout(nr):
    """Shape, dtype and byte size of the tables, and of the int32 words
    the launcher stages from them; each factor's tail entry
    (2 b + h) 16 + u holds (u << 4h) b_i^b for its r_f roots and zeros past
    them; T_f[0] and the tail's u = 0 entries are zero; and the factors'
    roots are b_0..b_{nr-1} in order."""
    rs = RSCodec(RSConfig(num_roots=nr), "cpu")
    mul, alog = _gf(rs)
    F = -(-nr // FACTOR_ROOTS)
    as_bytes = syndrome_tables(rs.exp2log, rs.log2exp, nr, rs.fcr, rs.prim)
    assert as_bytes.dtype == np.uint8 and as_bytes.flags.c_contiguous
    assert as_bytes.shape == (F, FACTOR_ENTRIES, 16)
    assert as_bytes.nbytes == F * (256 + 512) * 16
    tab = as_bytes.view(np.int32)          # RSCudaDecoder.syndrome_tables' words
    assert tab.shape == (F, FACTOR_ENTRIES, 4)
    assert np.array_equal(_words(as_bytes), tab.view(np.uint32))
    for f in range(F):
        r_f = min(FACTOR_ROOTS, nr - FACTOR_ROOTS * f)
        assert not as_bytes[f, 0].any()
        tail = as_bytes[f, 256:].reshape(FACTOR_ROOTS, 2, 16, 16)   # [b, h, u, j]
        assert not tail[:, :, 0].any()
        assert not tail[..., r_f:].any()
        for b in (0, 1, 7, 15):
            for h in range(2):
                for u in (1, 9, 15):
                    want = [mul(u << 4 * h, int(alog[((1 + 16 * f + j) * b) % 255]))
                            for j in range(r_f)]
                    assert [int(c) for c in tail[b, h, u, :r_f]] == want
