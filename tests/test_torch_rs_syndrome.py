"""The RS syndrome kernel's column table against the JAX package.

`syndrome_columns` (libpoporon_tpu_torch/models/rs_cuda.py) packs the
rows of G_syn for the bit-sliced syndrome kernel in csrc/rs_decode.cu.
Here a NumPy emulation of that kernel's loop (four symbols a little-endian
32-bit read, bit 7 first, the masked columns XORed into W accumulators,
accumulator byte i read as S_i) must give the JAX package's
`RSCodec._syndrome` exactly, over the configs chip_smoke.py holds the
kernel to on the card; and `RSCudaDecoder.syndromes` on CPU tensors (the
kernel's plain version) must give its log form.  Tolerance: exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import RSCodec  # noqa: E402
from libpoporon_tpu_torch.models.rs_cuda import column_words, syndrome_columns  # noqa: E402

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


def emulate_kernel(columns: np.ndarray, nr: int, word: np.ndarray) -> np.ndarray:
    """rs_syndrome_kernel's loop in NumPy over the rows of word [B, n]
    (data then parity): normal-domain syndromes [B, nr]."""
    fs, _, W = columns.shape
    rows, n = word.shape
    cols = columns.view(np.uint32)
    pad = fs - n
    acc = np.zeros((rows, W), np.uint32)
    padded = np.zeros((rows, (n + 3) // 4 * 4), np.uint8)
    padded[:, :n] = word

    def add_symbol(q, sym):
        for b in range(8):
            bit = (sym >> np.uint32(7 - b)) & np.uint32(1)
            acc[...] ^= cols[q, b][None, :] & (np.uint32(0) - bit)[:, None]

    for j in range(0, n - n % 4, 4):
        x = padded[:, j:j + 4].copy().view("<u4")[:, 0]
        for e in range(4):
            add_symbol(pad + j + e, x >> np.uint32(8 * e))
    for j in range(n - n % 4, n):
        add_symbol(pad + j, word[:, j].astype(np.uint32))
    syn = acc.view("<u1").reshape(rows, 4 * W)
    return syn[:, :nr].astype(np.int32)


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("name", CONFIGS)
def test_emulated_kernel_loop_matches_jax_syndromes(name, which):
    rs, _ = _codecs(name)
    data, parity, want = _case(name, which)
    columns = rs.kernel.columns.numpy()
    got = emulate_kernel(columns, rs.num_roots, np.concatenate([data, parity], axis=1))
    assert got.shape == want.shape == (B, rs.num_roots)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_syndromes_plain_version_is_log_of_jax(name):
    rs, jax_rs = _codecs(name)
    exp2log = np.asarray(jax_rs.gf.exp2log)
    for which in range(4):
        data, parity, want = _case(name, which)
        got = rs.kernel.syndromes(torch.as_tensor(data), torch.as_tensor(parity))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), exp2log[want])
        assert (got[:12] == 255).all()          # clean rows: the sentinel fs
        assert (got[12:] != 255).any(dim=1).all()


@pytest.mark.parametrize("nr, W", [(10, 4), (16, 4), (20, 8), (32, 8), (33, 16), (64, 16)])
def test_column_table_layout(nr, W):
    """Shape, dtype, byte size, the pinned bit order (G_syn[q*8 + b,
    8*i + c] is bit 8*(i % 4) + 7 - c of word i // 4) and zero words past
    the nr syndrome bytes."""
    rs = RSCodec(RSConfig(num_roots=nr), "cpu")
    assert column_words(nr) == W
    tab = rs.kernel.columns
    assert tab.dtype == torch.int32 and tab.is_contiguous()
    assert tuple(tab.shape) == (255, 8, W)
    assert tab.numel() * 4 == 255 * 32 * W
    as_bytes = tab.numpy().view(np.uint32).view("<u1").reshape(255, 8, 4 * W)
    assert not as_bytes[..., nr:].any()
    bits = np.unpackbits(as_bytes[..., :nr], axis=-1, bitorder="big")   # c = 0 first
    g_syn = rs.G_syn.numpy().astype(np.uint8).reshape(255, 8, nr * 8)
    assert np.array_equal(bits, g_syn)
    assert torch.equal(syndrome_columns(rs.G_syn, nr), tab)
