"""The port's RSCodec (device cpu) against the JAX package's XLA path.

The same inputs, made with NumPy from a seed, go through
libpoporon_tpu's `RSCodec(RSConfig(use_pallas="off"))` and the port's
`RSCodec`; every output (ok, data, parity, corrected) must be equal, bit
for bit.  On CPU tensors the port's kernel wrapper runs the plain PyTorch
version, so these tests hold the kernel's plain version to the reference.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import ARRAY_NAMES, RSCodec  # noqa: E402
from libpoporon_tpu_torch.models.rs_cuda import RSCudaDecoder  # noqa: E402

torch.set_num_threads(2)

B = 128


def assert_same(got, want):
    """Port outputs (tensors) == JAX outputs, values and dtypes."""
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want) == 4
    for g, w, name in zip(got, want, ("ok", "data", "parity", "corrected")):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name


def mixed_batch(rng, data, parity):
    """Clean rows, 0..t+1 symbol errors over data and parity, rows with
    parity-only errors, and junk rows beyond any decoder."""
    data, parity = data.copy(), parity.copy()
    n_rows, size = data.shape
    nr = parity.shape[1]
    n = size + nr
    nerr = rng.integers(0, nr // 2 + 2, n_rows)
    nerr[: n_rows // 8] = 0
    for i in range(n_rows):
        q = rng.choice(n, min(int(nerr[i]), n), replace=False)
        v = rng.integers(1, 256, len(q)).astype(np.uint8)
        in_data = q < size
        data[i, q[in_data]] ^= v[in_data]
        parity[i, q[~in_data] - size] ^= v[~in_data]
    for i in range(n_rows // 16, n_rows // 8):
        parity[i, rng.choice(nr, 3, replace=False)] ^= 0x5A
    junk = max(1, n_rows // 16)
    data[-junk:] = rng.integers(0, 256, (junk, size), dtype=np.uint8)
    return data, parity


def erasure_batch(rng, data, E, extra):
    """E corrupted erasure positions per row plus `extra` further random
    errors; the position array is exactly E wide."""
    bad = data.copy()
    pos = np.zeros((data.shape[0], E), np.int32)
    for i in range(data.shape[0]):
        p = rng.choice(data.shape[1], E + extra, replace=False)
        pos[i] = p[:E]
        bad[i, p] ^= rng.integers(1, 256, E + extra).astype(np.uint8)
    return bad, pos, np.full(data.shape[0], E, np.int32)


@pytest.fixture(scope="module")
def jax_rs():
    return JaxRSCodec(JaxRSConfig(use_pallas="off"))


@pytest.fixture(scope="module")
def rs():
    return RSCodec(RSConfig())


def _inputs(rs, seed, size, n_rows=B):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n_rows, size), dtype=np.uint8)
    return rng, data, rs.encode(data).numpy()


@pytest.mark.parametrize("size", [1, 100, 223])
def test_encode_matches_jax(rs, jax_rs, size):
    rng = np.random.default_rng(size)
    data = rng.integers(0, 256, (B, size), dtype=np.uint8)
    got = rs.encode(data)
    want = np.asarray(jax_rs.encode(data))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [1, 100, 223])
def test_plain_decode_matches_jax(rs, jax_rs, size):
    rng, data, parity = _inputs(rs, 10 + size, size)
    bad, pbad = mixed_batch(rng, data, parity)
    want = jax_rs._decode_plain(bad, pbad)
    assert_same(rs.decode(bad, pbad), want)
    ok = np.asarray(want[0])
    assert ok.any() and not ok.all()   # the batch mixes successes and failures


def test_erasure_decode_matches_jax(rs, jax_rs):
    rng, data, parity = _inputs(rs, 20, 223)
    bad, pos, cnt = erasure_batch(rng, data, 32, 0)
    cnt[:8] = rng.integers(0, 32, 8)       # some rows name fewer positions
    assert_same(rs.decode(bad, parity, erasures=(pos, cnt)),
                jax_rs._decode_erasure(bad, parity, pos, cnt))


def test_erasure_f1_input_follows_xla(rs, jax_rs):
    """E = 7 erasures plus 3 random errors with a position array exactly 7
    wide: the locator degree exceeds E, and locator slots past E read
    position 0 (the XLA path's semantics, which the port keeps)."""
    rng, data, parity = _inputs(rs, 21, 223)
    bad, pos, cnt = erasure_batch(rng, data, 7, 3)
    want = jax_rs._decode_erasure(bad, parity, pos, cnt)
    got = rs.decode(bad, parity, erasures=(pos, cnt))
    assert_same(got, want)
    ok, out = got[0].numpy(), got[1].numpy()
    assert ok.all()
    assert (out != data).any(axis=1).all()   # ok, yet not the original data


def test_ext_syndrome_decode_matches_jax(rs, jax_rs):
    rng, data, parity = _inputs(rs, 30, 223)
    bad, pbad = mixed_batch(rng, data, parity)
    s = rs._syndrome(torch.from_numpy(bad), torch.from_numpy(pbad))
    s_log = rs.exp2log[s.long()].numpy()
    s_log[3, 0] = 300                       # out of range: reads as zero
    s_log[4, :] = 255                       # the sentinel on every slot
    assert_same(rs.decode(bad, pbad, ext_syndrome=s_log),
                jax_rs._decode_ext_syndrome(bad, pbad, s_log))


def test_decode_argument_forms_match_jax(rs, jax_rs):
    """1-D erasure lists and 1-D external syndromes broadcast over the
    batch, through `decode` on both sides."""
    rng, data, parity = _inputs(rs, 40, 223)
    positions = rng.choice(223, 7, replace=False).astype(np.int32)
    bad = data.copy()
    bad[:, positions] ^= 0x33
    assert_same(rs.decode(bad, parity, erasures=positions),
                jax_rs.decode(bad, parity, erasures=positions))
    s_log = np.full(32, 255, np.int32)
    s_log[0] = 7
    assert_same(rs.decode(bad, parity, ext_syndrome=s_log),
                jax_rs.decode(bad, parity, ext_syndrome=s_log))


@pytest.mark.parametrize("size", [0, 224])
def test_invalid_size_returns_inputs(rs, jax_rs, size):
    rng = np.random.default_rng(50)
    data = rng.integers(0, 256, (4, size), dtype=np.uint8)
    parity = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    got = rs.decode(data, parity)
    assert_same(got, jax_rs.decode(data, parity))
    assert not got[0].any()


def test_single_codeword_squeeze_matches_jax(rs, jax_rs):
    rng, data, parity = _inputs(rs, 60, 223, n_rows=1)
    bad = data[0].copy()
    bad[[5, 77, 200]] ^= 0x21
    assert np.array_equal(rs.encode(data[0]).numpy(), np.asarray(jax_rs.encode(data[0])))
    got = rs.decode(bad, parity[0])
    assert got[1].shape == (223,) and got[0].shape == ()
    assert_same(got, jax_rs.decode(bad, parity[0]))


def test_from_arrays_decodes_like_jax(jax_rs):
    arrays = {n: np.asarray(getattr(jax_rs, n)) for n in ARRAY_NAMES
              if n not in ("log2exp", "exp2log")}
    arrays["log2exp"] = np.asarray(jax_rs.gf.log2exp)
    arrays["exp2log"] = np.asarray(jax_rs.gf.exp2log)
    rs = RSCodec.from_arrays(RSConfig(), arrays, "cpu")
    rng, data, parity = _inputs(rs, 10 + 223, 223)   # the plain test's inputs
    bad, pbad = mixed_batch(rng, data, parity)
    assert_same(rs.decode(bad, pbad), jax_rs._decode_plain(bad, pbad))


def test_kernel_wrapper_runs_plain_version_on_cpu(rs):
    assert isinstance(rs.kernel, RSCudaDecoder)
    rng, data, parity = _inputs(rs, 70, 223, n_rows=16)
    bad, pbad = mixed_batch(rng, data, parity)
    d, p = torch.from_numpy(bad), torch.from_numpy(pbad)
    before = rs.kernel.launches
    assert_same(rs.decode(d, p), rs._decode_plain(d, p))
    assert rs.kernel.launches == before    # no launch for CPU tensors
    with pytest.raises(ValueError):
        rs.kernel._launch(0, d, p)


def test_use_kernel_knob():
    assert RSCodec(RSConfig(use_kernel="off")).kernel is None
    assert RSCodec(RSConfig(symbol_size=4, generator_polynomial=0x13,
                            num_roots=4)).kernel is None   # outside the gate
    with pytest.raises(ValueError):
        RSCodec(RSConfig(use_kernel="on"))
