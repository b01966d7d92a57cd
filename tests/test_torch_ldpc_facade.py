"""The port's LDPC slice end to end through its facade, against the JAX
package's facade on the same inputs, at full width: the 128-byte
rate-1/2 code (V = 2048, P = 1024, 5119 edges) in both configurations
users run, hard (`LdpcConfig(128, RATE_1_2)`, 4 flipped bits a row) and
soft (`ldpc_config_default(128, RATE_1_2)`, both interleavers, int8
LLRs at about 1e-2 channel BER).  B = 512 takes the adaptive branch,
B = 8 the plain one.  Exact equality on every output.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import libpoporon_tpu as jpp  # noqa: E402
from libpoporon_tpu.utils import bits as jbits  # noqa: E402

import libpoporon_tpu_torch as pt  # noqa: E402

torch.set_num_threads(2)


def facades(kind):
    if kind == "hard":
        return (pt.create(pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), device="cpu"),
                jpp.create(jpp.LdpcConfig(128, jpp.LdpcRate.RATE_1_2, use_pallas="off")))
    cfg = jpp.ldpc_config_default(128, jpp.LdpcRate.RATE_1_2)
    return (pt.create(pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), device="cpu"),
            jpp.create(type(cfg)(**{**cfg.__dict__, "use_pallas": "off"})))


@pytest.fixture(scope="module", params=["hard", "soft"])
def codecs(request):
    return (request.param, *facades(request.param))


def transmitted(codec, ref, n_rows, seed):
    """Random info, encoded by both facades (equal), and the transmitted
    word's bits."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 256, (n_rows, 128), dtype=np.uint8)
    enc, enc_ref = codec.encode(info), ref.encode(info.copy())
    assert np.array_equal(enc.data.numpy(), np.asarray(enc_ref.data))
    assert np.array_equal(enc.parity.numpy(), np.asarray(enc_ref.parity))
    word = np.concatenate([enc.data.numpy(), enc.parity.numpy()], axis=1)
    return rng, info, enc, jbits.unpack_np(word, 2048)


def assert_same(got, want):
    for g, w, name in zip(got, want, ("ok", "data", "parity", "corrected")):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("n_rows", [512, 8])
def test_main_path_matches_jax(codecs, n_rows):
    kind, codec, ref = codecs
    rng, info, enc, bits = transmitted(codec, ref, n_rows, n_rows)
    data, parity = enc.data.numpy(), enc.parity.numpy()
    kw = {}
    if kind == "hard":
        rows = np.repeat(np.arange(n_rows), 4)
        pos = np.stack([rng.choice(2048, 4, replace=False) for _ in range(n_rows)])
        word = np.concatenate([data, parity], axis=1)
        np.bitwise_xor.at(word, (rows, pos.reshape(-1) // 8),
                          (1 << (7 - pos.reshape(-1) % 8)).astype(np.uint8))
        data, parity = word[:, :128], word[:, 128:]
    else:
        llr = np.where(bits == 1, -90.0, 90.0) + rng.normal(0, 38.6, bits.shape)
        kw["soft_llr"] = np.clip(np.round(llr), -127, 127).astype(np.int8)
    got = codec.decode(data, parity, **kw)
    assert_same(got, ref.decode(data, parity, **kw))
    ok = got.ok.numpy()
    assert ok.mean() > 0.9
    assert np.array_equal(got.data.numpy()[ok], info[ok])
    assert codec.iterations_used is got.corrected and codec.last_corrected is got.corrected


def test_soft_config_without_llrs_decodes_hard():
    """use_soft_decode with no soft_llr falls back to hard decoding
    (reference quirk, decode.c:509-514)."""
    codec, ref = facades("soft")
    rng, info, enc, _ = transmitted(codec, ref, 8, 1)
    data = enc.data.numpy().copy()
    data[np.arange(8), rng.integers(0, 128, 8)] ^= 0x10
    got = codec.decode(data, enc.parity)
    assert_same(got, ref.decode(data, enc.parity.numpy()))
    assert got.ok.all() and np.array_equal(got.data.numpy(), info)
    one = codec.decode(data[0], enc.parity[0])
    assert one.data.shape == (128,) and bool(one.ok)
    assert_same(one, ref.decode(data[0], enc.parity.numpy()[0]))


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_getters_match_jax(kind):
    codec, ref = facades(kind)
    assert (codec.parity_size, codec.info_size) == (ref.parity_size, ref.info_size) == (128, 128)
    assert codec.iterations_used == ref.iterations_used == 0
    with pytest.raises(ValueError):
        codec.encode(np.zeros((2, 100), np.uint8))
