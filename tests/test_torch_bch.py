"""The port's BCHCodec and the facade's BCH paths (device cpu) against the
JAX package's BCH on the same inputs.

Inputs are made with NumPy from a seed and go through
libpoporon_tpu.models.bch.BCHCodec and libpoporon_tpu_torch's BCHCodec (or
the two facades); every output (ok, bits or words, num_errors, bytes,
corrected, last_num_errors) must be equal, values, dtypes and shapes.
BCH(4095,4071) (m = 12) runs on the card only (chip_smoke.py): its host
build alone takes seconds in each package.
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import libpoporon_tpu as jpp  # noqa: E402
from libpoporon_tpu.models.bch import BCHCodec as JaxBCHCodec  # noqa: E402

import libpoporon_tpu_torch as pt  # noqa: E402
from libpoporon_tpu_torch.models.bch import ARRAY_NAMES, BCHCodec, host_arrays  # noqa: E402
from libpoporon_tpu_torch.ops.gf import GFError  # noqa: E402

torch.set_num_threads(2)

CONFIGS = {
    "BCH15-t3": (4, 0x13, 3),
    "BCH31-t2": (5, 0x25, 2),
    "BCH63-t2": (6, 0x43, 2),
    "BCH127-t3": (7, 0x89, 3),
    "BCH1023-t2": (10, 0x409, 2),
}


def assert_same(got, want, names):
    """Port outputs (tensors) == JAX outputs, values, dtypes and shapes."""
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name


def jax_arrays(j) -> dict:
    """A JAX codec's arrays by ARRAY_NAMES, as NumPy."""
    arrays = {name: np.asarray(getattr(j, name)) for name in ("R_enc", "G_syn", "M_chien",
                                                               "inv_tbl")}
    arrays.update(log2exp=j.gf.log2exp, exp2log=j.gf.exp2log)
    return arrays


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, port codec) by config name, built once."""
    return {name: (JaxBCHCodec(jpp.BchConfig(*c)), BCHCodec(pt.BchConfig(*c), "cpu"))
            for name, c in CONFIGS.items()}


def error_rows(rng, cw, counts):
    """Codeword rows with counts[i] distinct bit flips in row i."""
    out = cw.copy()
    for i, k in enumerate(counts):
        out[i, rng.choice(cw.shape[1], int(k), replace=False)] ^= 1
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_construction_matches_jax(codecs, name):
    j, p = codecs[name]
    for attr in ("m", "fs", "t", "n", "gen_poly", "gen_poly_deg", "parity_bits",
                 "data_length", "data_bytes", "parity_bytes"):
        assert getattr(p, attr) == getattr(j, attr), attr
    arrays = host_arrays(pt.BchConfig(*CONFIGS[name]))
    assert set(arrays) == set(ARRAY_NAMES)
    for key, want in jax_arrays(j).items():
        assert np.array_equal(np.asarray(arrays[key], np.int64), np.asarray(want, np.int64)), key
    assert np.array_equal(p.M_chien.numpy(), np.asarray(j.M_chien))


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_within_and_past_capacity(codecs, name):
    """0..t errors a row, t+1..t+3 errors a row and random words, through
    the bit API of the port's codec and of one built from the JAX codec's
    arrays (`from_arrays`)."""
    j, p = codecs[name]
    rng = np.random.default_rng(sum(CONFIGS[name]))
    B = 96
    dbits = rng.integers(0, 2, (B, j.data_length)).astype(np.int32)
    cw = np.asarray(j.encode_bits(dbits))
    assert_same([p.encode_bits(dbits)], [cw], ["codeword"])
    counts = np.concatenate([np.arange(B // 2) % (j.t + 1),
                             j.t + 1 + np.arange(B // 2 - 16) % 3])
    rx = error_rows(rng, cw, np.concatenate([counts, np.zeros(16, int)]))
    rx[-16:] = rng.integers(0, 2, (16, j.n))
    want = j.decode_bits(rx)
    names = ("ok", "bits", "num_errors")
    assert_same(p.decode_bits(rx), want, names)
    q = BCHCodec.from_arrays(pt.BchConfig(*CONFIGS[name]), jax_arrays(j), "cpu")
    assert_same(q.decode_bits(rx), want, names)
    ok = np.asarray(want[0])
    assert ok[: B // 2].all() and np.array_equal(np.asarray(want[1])[: B // 2], cw[: B // 2])


def test_bch15_exhaustive_encode(codecs):
    """All 32 datawords, word and bit API, and extract_data."""
    j, p = codecs["BCH15-t3"]
    words = np.arange(32, dtype=np.int32)
    assert_same(p.encode(words), j.encode(words), ("ok", "codeword"))
    cw = np.asarray(j.encode(words)[1])
    assert_same([p.extract_data(cw)], [j.extract_data(cw)], ["data"])
    assert np.array_equal(p.extract_data(cw).numpy(), words)


def test_bch15_every_pattern_up_to_3_bits(codecs):
    """Every 0-, 1-, 2- and 3-bit error pattern on four codewords, word API."""
    j, p = codecs["BCH15-t3"]
    cw = np.asarray(j.encode(np.array([0, 5, 19, 31], np.int32))[1])
    pats = [sum(1 << b for b in c) for k in range(4) for c in itertools.combinations(range(15), k)]
    rx = (cw[:, None] ^ np.array(pats, np.int32)[None, :]).reshape(-1).astype(np.int32)
    want = j.decode(rx)
    assert_same(p.decode(rx), want, ("ok", "codeword", "num_errors"))
    assert np.asarray(want[0]).all()
    assert np.array_equal(np.asarray(want[1]), np.repeat(cw, len(pats)))


def test_bch15_every_4_bit_overload(codecs):
    """Every 4-bit pattern on two codewords (past t = 3)."""
    j, p = codecs["BCH15-t3"]
    cw = np.asarray(j.encode(np.array([9, 26], np.int32))[1])
    pats = [sum(1 << b for b in c) for c in itertools.combinations(range(15), 4)]
    rx = (cw[:, None] ^ np.array(pats, np.int32)[None, :]).reshape(-1).astype(np.int32)
    assert_same(p.decode(rx), j.decode(rx), ("ok", "codeword", "num_errors"))


def test_bch63_every_single_and_double_error(codecs):
    j, p = codecs["BCH63-t2"]
    rng = np.random.default_rng(63)
    cw = np.asarray(j.encode_bits(rng.integers(0, 2, (1, j.data_length)).astype(np.int32)))
    flips = [(a,) for a in range(63)] + list(itertools.combinations(range(63), 2))
    rx = np.repeat(cw, len(flips), axis=0)
    for i, f in enumerate(flips):
        rx[i, list(f)] ^= 1
    want = j.decode_bits(rx)
    assert_same(p.decode_bits(rx), want, ("ok", "bits", "num_errors"))
    assert np.asarray(want[0]).all()


def test_word_api_edges(codecs):
    """GFError past n = 31, out-of-range and negative words, words with bits
    above n, and the 0-d squeeze."""
    j, p = codecs["BCH15-t3"]
    words = np.array([0, 31, 32, 100, -1, -5, 2**20, -2**31], np.int32)
    assert_same(p.encode(words), j.encode(words), ("ok", "codeword"))
    rx = np.array([-1, -5, 2**20, 2**15 + 7, 2**31 - 1, 0x7FFF], np.int32)
    assert_same(p.decode(rx), j.decode(rx), ("ok", "codeword", "num_errors"))
    assert_same(p.encode(np.int32(3)), j.encode(np.int32(3)), ("ok", "codeword"))
    assert_same(p.decode(np.int32(3929 ^ 6)), j.decode(np.int32(3929 ^ 6)),
                ("ok", "codeword", "num_errors"))
    assert p.encode(np.int32(3))[1].ndim == 0
    big_j, big_p = codecs["BCH63-t2"]
    for api in ("encode", "decode"):
        with pytest.raises(GFError, match="n <= 31"):
            getattr(big_p, api)(np.array([1], np.int32))
        with pytest.raises(ValueError):
            getattr(big_j, api)(np.array([1], np.int32))


def test_config_checks():
    """The range checks raise in both packages.  F8: 0x1F over GF(2^4) (a
    root of order 5) passes the JAX package's wrap-around check, and its
    products then differ from a log table's; the port rejects it."""
    for cfg in ((2, 0x7, 1), (17, 0x1002D, 1), (4, 0x13, 0), (4, 0x13, 17)):
        with pytest.raises(ValueError):
            JaxBCHCodec(jpp.BchConfig(*cfg))
        with pytest.raises(GFError):
            BCHCodec(pt.BchConfig(*cfg), "cpu")
    assert JaxBCHCodec(jpp.BchConfig(4, 0x1F, 1)).n == 15
    with pytest.raises(GFError, match="not primitive"):
        BCHCodec(pt.BchConfig(4, 0x1F, 1), "cpu")


@pytest.mark.parametrize("name", ["BCH15-t3", "BCH31-t2", "BCH63-t2"])
def test_facade_bytes(name):
    """The facade's byte round trip: encode, bit errors in data and parity
    bytes (0..t+2 a row), decode; then one 1-D row (squeeze)."""
    cfg = CONFIGS[name]
    ref, codec = jpp.create(jpp.BchConfig(*cfg)), pt.create(pt.BchConfig(*cfg), device="cpu")
    assert (codec.info_size, codec.parity_size) == (ref.info_size, ref.parity_size)
    assert codec.fec_type == pt.FecType.BCH
    rng = np.random.default_rng(cfg[0])
    B, k, npar = 64, codec.info_size, codec.parity_size
    data = rng.integers(0, 256, (B, k), dtype=np.uint8)
    enc, enc_ref = codec.encode(data), ref.encode(data)
    assert_same(enc, enc_ref, ("data", "parity"))
    bits = np.unpackbits(np.concatenate([data, enc.parity.numpy()], axis=1), axis=1)
    for i in range(B):
        bits[i, rng.choice(bits.shape[1], i % (codec._bch.t + 3), replace=False)] ^= 1
    word = np.packbits(bits, axis=1)
    bad, bad_par = word[:, :k], word[:, k:]
    got, want = codec.decode(bad, bad_par), ref.decode(bad, bad_par)
    assert_same(got, want, ("ok", "data", "parity", "corrected"))
    assert_same([codec.last_num_errors, codec.last_corrected],
                [ref.last_num_errors, ref.last_corrected], ("last_num_errors", "last_corrected"))
    got, want = codec.decode(bad[3], bad_par[3]), ref.decode(bad[3], bad_par[3])
    assert_same(got, want, ("ok", "data", "parity", "corrected"))
    assert_same([codec.last_num_errors, codec.last_corrected],
                [ref.last_num_errors, ref.last_corrected], ("last_num_errors", "last_corrected"))
    assert codec.last_num_errors.shape == (1,) and codec.last_corrected.ndim == 0
    got, want = codec.encode(data[5]), ref.encode(data[5])
    assert_same(got, want, ("data", "parity"))


def test_facade_f7_rows_longer_than_data_bytes():
    """F7: rows longer than data_bytes.  BCH(15,5) (1 data byte) broadcasts
    the corrected byte over the row; BCH(31,21) (3 data bytes) with 4-byte
    rows raises ValueError in both packages."""
    ref, codec = jpp.create(jpp.bch_config_default()), pt.create(pt.bch_config_default(),
                                                                  device="cpu")
    data = np.array([[5, 7, 9]], np.uint8)
    enc, enc_ref = codec.encode(data), ref.encode(data)
    assert_same(enc, enc_ref, ("data", "parity"))
    got, want = codec.decode(data, enc.parity), ref.decode(data, enc.parity.numpy())
    assert_same(got, want, ("ok", "data", "parity", "corrected"))
    assert got.data.tolist() == [[5, 5, 5]]
    cfg = (5, 0x25, 2)
    ref, codec = jpp.create(jpp.BchConfig(*cfg)), pt.create(pt.BchConfig(*cfg), device="cpu")
    data = np.arange(8, dtype=np.uint8).reshape(2, 4)
    parity = codec.encode(data).parity
    assert_same([parity], [ref.encode(data).parity], ["parity"])
    with pytest.raises(ValueError, match="Incompatible shapes"):
        ref.decode(data, parity.numpy())
    with pytest.raises(ValueError, match="Incompatible shapes"):
        codec.decode(data, parity)


def test_facade_short_inputs():
    """Data shorter than data_bytes raises ValueError in both; parity bytes
    short of parity_bits read as the JAX package reads them; no parity
    byte at all raises (IndexError in JAX, ValueError here)."""
    cfg = (5, 0x25, 2)
    ref, codec = jpp.create(jpp.BchConfig(*cfg)), pt.create(pt.BchConfig(*cfg), device="cpu")
    short = np.zeros((2, 2), np.uint8)
    for c in (ref, codec):
        with pytest.raises(ValueError, match="too short"):
            c.encode(short)
        with pytest.raises(ValueError, match="too short"):
            c.decode(short, np.zeros((2, 2), np.uint8))
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (8, 3), dtype=np.uint8)
    par = rng.integers(0, 256, (8, 1), dtype=np.uint8)
    assert_same(codec.decode(data, par), ref.decode(data, par), ("ok", "data", "parity",
                                                                 "corrected"))
    assert_same([codec._bch.pack_parity(par)], [ref._bch.pack_parity(par)], ["bits"])
    with pytest.raises(IndexError):
        ref.decode(data, np.zeros((8, 0), np.uint8))
    with pytest.raises(ValueError):
        codec.decode(data, np.zeros((8, 0), np.uint8))
