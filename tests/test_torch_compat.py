"""The port's C-shaped shim (libpoporon_tpu_torch.compat, handles on the
CPU) against the JAX package's shim on the same buffers.

Every `poporon_*` function is driven on both shims with copies of the same
NumPy buffers: return values and the buffers they mutate must be equal.
The inputs the C API rejects give None, False or (False, 0) in both; two
documented differences (wrong-width LDPC parity, a 1-byte parity in the
RS external-syndrome config) give (False, 0) here.  Errors other than
rejections (a missing card, a kernel failure) propagate from the port's
shim.  F4: one codeword's buffers give the facade's result; a batch gives
the JAX shim's reduction.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import libpoporon_tpu.compat as J  # noqa: E402

import libpoporon_tpu_torch as pt  # noqa: E402
import libpoporon_tpu_torch.compat as T  # noqa: E402

torch.set_num_threads(2)

NAMES = sorted(n for n in dir(J) if n.startswith(("poporon_", "POPORON_", "XOSHIRO")))


def create(m, cfg):
    return m.poporon_create(cfg) if m is J else m.poporon_create(cfg, device="cpu")


def both(fn_name, make_cfg, *args):
    """fn_name on a fresh handle of each shim, with copies of args (NumPy
    buffers among them); returns [(result or exception name, buffers)]."""
    out = []
    for m in (J, T):
        h = create(m, make_cfg(m))
        bufs = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        try:
            r = getattr(m, fn_name)(h, *bufs)
        except Exception as e:   # noqa: BLE001 -- compared between the shims
            r = type(e).__name__
        out.append((r, [b.tolist() for b in bufs if isinstance(b, np.ndarray)]))
    return out


def syndrome_of(data, parity):
    """Log-form syndromes [32] of one RS(255,223) word, from the port."""
    rs = pt.create(pt.rs_config_default(), device="cpu")._rs
    s = rs._syndrome(torch.as_tensor(data[None]), torch.as_tensor(parity[None]))
    return rs.exp2log[s.long()][0].numpy().astype(np.uint16)


def test_every_name_and_constant():
    assert NAMES and all(hasattr(T, n) for n in NAMES)
    for n in NAMES:
        if n.isupper():
            assert getattr(T, n) == getattr(J, n), n
    assert T.poporon_version_id() == J.poporon_version_id()
    assert T.poporon_buildtime() == J.poporon_buildtime()
    for m in (J, T):
        for fn in ("poporon_config_destroy", "poporon_destroy", "poporon_rng_destroy",
                   "poporon_erasure_destroy"):
            assert getattr(m, fn)(None) is None


@pytest.mark.parametrize("make", [
    lambda m: m.poporon_config_rs_default(),
    lambda m: m.poporon_rs_config_create(8, 0x11D, 0, 2, 16, None, [1, 2, 3]),
    lambda m: m.poporon_config_ldpc_default(256, m.POPORON_LDPC_RATE_2_3),
    lambda m: m.poporon_config_ldpc_burst_resistant(128, m.POPORON_LDPC_RATE_1_2),
    lambda m: m.poporon_ldpc_config_create(64, 0, 2, 4, True, False, True, 3, 8, 20,
                                           np.arange(300) - 150, 256, 7),
    lambda m: m.poporon_config_bch_default(),
    lambda m: m.poporon_bch_config_create(5, 0x25, 2),
], ids=["rs_default", "rs_syndrome", "ldpc_default", "ldpc_burst", "ldpc_create", "bch_default",
        "bch_create"])
def test_config_constructors(make):
    want, got = make(J), make(T)
    for f in dataclasses.fields(got.inner):
        if hasattr(want.inner, f.name):
            assert getattr(got.inner, f.name) == getattr(want.inner, f.name), f.name
    assert type(got.inner).__name__ == type(want.inner).__name__
    for attr in ("syndrome", "soft_llr"):
        w, g = getattr(want, attr), getattr(got, attr)
        assert (w is None and g is None) or (g.dtype == w.dtype and np.array_equal(g, w)), attr


@pytest.mark.parametrize("make", [
    lambda m: None,
    lambda m: object(),
    lambda m: m.poporon_rs_config_create(0, 0x11D, 1, 1, 32),
    lambda m: m.poporon_rs_config_create(8, 0x11D, 1, 0, 32),
    lambda m: m.poporon_rs_config_create(8, 0x11D, 1, 1, 255),
    lambda m: m.poporon_rs_config_create(8, 0x11D, 1, 1, 0),
    lambda m: m.poporon_rs_config_create(8, 0x11C, 1, 1, 32),
    lambda m: m.poporon_ldpc_config_create(20, 1, 1, 3, False, False, False, 0, 0, 0, None, 0, 0),
    lambda m: m.poporon_ldpc_config_create(9000, 1, 1, 3, False, False, False, 0, 0, 0, None, 0,
                                           0),
    lambda m: m.poporon_bch_config_create(2, 0x7, 1),
    lambda m: m.poporon_bch_config_create(4, 0x13, 0),
    lambda m: m.poporon_bch_config_create(4, 0x13, 17),
], ids=["none", "not_a_config", "rs_m0", "rs_prim0", "rs_nr255", "rs_nr0", "rs_not_primitive",
        "ldpc_20B", "ldpc_9000B", "bch_m2", "bch_t0", "bch_t17"])
def test_create_rejects_as_jax(make):
    assert create(J, make(J)) is None
    h = create(T, make(T))
    assert h is None
    assert T.poporon_get_fec_type(h) == J.poporon_get_fec_type(None) == T.POPORON_FEC_UNKNOWN
    for fn in ("poporon_get_parity_size", "poporon_get_info_size", "poporon_get_iterations_used"):
        assert getattr(T, fn)(h) == getattr(J, fn)(None) == 0


def test_create_raises_without_a_card():
    """A missing card is not a rejection: the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.poporon_create(T.poporon_config_rs_default())


def test_errors_other_than_rejections_propagate():
    h = T.poporon_create(T.poporon_config_rs_default(), device="cpu")

    def fail(*args, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")

    h.codec.encode = h.codec.decode = fail
    data, parity = np.zeros(223, np.uint8), np.zeros(32, np.uint8)
    with pytest.raises(RuntimeError, match="launch failure"):
        T.poporon_encode(h, data, 223, parity)
    with pytest.raises(RuntimeError, match="launch failure"):
        T.poporon_decode(h, data, 223, parity)


RS = lambda m: m.poporon_config_rs_default()  # noqa: E731
LDPC = lambda m: m.poporon_config_ldpc_default(128, m.POPORON_LDPC_RATE_1_2)  # noqa: E731
BCH = lambda m: m.poporon_config_bch_default()  # noqa: E731
BCH31 = lambda m: m.poporon_bch_config_create(5, 0x25, 2)  # noqa: E731
LDPC64 = lambda m: m.poporon_ldpc_config_create(  # noqa: E731
    64, 1, 1, 3, False, False, False, 0, 0, 0, None, 0, 0)

# name -> (config to encode with, data bytes, errors: bytes for RS, bits else)
CASES = {
    "rs": (RS, 223, 3),
    "rs_erasure": (RS, 223, 3),
    "rs_syndrome": (RS, 223, 5),
    "ldpc": (LDPC, 128, 3),
    "ldpc_soft": (LDPC, 128, 0),
    "bch": (BCH, 1, 3),
    "bch31": (BCH31, 3, 2),
}


def decode_config(name, bad, parity, rng):
    """The config a case decodes with: the encode config, or one carrying
    the erasures, the word's external syndromes or its channel LLRs."""
    if name == "rs_erasure":
        return lambda m: m.poporon_rs_config_create(
            8, 0x11D, 1, 1, 32, m.poporon_erasure_create_from_positions(32, [3, 10, 200]))
    if name == "rs_syndrome":
        syn = syndrome_of(bad, parity)
        return lambda m: m.poporon_rs_config_create(8, 0x11D, 1, 1, 32, None, syn)
    if name == "ldpc_soft":
        bits = np.unpackbits(np.concatenate([bad, parity]))
        llr = np.where(bits == 1, -60, 60) + rng.normal(0, 25, bits.size)
        llr = np.clip(np.round(llr), -127, 127).astype(np.int8)
        return lambda m: m.poporon_ldpc_config_create(128, 1, 1, 3, True, True, True, 0, 0, 0,
                                                      llr, 2048, 0)
    return CASES[name][0]


@pytest.mark.parametrize("name", CASES)
def test_one_codeword_round_trip(name):
    """Encode (parity, and data for interleaved LDPC, mutated in place),
    corrupt, decode in place: equal returns and buffers in both shims, the
    getters equal after the decode, and the C result of one codeword equal
    to the facade's at B = 1."""
    make, k, nerr = CASES[name]
    rng = np.random.default_rng(len(name))
    data = rng.integers(0, 256, k, dtype=np.uint8)
    if name.startswith("bch"):      # the bits of the data word only
        data[0] &= (1 << (create(T, make(T)).codec._bch.data_length - 8 * (k - 1))) - 1
    parity = np.zeros(create(T, make(T)).codec.parity_size, np.uint8)
    (rj, bj), (rt, bt) = both("poporon_encode", make, data, k, parity)
    assert rj is True and rt is True and bj == bt
    sent, parity = np.array(bt[0], np.uint8), np.array(bt[1], np.uint8)
    bad = sent.copy()
    if name == "rs_erasure":
        bad[[3, 10, 200]] ^= 0x5A
    elif name.startswith("rs"):
        bad[rng.choice(k, nerr, replace=False)] ^= 0x11
    elif name.startswith("bch"):    # bit j of the data word, big-endian bytes
        for j in rng.choice(create(T, make(T)).codec._bch.data_length, nerr, replace=False):
            bad[k - 1 - j // 8] ^= 1 << (j % 8)
    else:
        bits = np.unpackbits(bad)
        bits[rng.choice(bits.size, nerr, replace=False)] ^= 1
        bad = np.packbits(bits)
    make = decode_config(name, bad, parity, rng)
    (rj, bj), (rt, bt) = both("poporon_decode", make, bad, k, parity)
    assert rj == rt and bj == bt
    assert rt[0] and bt[0] == data.tolist()

    h_j, h_t = create(J, make(J)), create(T, make(T))
    J.poporon_decode(h_j, bad.copy(), k, parity.copy())
    T.poporon_decode(h_t, bad.copy(), k, parity.copy())
    for fn in ("poporon_get_fec_type", "poporon_get_parity_size", "poporon_get_info_size",
               "poporon_get_iterations_used"):
        assert getattr(T, fn)(h_t) == getattr(J, fn)(h_j), fn
    kw = {}
    if name == "rs_erasure":
        kw["erasures"] = h_t.erasure
    elif name == "rs_syndrome":
        kw["ext_syndrome"] = h_t.syndrome.astype(np.int32)
    elif name == "ldpc_soft":
        kw["soft_llr"] = h_t.soft_llr
    res = h_t.codec.decode(bad, parity, **kw)
    assert rt == (bool(res.ok), int(res.corrected))
    assert bt[0] == res.data.tolist()


# (config, function, data bytes, size, parity bytes) that the C API rejects
REJECTED = {
    "encode_ldpc_size": (LDPC, "poporon_encode", 100, 100, 128),
    "encode_bch31_short": (BCH31, "poporon_encode", 2, 2, 2),
    "encode_rs_past_k": (RS, "poporon_encode", 224, 224, 32),
    "decode_size_0": (RS, "poporon_decode", 223, 0, 32),
    "decode_rs_parity_31": (RS, "poporon_decode", 223, 223, 31),
    "decode_rs_parity_0": (RS, "poporon_decode", 1, 1, 0),
    "decode_ldpc_size": (LDPC, "poporon_decode", 100, 100, 128),
    "decode_ldpc64_short_parity": (LDPC64, "poporon_decode", 64, 64, 63),
    "decode_bch31_short": (BCH31, "poporon_decode", 2, 2, 2),
    "decode_bch_no_parity": (BCH, "poporon_decode", 1, 1, 0),
    "decode_bch31_f7": (BCH31, "poporon_decode", 4, 4, 2),
}


@pytest.mark.parametrize("name", REJECTED)
def test_rejected_inputs_as_jax(name):
    make, fn, dlen, size, plen = REJECTED[name]
    rng = np.random.default_rng(dlen + plen)
    data = rng.integers(0, 256, dlen, dtype=np.uint8)
    parity = rng.integers(0, 256, plen, dtype=np.uint8)
    (rj, bj), (rt, bt) = both(fn, make, data, size, parity)
    assert rj in (False, (False, 0))
    assert rt == rj and bt == bj


def test_null_arguments():
    for m in (J, T):
        h = create(m, RS(m))
        buf, par = np.zeros(223, np.uint8), np.zeros(32, np.uint8)
        for args in ((None, buf, 223, par), (h, None, 223, par), (h, buf, 223, None)):
            assert m.poporon_encode(*args) is False
            assert m.poporon_decode(*args) == (False, 0)
        assert m.poporon_get_iterations_used(h) == 0


def test_documented_differences():
    """Wrong-width LDPC parity: JAX decodes garbage gathered past the word
    (ok False, a nonzero count), the port rejects it; both leave the
    buffers as they were.  A 1-byte parity in the RS external-syndrome
    config: JAX decodes by broadcasting and then fails to write 32 parity
    bytes into the 1-byte buffer (ValueError), the port rejects it."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 128, dtype=np.uint8)
    for plen in (127, 131):
        parity = rng.integers(0, 256, plen, dtype=np.uint8)
        (rj, bj), (rt, bt) = both("poporon_decode", LDPC, data, 128, parity)
        assert rj[0] is False and rj[1] > 0 and rt == (False, 0) and bt == bj
    syn = np.full(32, 255, np.uint16)
    syn[0] = 7
    make = lambda m: m.poporon_rs_config_create(8, 0x11D, 1, 1, 32, None, syn)  # noqa: E731
    (rj, _), (rt, _) = both("poporon_decode", make, data[:100], 100, data[:1])
    assert rj == "ValueError" and rt == (False, 0)


def test_f4_batch_reduction():
    """F4: 2-D buffers of B rows with size = B decode every row and return
    (all ok, largest count), as the JAX shim does, equal to the facade's
    reduction; size < B gives (False, 0) in both; one row of the batch
    alone gives its C result."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (4, 223), dtype=np.uint8)
    parity = pt.create(pt.rs_config_default(), device="cpu").encode(data).parity.numpy()
    bad = data.copy()
    for i, nerr in enumerate((0, 2, 7, 40)):
        bad[i, rng.choice(223, nerr, replace=False)] ^= 0x33
    for rows in (3, 4):
        (rj, bj), (rt, bt) = both("poporon_decode", RS, bad[:rows], rows, parity[:rows])
        assert rj == rt and bj == bt
        res = pt.create(pt.rs_config_default(), device="cpu").decode(bad[:rows], parity[:rows])
        assert rt == (bool(res.ok.all()), int(res.corrected.max()))
        assert bt[0] == res.data.tolist()
    assert rt == (False, 7) and bt[0][:3] == data[:3].tolist()
    (rj, bj), (rt, bt) = both("poporon_decode", RS, bad, 3, parity)
    assert rj == rt == (False, 0) and bj == bt
    (rj, _), (rt, _) = both("poporon_decode", RS, bad[2], 223, parity[2])
    assert rj == rt == (True, 7)


def test_rng():
    for seed, seed_size in ((0, None), (12345, None), (b"\x01\x02\x03\x04\x05", 3),
                            (b"\xff\xfe", None)):
        rj = J.poporon_rng_create(J.XOSHIRO128PP, seed, seed_size)
        rt = T.poporon_rng_create(T.XOSHIRO128PP, seed, seed_size)
        for size in (1, 7, 64, 0, 5):
            assert T.poporon_rng_next(rt, size) == J.poporon_rng_next(rj, size)
    assert T.poporon_rng_next(None, 4) is J.poporon_rng_next(None, 4) is None


def test_erasure_functions():
    out = []
    for m in (J, T):
        e = m.poporon_erasure_create(32, 0)
        log = [e.capacity]
        for pos in (3, 10, 200):
            log.append(m.poporon_erasure_add_position(e, pos))
        log += [e.positions.tolist(), e.count]
        m.poporon_erasure_reset(e)
        m.poporon_erasure_reset(None)
        log += [e.positions.tolist(), m.poporon_erasure_add_position(None, 1)]
        f = m.poporon_erasure_create_from_positions(32, [5, 6, 7, 8], 3)
        log += [f.positions.tolist(), f.capacity, m.poporon_erasure_create(16, 40).capacity]
        log += [m.poporon_erasure_create_from_positions(32, p, c)
                for p, c in ((None, None), ([1, 2], 0), ([], None))]
        out.append(log)
    assert out[0] == out[1]
    assert out[1][-3:] == [None, None, None]
