"""The port's StreamCodec (codecs on the CPU) against the JAX package's, on
the JAX stream tests' cases: the blobs must be byte-equal, and decoding
either package's blob gives the same payload and stats."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import libpoporon_tpu as jpp  # noqa: E402
from libpoporon_tpu.stream import StreamCodec as JaxStreamCodec  # noqa: E402

import libpoporon_tpu_torch as pt  # noqa: E402
from libpoporon_tpu_torch.stream import StreamCodec  # noqa: E402

torch.set_num_threads(2)


def pair(jax_cfg, cfg):
    return JaxStreamCodec(jpp.create(jax_cfg)), StreamCodec(pt.create(cfg, device="cpu"))


@pytest.fixture(scope="module")
def rs_pair():
    return pair(jpp.rs_config_default(), pt.rs_config_default())


@pytest.mark.parametrize("n", [0, 1, 100, 223, 5000])
def test_rs_stream_roundtrip(rs_pair, n):
    ref, sc = rs_pair
    payload = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    blob = sc.encode_stream(payload)
    assert blob == ref.encode_stream(payload)
    out, stats = sc.decode_stream(blob)
    assert (out, stats) == ref.decode_stream(blob)
    assert out == payload and stats["blocks_failed"] == 0


def test_rs_stream_corrects_errors(rs_pair):
    ref, sc = rs_pair
    rng = np.random.default_rng(0)
    payload = bytes(rng.integers(0, 256, 2000, dtype=np.uint8))
    blob = bytearray(sc.encode_stream(payload))
    bs = sc.block_size
    for blk in range(len(blob) // bs):     # a few corrupted bytes in each block
        for _ in range(4):
            blob[blk * bs + int(rng.integers(0, bs))] ^= 0x5A
    out, stats = sc.decode_stream(bytes(blob))
    assert (out, stats) == ref.decode_stream(bytes(blob))
    assert out == payload and stats["corrected"] > 0


def test_ldpc_stream_roundtrip():
    ref, sc = pair(jpp.LdpcConfig(block_size=64, rate=jpp.LdpcRate.RATE_1_2),
                   pt.LdpcConfig(block_size=64, rate=pt.LdpcRate.RATE_1_2))
    payload = b"hello poporon tpu" * 40
    blob = sc.encode_stream(payload)
    assert blob == ref.encode_stream(payload)
    out, stats = sc.decode_stream(blob)
    assert (out, stats) == ref.decode_stream(blob)
    assert out == payload


def test_bch_stream_roundtrip():
    """BCH(31,21): 3 info bytes a block whose top 3 bits the code does not
    carry, so only a payload that leaves them 0 round-trips; both packages
    return the same bytes either way."""
    cfg = (5, 0x25, 2)
    ref, sc = pair(jpp.BchConfig(*cfg), pt.BchConfig(*cfg))
    payload = bytes(np.random.default_rng(3).integers(0, 256, 50, dtype=np.uint8))
    blob = sc.encode_stream(payload)
    assert blob == ref.encode_stream(payload)
    assert sc.decode_stream(blob) == ref.decode_stream(blob)


def test_decode_kw_and_framing_errors(rs_pair):
    """decode_kw reaches the codec (erasures here); a blob that is not a
    whole number of blocks, or whose header claims too much, raises
    ValueError in both."""
    ref, sc = rs_pair
    payload = bytes(range(200))
    blob = bytearray(sc.encode_stream(payload))
    blob[8 + 17] ^= 0xFF                    # payload byte 17 of block 0
    kw = {"erasures": np.array([25], np.int32)}
    out = sc.decode_stream(bytes(blob), **kw)
    assert out == ref.decode_stream(bytes(blob), **kw)
    assert out[0] == payload and out[1]["corrected"] == 1
    for c in (ref, sc):
        with pytest.raises(ValueError, match="not a multiple"):
            c.decode_stream(bytes(blob[:-1]))
    huge = sc.encode_stream(b"")
    bad = bytearray(huge)
    bad[0:8] = (10**6).to_bytes(8, "little")
    bad_blob = bytes(bad[:223]) + pt.create(pt.rs_config_default(), device="cpu").encode(
        np.frombuffer(bytes(bad[:223]), np.uint8)).parity.numpy().tobytes()
    for c in (ref, sc):
        with pytest.raises(ValueError, match="corrupt stream header"):
            c.decode_stream(bad_blob)
