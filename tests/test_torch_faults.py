"""The port's fault injection (libpoporon_tpu_torch/utils/faults.py, a
copy) against the JAX package's: equal outputs for the same seeds."""

import numpy as np
import pytest

pytest.importorskip("jax")

from libpoporon_tpu.utils import faults as jfaults  # noqa: E402

from libpoporon_tpu_torch.utils import faults  # noqa: E402

SEEDS = (0, 7, 12345)


def assert_same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def data(seed, shape):
    return np.random.default_rng(seed + 1000).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pattern", [0xFF, 0x21, None])
def test_break_data(seed, pattern):
    d = data(seed, (9, 223))
    assert_same(faults.break_data(d, 5, seed, pattern), jfaults.break_data(d, 5, seed, pattern))


@pytest.mark.parametrize("seed", SEEDS)
def test_break_data_erasure(seed):
    d = data(seed, (7, 100))
    got, want = faults.break_data_erasure(d, 12, seed), jfaults.break_data_erasure(d, 12, seed)
    assert_same(got, want)
    assert (np.diff(got[1], axis=1) > 0).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_flip_bits(seed):
    d = data(seed, (6, 256))
    assert_same(faults.flip_bits(d, 4, 2048, seed), jfaults.flip_bits(d, 4, 2048, seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("snr_db", [0.0, 3.0, 6.5])
def test_awgn_llrs(seed, snr_db):
    bits = np.random.default_rng(seed).integers(0, 2, (5, 2048), dtype=np.uint8)
    got = faults.awgn_llrs(bits, snr_db, seed)
    assert_same(got, jfaults.awgn_llrs(bits, snr_db, seed))
    assert got.dtype == np.int8


def test_generator_argument():
    """A Generator passed in is drawn from, as in the JAX copy."""
    d = data(3, (4, 50))
    g1, g2 = np.random.default_rng(99), np.random.default_rng(99)
    assert_same(faults.break_data(d, 3, g1, None), jfaults.break_data(d, 3, g2, None))
    assert_same(faults.flip_bits(d, 2, 400, g1), jfaults.flip_bits(d, 2, 400, g2))
