"""The port's RS slice end to end through its facade, against the JAX
package's facade on the same inputs, plus the port's device and import
rules (its measurement modules included).  Exact equality on every output.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import libpoporon_tpu as jpp  # noqa: E402

import libpoporon_tpu_torch as pt  # noqa: E402

from test_torch_rs import assert_same  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def test_main_path_matches_jax():
    """create(rs_config_default()) -> encode -> flip 2 symbols -> decode,
    at B = 256, as bench.py's headline workload does."""
    B = 256
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    codec, ref = pt.create(pt.rs_config_default(), device="cpu"), jpp.create(jpp.rs_config_default())
    enc, enc_ref = codec.encode(data), ref.encode(data)
    assert codec.device == torch.device("cpu")
    assert np.array_equal(enc.data.numpy(), np.asarray(enc_ref.data))
    assert np.array_equal(enc.parity.numpy(), np.asarray(enc_ref.parity))
    rows = np.arange(B)
    pos0 = rng.integers(0, 223, B)
    pos1 = (pos0 + rng.integers(1, 223, B)) % 223
    bad = data.copy()
    bad[rows, pos0] ^= 0x55
    bad[rows, pos1] ^= 0xAA
    res = codec.decode(bad, enc.parity)
    assert_same(res, ref.decode(bad, np.asarray(enc_ref.parity)))
    assert res.ok.all() and (res.corrected == 2).all()
    assert np.array_equal(res.data.numpy(), data)
    assert codec.last_corrected is res.corrected


def test_getters_and_erasure_object_match_jax():
    codec, ref = pt.create(pt.rs_config_default(), device="cpu"), jpp.create(jpp.rs_config_default())
    assert (codec.parity_size, codec.info_size) == (ref.parity_size, ref.info_size)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 223, dtype=np.uint8)
    parity = codec.encode(data).parity
    positions = [3, 50, 51, 222]
    bad = data.copy()
    bad[positions] ^= 0x0F
    got = codec.decode(bad, parity,
                       erasures=pt.Erasure.from_positions(32, positions))
    want = ref.decode(bad, parity.numpy(),
                      erasures=jpp.Erasure.from_positions(32, positions))
    assert_same(got, want)
    assert bool(got.ok) and np.array_equal(got.data.numpy(), data)


def test_ldpc_and_bch_not_ported_yet():
    """LDPC and BCH configs (BCH since the slice that ported it, under this
    test's old name) create codecs on the CPU with the JAX facade's sizes;
    an unknown config raises TypeError."""
    ldpc = pt.create(pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), device="cpu")
    assert ldpc.fec_type == pt.FecType.LDPC and ldpc.device == torch.device("cpu")
    bch, ref = pt.create(pt.bch_config_default(), device="cpu"), jpp.create(jpp.bch_config_default())
    assert bch.fec_type == pt.FecType.BCH and bch.device == torch.device("cpu")
    assert (bch.info_size, bch.parity_size) == (ref.info_size, ref.parity_size) == (1, 2)
    with pytest.raises(TypeError):
        pt.create(object(), device="cpu")


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.create(pt.rs_config_default(), device="cuda")


def test_default_device_is_the_card():
    """With no device, create targets the card: on a host without one it
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert pt.create(pt.rs_config_default()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.create(pt.rs_config_default())


def test_import_leaves_jax_out():
    code = ("import sys, libpoporon_tpu_torch, "
            "libpoporon_tpu_torch.benchmarks.probe_dma, "
            "libpoporon_tpu_torch.benchmarks.waterfall, "
            "libpoporon_tpu_torch.utils.faults, libpoporon_tpu_torch.utils.profiling, "
            "libpoporon_tpu_torch.compat, libpoporon_tpu_torch.stream, "
            "libpoporon_tpu_torch.models.bch; "
            "bad = [m for m in ('jax', 'libpoporon_tpu') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
