"""The port's RSCodec against the JAX package's XLA path on configs other
than the default: fcr = 0 (the uint16 `sec` truncation), prim = 2 (a
nontrivial `prim_inv`), 16 roots, and two configs outside the CUDA
kernel's gate that always run the plain version: 127 roots (the
fec_compat config of tests/test_oracle_compat.py) and GF(16).  Exact
equality on every output.  Last, the non-primitive polynomial 0x11B
(ROADMAP F8), where the two packages' GF products differ.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import RSCodec  # noqa: E402
from libpoporon_tpu_torch.models.rs_cuda import RSCudaDecoder  # noqa: E402

from test_torch_rs import assert_same, erasure_batch, mixed_batch  # noqa: E402

torch.set_num_threads(2)

CONFIGS = {
    "fcr0": {"first_consecutive_root": 0},
    "prim2": {"primitive_element": 2},
    "nr16": {"num_roots": 16},
    "nr127": {"num_roots": 127},
    "gf16": {"symbol_size": 4, "generator_polynomial": 0x13, "num_roots": 4},
}
_CODECS = {}


def _codecs(name):
    """(port, JAX) codecs per config, built once per module."""
    if name not in _CODECS:
        kw = CONFIGS[name]
        _CODECS[name] = (RSCodec(RSConfig(**kw), "cpu"),
                         JaxRSCodec(JaxRSConfig(use_pallas="off", **kw)))
    return _CODECS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("path", ["plain", "erasure", "ext"])
def test_decode_matches_jax(name, path):
    rs, jax_rs = _codecs(name)
    rng = np.random.default_rng(len(name) * 7 + len(path))
    data = rng.integers(0, 256, (96, rs.k), dtype=np.uint8)
    parity = rs.encode(data).numpy()
    assert np.array_equal(parity, np.asarray(jax_rs.encode(data)))
    if path == "erasure":
        bad, pos, cnt = erasure_batch(rng, data, 5, 2)
        assert_same(rs.decode(bad, parity, erasures=(pos, cnt)),
                    jax_rs._decode_erasure(bad, parity, pos, cnt))
        return
    bad, pbad = mixed_batch(rng, data, parity)
    if path == "plain":
        assert_same(rs.decode(bad, pbad), jax_rs._decode_plain(bad, pbad))
        return
    s = rs._syndrome(torch.from_numpy(bad), torch.from_numpy(pbad))
    s_log = rs.exp2log[s.long()].numpy()
    assert_same(rs.decode(bad, pbad, ext_syndrome=s_log),
                jax_rs._decode_ext_syndrome(bad, pbad, s_log))



@pytest.mark.parametrize("path", ["plain", "erasure", "ext"])
def test_nonprimitive_polynomial(path):
    """RSConfig(generator_polynomial=0x11B) (ROADMAP F8): x has order 51 in
    that field, so the log table repeats.  Both packages build the codec
    and encode alike, and every row fails, clean rows included, with ok,
    data, parity and the corrected counts equal on every path: the port's
    plain version multiplies carry-less there, as the JAX package does.
    The CUDA kernel's gate leaves such a field to the plain version."""
    kw = {"generator_polynomial": 0x11B}
    rs, jax_rs = RSCodec(RSConfig(**kw), "cpu"), JaxRSCodec(JaxRSConfig(use_pallas="off", **kw))
    assert not RSCudaDecoder.supports(rs) and RSCudaDecoder.supports(RSCodec(RSConfig(), "cpu"))
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (64, rs.k), dtype=np.uint8)
    parity = rs.encode(data).numpy()
    assert np.array_equal(parity, np.asarray(jax_rs.encode(data)))
    # clean rows, then 0..t+1 errors, parity-only errors and junk rows
    bad, pbad = mixed_batch(rng, data, parity)
    bad, pbad = np.concatenate([data, bad]), np.concatenate([parity, pbad])
    if path == "plain":
        got, want = rs.decode(bad, pbad), jax_rs._decode_plain(bad, pbad)
    elif path == "ext":
        s = rs._syndrome(torch.from_numpy(bad), torch.from_numpy(pbad))
        s_log = rs.exp2log[s.long()].numpy()
        got = rs.decode(bad, pbad, ext_syndrome=s_log)
        want = jax_rs._decode_ext_syndrome(bad, pbad, s_log)
    else:
        bad, pos, cnt = erasure_batch(rng, np.concatenate([data, data]), 8, 2)
        got = rs.decode(bad, pbad, erasures=(pos, cnt))
        want = jax_rs._decode_erasure(bad, pbad, pos, cnt)
    assert not np.asarray(want[0]).any()
    assert_same(got, want)
