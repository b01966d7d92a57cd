"""The port's host core against the JAX package: GF tables, the bit-linear
matrix builder, gf2_matmul, gf_mul and the RS host arrays.

Every output is an integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402
from libpoporon_tpu.ops import gf as jax_gf  # noqa: E402
from libpoporon_tpu.ops.gf2 import gf2_matmul as jax_gf2_matmul  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import ARRAY_NAMES, host_arrays  # noqa: E402
from libpoporon_tpu_torch.ops import gf  # noqa: E402
from libpoporon_tpu_torch.ops.gf2 import gf2_matmul  # noqa: E402
from libpoporon_tpu_torch.ops.gfint import gf_mul  # noqa: E402

torch.set_num_threads(2)

POLYS = [(4, 0x13), (5, 0x25), (6, 0x43), (8, 0x11D)]


@pytest.mark.parametrize("m,poly", POLYS)
def test_gf_tables_match_jax(m, poly):
    ours, ref = gf.GF(m, poly), jax_gf.GF(m, poly)
    assert ours.field_size == ref.field_size
    assert np.array_equal(ours.log2exp, ref.log2exp)
    assert np.array_equal(ours.exp2log, ref.exp2log)
    assert ours.log2exp.dtype == ref.log2exp.dtype


@pytest.mark.parametrize("m,poly", [(0, 0x11D), (17, 0x11D), (8, 0x101)])
def test_gf_rejects_like_jax(m, poly):
    with pytest.raises(jax_gf.GFError):
        jax_gf.GF(m, poly)
    with pytest.raises(gf.GFError):
        gf.GF(m, poly)


@pytest.mark.parametrize("m,poly", POLYS)
def test_linear_matrix_matches_jax(m, poly):
    rng = np.random.default_rng(m)
    consts = rng.integers(0, 1 << m, (5, 7))
    assert np.array_equal(gf.GF(m, poly).linear_matrix(consts),
                          jax_gf.GF(m, poly).linear_matrix(consts))


def test_gf2_matmul_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2, (64, 2040)).astype(np.uint8)
    mat = rng.integers(0, 2, (2040, 256)).astype(np.uint8)
    want = np.asarray(jax_gf2_matmul(x, mat))
    got = gf2_matmul(torch.from_numpy(x), torch.from_numpy(mat))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,poly", POLYS)
def test_gf_mul_exhaustive(m, poly):
    field = gf.GF(m, poly)
    n = field.field_size + 1
    a = torch.arange(n, dtype=torch.int32)[:, None]
    b = torch.arange(n, dtype=torch.int32)[None, :]
    log = torch.from_numpy(field.exp2log.astype(np.int32))
    antilog = torch.from_numpy(field.log2exp.astype(np.int32))
    got = gf_mul(a, b, log, antilog).numpy()
    ref = jax_gf.GF(m, poly)
    want = np.array([[ref.mul(x, y) for y in range(n)] for x in range(n)])
    assert np.array_equal(got, want)


RS_CONFIGS = {
    "default": {},
    "fcr0": {"first_consecutive_root": 0},
    "prim2": {"primitive_element": 2},
    "nr16": {"num_roots": 16},
}


@pytest.mark.parametrize("name", sorted(RS_CONFIGS))
def test_rs_host_arrays_match_jax(name):
    kw = RS_CONFIGS[name]
    ref = JaxRSCodec(JaxRSConfig(use_pallas="off", **kw))
    want = {n: np.asarray(getattr(ref, n)) for n in ARRAY_NAMES
            if n not in ("log2exp", "exp2log")}
    want["log2exp"], want["exp2log"] = ref.gf.log2exp, ref.gf.exp2log
    got = host_arrays(RSConfig(**kw))
    assert set(got) == set(ARRAY_NAMES)
    for n in ARRAY_NAMES:
        assert got[n].shape == want[n].shape, n
        assert np.array_equal(got[n], want[n]), n
