"""The port's LDPC host side against the JAX package: the xoshiro /
splitmix streams, MSB-first bit packing, and every array of
`LdpcStructure` and its decoder layout.  Exact equality throughout.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import libpoporon_tpu.config as jcfg  # noqa: E402
from libpoporon_tpu.models.ldpc import get_structure as jax_structure  # noqa: E402
from libpoporon_tpu.utils import bits as jbits  # noqa: E402
from libpoporon_tpu.utils.rng import Xoshiro128pp as JaxXoshiro  # noqa: E402

import libpoporon_tpu_torch.config as pcfg  # noqa: E402
from libpoporon_tpu_torch.models.ldpc import (  # noqa: E402
    ARRAY_NAMES, LdpcStructure, get_structure)
from libpoporon_tpu_torch.utils import bits  # noqa: E402
from libpoporon_tpu_torch.utils.rng import Xoshiro128pp  # noqa: E402

torch.set_num_threads(2)

R12 = dict(block_size=128, rate=1)
# name -> LdpcConfig keywords (rate and matrix_type as ints), or a preset
CONFIGS = {
    "128B-r12": R12,
    "128B-qc": dict(R12, matrix_type=2),
    "default": "ldpc_config_default",
    "burst-cw7": "ldpc_config_burst_resistant",
    "64B-r13": dict(block_size=64, rate=0),
    # V = 1365, so V % 8 != 0; the inner interleaver leaves 128 gaps
    "128B-r34-inner": dict(block_size=128, rate=3, use_inner_interleave=True,
                           use_outer_interleave=True),
    # explicit depth and lifting; the inner interleaver leaves 48 gaps
    "128B-qc-depth100": dict(R12, matrix_type=2, lifting_factor=32,
                             use_inner_interleave=True, use_outer_interleave=True,
                             use_soft_decode=True, interleave_depth=100),
}


def config_pair(name, **extra):
    """(JAX LdpcConfig with use_pallas="off", port LdpcConfig) for a
    CONFIGS entry, with `extra` keywords on both."""
    spec = CONFIGS[name]
    if isinstance(spec, str):
        j = getattr(jcfg, spec)(128, jcfg.LdpcRate.RATE_1_2)
        p = getattr(pcfg, spec)(128, pcfg.LdpcRate.RATE_1_2)
        spec = {f: getattr(p, f) for f in ("block_size", "rate", "matrix_type",
                                           "column_weight", "use_soft_decode",
                                           "use_outer_interleave", "use_inner_interleave")}
        assert all(getattr(j, f) == v for f, v in spec.items())
    kw = dict(spec, **extra)

    def make(mod, **more):
        k = dict(kw, rate=mod.LdpcRate(kw["rate"]),
                 matrix_type=mod.LdpcMatrixType(kw.get("matrix_type", 1)))
        return mod.LdpcConfig(**k, **more)

    return make(jcfg, use_pallas="off"), make(pcfg)


def jax_arrays(structure):
    """A JAX structure's arrays by ARRAY_NAMES (None where it has none)."""
    return {n: getattr(structure, n, None) for n in ARRAY_NAMES}


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2**32 + 5, b"\x01\x02",
                                  b"abcdefgh", None])
def test_rng_streams_match_jax(seed):
    got, want = Xoshiro128pp(seed), JaxXoshiro(seed)
    assert [got.next_u32() for _ in range(8)] == [want.next_u32() for _ in range(8)]
    assert np.array_equal(got.draw_u32(1000), want.draw_u32(1000))
    for size in (0, 1, 5, 8, 13):
        assert got.fill_bytes(size) == want.fill_bytes(size)


@pytest.mark.parametrize("nbits", [2048, 1365, 13])
def test_bit_pack_round_trip(nbits):
    rng = np.random.default_rng(nbits)
    b = rng.integers(0, 2, (5, nbits), dtype=np.uint8)
    packed = bits.pack(torch.from_numpy(b))
    want = jbits.pack_np(b)
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), want)
    assert np.array_equal(bits.pack_np(b), want)
    if nbits % 8:       # slack bits pack as 0
        assert not (packed[:, -1] & ((1 << (8 - nbits % 8)) - 1)).any()
    back = bits.unpack(packed, nbits)
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), b)
    assert np.array_equal(bits.unpack_np(want, nbits), jbits.unpack_np(want, nbits))
    assert np.array_equal(bits.unpack(packed).numpy(), jbits.unpack_np(want))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_structure_and_layout_match_jax(name):
    jc, pc = config_pair(name)
    js, ps = jax_structure(jc), get_structure(pc)
    for attr in ("info_bits", "parity_bits", "codeword_bits", "info_bytes",
                 "parity_bytes", "codeword_bytes", "col_weight", "num_checks",
                 "num_bits", "num_edges_used", "num_edges_alloc"):
        assert getattr(ps, attr) == getattr(js, attr), attr
    for n, want in jax_arrays(js).items():
        got = getattr(ps, n)
        assert (got is None) == (want is None), n
        if want is not None:
            assert np.array_equal(got, np.asarray(want)), n
    got, want = ps.decoder_layout(), js.decoder_layout()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        else:
            assert got[k] == w, k
    if ps.cfg.matrix_type == pcfg.LdpcMatrixType.QC_RANDOM:
        assert ps.lifting_factor == js.lifting_factor


def test_gap_configs_have_gaps():
    """The two interleaved test configs leave deinterleave gaps (F2),
    and the default preset leaves none."""
    gaps = {n: int((get_structure(config_pair(n)[1]).inner_deinterleave_gather < 0).sum())
            for n in ("default", "128B-r34-inner", "128B-qc-depth100")}
    assert gaps == {"default": 0, "128B-r34-inner": 128, "128B-qc-depth100": 48}


def test_from_arrays_rebuilds_the_structure():
    jc, pc = config_pair("128B-qc-depth100")
    s = LdpcStructure.from_arrays(pc, jax_arrays(jax_structure(jc)))
    own = get_structure(pc)
    assert (s.num_checks, s.num_bits, s.num_edges_used) == (
        own.num_checks, own.num_bits, own.num_edges_used)
    for k, w in own.decoder_layout().items():
        got = s.decoder_layout()[k]
        assert np.array_equal(got, w) if isinstance(w, np.ndarray) else got == w, k


def test_invalid_configs_raise():
    from libpoporon_tpu_torch.models.ldpc import LdpcError
    for bad in (dict(block_size=8, rate=1), dict(block_size=65, rate=1),
                dict(block_size=8196, rate=1)):
        with pytest.raises(LdpcError):
            LdpcStructure(pcfg.LdpcConfig(**bad))
    with pytest.raises(LdpcError):
        LdpcStructure(pcfg.LdpcConfig(block_size=64, rate=100))
    assert LdpcStructure(pcfg.LdpcConfig(64, pcfg.LdpcRate.RATE_1_2,
                                         column_weight=99)).col_weight == 8
