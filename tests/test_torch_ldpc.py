"""The port's LDPCCodec (device cpu) against the JAX package's XLA path.

The same inputs, made with NumPy from a seed, go through
libpoporon_tpu's `LDPCCodec(LdpcConfig(..., use_pallas="off"))` and the
port's `LDPCCodec`; ok, output bytes and iteration counts must be equal.
A codec on the CPU has no kernel and runs the plain PyTorch version, so
these tests hold the kernel's plain version to the reference.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from libpoporon_tpu.models import ldpc_pallas as lp  # noqa: E402
from libpoporon_tpu.models.ldpc import LDPCCodec as JaxLDPCCodec  # noqa: E402
from libpoporon_tpu.utils import bits as jbits  # noqa: E402

from libpoporon_tpu_torch.config import LdpcConfig, LdpcRate  # noqa: E402
from libpoporon_tpu_torch.models.ldpc import (  # noqa: E402
    LLR_INFINITY, LLR_MAX, LDPCCodec, get_structure)
from libpoporon_tpu_torch.models.ldpc_cuda import BPCudaKernel  # noqa: E402

from test_torch_ldpc_structure import config_pair, jax_arrays  # noqa: E402

torch.set_num_threads(2)

B = 512


@pytest.fixture(scope="module")
def pair():
    """(JAX codec, port codec) for 128-byte rate-1/2."""
    jc, pc = config_pair("128B-r12")
    return JaxLDPCCodec(jc), LDPCCodec(pc, "cpu")


@pytest.fixture(scope="module")
def gap_pair():
    """(JAX codec, port codec) for a config whose inner deinterleave
    leaves 48 gaps (both interleavers, depth 100, QC lifting 32)."""
    jc, pc = config_pair("128B-qc-depth100")
    return JaxLDPCCodec(jc), LDPCCodec(pc, "cpu")


def flip(rng, cw, nerr, nbits):
    """Flip nerr[i] distinct random bits (MSB-first) of row i."""
    cw = cw.copy()
    for i, n in enumerate(nerr):
        for q in rng.choice(nbits, int(n), replace=False):
            cw[i, q // 8] ^= 1 << (7 - q % 8)
    return cw


def codewords(codec, rng, n_rows):
    info = rng.integers(0, 256, (n_rows, codec.info_bytes), dtype=np.uint8)
    return np.concatenate([info, codec.encode(info).numpy()], axis=1)


def mixed_hard(codec, seed, n_rows=B, max_err=8):
    """Clean rows, 1..max_err-1 flipped bits, and junk rows."""
    rng = np.random.default_rng(seed)
    cw = codewords(codec, rng, n_rows)
    nerr = rng.integers(1, max_err, n_rows)
    nerr[: n_rows // 8] = 0
    cw = flip(rng, cw, nerr, codec.codeword_bits)
    junk = n_rows // 16
    if junk:
        cw[-junk:] = rng.integers(0, 256, (junk, codec.codeword_bytes), dtype=np.uint8)
    return cw


def mixed_soft(codec, seed, n_rows=B, sigma=45.0):
    """int8 LLRs of the interleaved codeword: strong clean rows, noisy
    rows (+-90 plus N(0, sigma)) and junk rows."""
    rng = np.random.default_rng(seed)
    cw = codewords(codec, rng, n_rows)
    if codec.inter_g is not None:
        cw = codec.interleave(cw).numpy()
    sign = np.where(jbits.unpack_np(cw, codec.codeword_bits) == 1, -1.0, 1.0)
    llr = sign * 90 + rng.normal(0, sigma, sign.shape)
    llr[: n_rows // 8] = sign[: n_rows // 8] * 100
    llr[-(n_rows // 16):] = rng.integers(-127, 128, (n_rows // 16, sign.shape[1]))
    return np.clip(np.round(llr), -127, 127).astype(np.int8)


def assert_same(got, want):
    """Port (ok, bytes, iters) tensors == JAX arrays, values and dtypes."""
    for g, w, name in zip(got, want, ("ok", "codeword", "iters")):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


_JAX_CACHE = {}


def jax_decode(jl, kind, x, mi=0):
    """JAX decode_hard / decode_soft, memoised per input."""
    key = (id(jl), kind, x.tobytes(), x.shape, mi)
    if key not in _JAX_CACHE:
        fn = jl.decode_hard if kind == "hard" else jl.decode_soft
        _JAX_CACHE[key] = tuple(np.asarray(a) for a in fn(x, mi))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("name", ["128B-r12", "128B-r34-inner", "128B-qc-depth100"])
def test_encode_check_interleave_match_jax(name):
    jc, pc = config_pair(name)
    jl, pl = JaxLDPCCodec(jc), LDPCCodec(pc, "cpu")
    cw = mixed_hard(pl, 1, n_rows=64)
    info = cw[:, : pl.info_bytes]
    got = pl.encode(info)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(jl.encode(info)))
    assert np.array_equal(pl.encode(info[0]).numpy(), np.asarray(jl.encode(info[0])))
    ok = pl.check(cw)
    assert np.array_equal(ok.numpy(), np.asarray(jl.check(cw)))
    assert ok.any() and not ok.all()
    for fn in ("interleave", "deinterleave"):
        assert np.array_equal(getattr(pl, fn)(cw).numpy(), np.asarray(getattr(jl, fn)(cw)))


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_decode_matches_jax_and_adaptive_matches_plain(pair, kind):
    jl, pl = pair
    x = mixed_hard(pl, 2) if kind == "hard" else mixed_soft(pl, 3)
    want = jax_decode(jl, kind, x)
    got = getattr(pl, f"decode_{kind}")(x)
    assert_same(got, want)
    ok, iters = want[0], want[2]
    assert ok.any() and not ok.all() and iters.max() == 50
    if kind == "hard":
        assert (iters[: B // 8] == 0).all()        # clean rows: iteration-0 detect
    else:
        assert (iters[ok] >= 1).all()             # soft has no iteration-0 detect
    assert pl.kernel is None and pl.STRAGGLER_SLOTS == 256   # the cascade, 256 a pass
    assert_same(getattr(pl, f"decode_{kind}_adaptive")(x), want)


def test_all_saturated_checks_match_jax(pair):
    """LLRs of magnitude 127 give llr_0 = +-32000 on every variable, so at
    iteration 1 every check's real edges are saturated: m1 == m2 == 32000,
    the tie rule's edge case against the XLA path's +32000 padding."""
    jl, pl = pair
    rng = np.random.default_rng(4)
    cw = codewords(pl, rng, B)
    sign = np.where(jbits.unpack_np(cw, pl.codeword_bits) == 1, -127, 127)
    flips = rng.random(sign.shape) < rng.uniform(0, 0.04, (B, 1))
    llr = np.where(flips, -sign, sign).astype(np.int8)
    assert (np.abs(llr.astype(np.int32)) * 256 >= LLR_MAX).all()
    want = jax_decode(jl, "soft", llr)
    assert_same(pl.decode_soft(llr), want)
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_budget_exhaustion_matches_jax(pair, kind):
    """MI = 1 under heavy noise: rows that do not converge return the
    iteration-1 decision with ok False and iters 1."""
    jl, pl = pair
    if kind == "hard":
        rng = np.random.default_rng(5)
        cw = codewords(pl, rng, B)
        x = flip(rng, cw, np.full(B, pl.codeword_bits // 8), pl.codeword_bits)
    else:
        x = mixed_soft(pl, 6, sigma=90.0)
    want = jax_decode(jl, kind, x, 1)
    assert_same(getattr(pl, f"decode_{kind}")(x, 1), want)
    assert not want[0].all() and set(np.unique(want[2])) <= {0, 1}


@pytest.mark.parametrize("n_rows", [1, 1000, 1025])
def test_ragged_batches_match_jax(pair, n_rows):
    jl, pl = pair
    x = mixed_hard(pl, 7, n_rows=n_rows)
    assert_same(pl.decode_hard(x), jax_decode(jl, "hard", x))
    if n_rows == 1:         # 1-D squeeze
        got = pl.decode_hard(x[0])
        assert got[1].shape == (pl.codeword_bytes,) and got[0].shape == ()
        assert_same(got, jax_decode(jl, "hard", x[0]))


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_interleaved_gap_config_matches_jax(gap_pair, kind):
    """Both interleavers and 48 deinterleave gaps: the gaps read bit 0
    (hard) and LLR 0 (soft), as the JAX package zero-fills them (F2)."""
    jl, pl = gap_pair
    if kind == "hard":
        x = pl.interleave(mixed_hard(pl, 8)).numpy()
    else:
        x = mixed_soft(pl, 9)
    want = jax_decode(jl, kind, x)
    assert_same(getattr(pl, f"decode_{kind}")(x), want)
    assert want[0].any()
    assert_same(getattr(pl, f"decode_{kind}_adaptive")(x), want)


def _bp_inputs(jl, cw):
    """bp()'s hard inputs, built as tests/test_pallas.py builds them."""
    work = jl.deinterleave_bits_T(jl._unpack_cw_T(jnp.asarray(cw)))
    n = work.shape[1]
    bits_p8 = jnp.concatenate([work, jnp.zeros((1, n), work.dtype)], axis=0).astype(jnp.int8)
    llr0 = jnp.where(work == 1, -LLR_INFINITY, LLR_INFINITY).astype(jnp.int16)
    llr0_p = jnp.concatenate([llr0, jnp.full((1, n), LLR_MAX, jnp.int16)], axis=0)
    return bits_p8, llr0_p


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_bp_entry_matches_jax_bp_loop(pair, kind):
    jl, pl = pair
    n = 256
    if kind == "hard":
        bits_p8, llr0 = _bp_inputs(jl, mixed_hard(pl, 10, n_rows=n))
        conv0, chan = jl._syndrome_ok_p(bits_p8), None
    else:
        w = jnp.asarray(mixed_soft(pl, 11, n_rows=n), jnp.int8).astype(jnp.int32).T
        w = jnp.concatenate([w, jnp.full((1, n), 125, w.dtype)], axis=0)
        chan = (w * 256).astype(jnp.int16)
        llr0 = jnp.clip(w * 256, -LLR_MAX, LLR_MAX).astype(jnp.int16)
        bits_p8 = jnp.zeros_like(w, dtype=jnp.int8)
        conv0 = jnp.zeros((n,), bool)
    want = [np.asarray(a) for a in jl._bp_loop(llr0, chan, bits_p8, conv0, 9)]
    to_t = (lambda a: None if a is None else torch.from_numpy(np.array(a)))
    got = pl._bp_plain(to_t(llr0), to_t(chan), 9)
    V = pl.codeword_bits
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy()[:V], want[1][:V])
    assert not got[1][V].any()
    assert np.array_equal(got[2].numpy(), want[2])


def test_from_arrays_decodes_like_jax(pair):
    jl, _ = pair
    jc, pc = config_pair("128B-r12")
    pl = LDPCCodec.from_arrays(pc, jax_arrays(jl.structure), "cpu")
    x = mixed_hard(pl, 2)                        # the hard decode test's input
    assert_same(pl.decode_hard(x), jax_decode(jl, "hard", x))


def test_kernel_wrapper_runs_plain_version_on_cpu(pair):
    """A codec on the CPU has no kernel and decodes with the plain
    version; the kernel's launcher refuses CPU tensors."""
    _, pl = pair
    assert pl.kernel is None
    cw = torch.from_numpy(mixed_hard(pl, 12, n_rows=32))
    w = torch.from_numpy(mixed_soft(pl, 13, n_rows=32))
    assert_same(pl.decode_hard(cw), pl._plain("hard", cw, 50))
    assert_same(pl.decode_soft(w), pl._plain("soft", w, 50))
    kern = BPCudaKernel(pl.structure, "cpu")
    llr = torch.full((pl.codeword_bits + 1, 4), 100, dtype=torch.int16)
    for call in (lambda: kern.bp_packed_hard(cw, 50), lambda: kern.bp_llr8_soft(w, 50),
                 lambda: kern.bp(llr, None, 50)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert kern.launches == 0


def test_use_kernel_knob_and_gate():
    """The kernel's gate alone picks it; no config field does."""
    assert not any("kernel" in f.name for f in dataclasses.fields(LdpcConfig))
    for name in ("128B-r12", "128B-qc", "default", "burst-cw7", "64B-r13",
                 "128B-r34-inner", "128B-qc-depth100"):
        assert BPCudaKernel.supports(get_structure(config_pair(name)[1])), name
    inside = LDPCCodec(LdpcConfig(1024, LdpcRate.RATE_1_2), "cpu")
    outside = LDPCCodec(LdpcConfig(1024, LdpcRate.RATE_1_3), "cpu")
    assert BPCudaKernel.supports(inside.structure)
    assert not BPCudaKernel.supports(outside.structure)
    assert inside.kernel is None and outside.kernel is None     # on the CPU
    assert outside.H_info is None and outside.STRAGGLER_SLOTS == 256


def test_plain_packed_hard_matches_pallas_interpret(monkeypatch):
    """The port's plain hard decode against `BPPallasKernel.bp_packed_hard`,
    the TPU kernel it replaces, in interpret mode at one 1024-codeword
    block of the smallest code."""
    monkeypatch.setattr(lp.BPPallasKernel, "_interpret",
                        jax.devices()[0].platform != "tpu")
    jl = JaxLDPCCodec(config_pair("128B-r12", block_size=32)[0])
    pl = LDPCCodec(config_pair("128B-r12", block_size=32)[1], "cpu")
    x = mixed_hard(pl, 14, n_rows=lp.BLK)
    want = lp.BPPallasKernel(jl.structure).bp_packed_hard(jnp.asarray(x), 9)
    assert_same(pl.decode_hard(x, 9), want)
