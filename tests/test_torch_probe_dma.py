"""The port's DMA probes (libpoporon_tpu_torch/benchmarks/probe_dma.py) on
the CPU: their plain versions against the JAX probes of
benchmarks/probe_dma.py, run in Pallas TPU interpret mode, exact on the
int32 output; the checksum against a numpy sum mod 2^32 and the landed
bytes against repeat x rows x row bytes; the wrappers'
CPU route and argument checks; and the measurement tools' refusal to time
anything but the card."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from libpoporon_tpu_torch.benchmarks import probe_dma  # noqa: E402
from libpoporon_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
UNITS = 64          # source rows of 8 sublanes
REPEAT = 2


@pytest.fixture(scope="module")
def jprobe():
    """benchmarks/probe_dma.py with pallas_call in TPU interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()))
        spec = importlib.util.spec_from_file_location(
            "jax_probe_dma", REPO / "benchmarks" / "probe_dma.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod


def inputs(sub, rows, seed=0):
    rng = np.random.default_rng(seed)
    nsrc = UNITS * 8 // sub
    src = rng.integers(-(1 << 31), 1 << 31, (nsrc * sub, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, nsrc, (rows,), dtype=np.int32)
    return idx, src


def numpy_checksum(words):
    return int(words.astype(np.uint32).sum(dtype=np.uint64) % (1 << 32))


CASES = [(sub, rows) for sub in (8, 16, 32) for rows in (9, 13)]


@pytest.mark.parametrize("sub,rows", CASES)
@pytest.mark.parametrize("probe", ["flood", "ring1", "ring8"])
def test_gather_matches_jax(jprobe, probe, sub, rows):
    idx, src = inputs(sub, rows, seed=sub + rows)
    jidx, jsrc = jax.numpy.asarray(idx), jax.numpy.asarray(src)
    if probe == "flood":
        want = jprobe.gather_flood(jidx, jsrc, rows, sub, REPEAT)
    else:
        want = jprobe.gather_ring(jidx, jsrc, rows, sub, REPEAT, depth=int(probe[4:]))
    out, checksum, landed = probe_dma.gather_plain(torch.from_numpy(idx),
                                                   torch.from_numpy(src), sub, REPEAT)
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), np.asarray(want))
    rows_np = src.reshape(-1, sub * 128)[idx]
    assert int(checksum) == numpy_checksum(rows_np)
    assert landed.dtype == torch.int64 and int(landed) == REPEAT * rows_np.nbytes


@pytest.mark.parametrize("sub,rows", CASES)
def test_plane_matches_jax(jprobe, sub, rows):
    _, src = inputs(sub, rows, seed=sub * rows)
    want = jprobe.plane_copy(jax.numpy.asarray(src), rows, sub, REPEAT)
    out, checksum, landed = probe_dma.plane_plain(torch.from_numpy(src), rows, sub, REPEAT)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert int(checksum) == numpy_checksum(src[: rows * sub])
    assert int(landed) == REPEAT * src[: rows * sub].nbytes


@pytest.mark.parametrize("sub", [8, 16, 32])
def test_wrappers_on_cpu_run_the_plain_version(sub):
    """CPU tensors take the plain version and launch nothing, for any
    ragged row count (one row included)."""
    for rows in (1, 5, 13):
        idx, src = (torch.from_numpy(a) for a in inputs(sub, rows, seed=rows))
        want = probe_dma.gather_plain(idx, src, sub, 3)
        for got in (probe_dma.gather_flood(idx, src, rows, sub, 3),
                    probe_dma.gather_ring(idx, src, rows, sub, 3),
                    probe_dma.gather_ring(idx, src, rows, sub, 3, depth=1)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = probe_dma.plane_copy(src, rows, sub, 3)
        want = probe_dma.plane_plain(src, rows, sub, 3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(probe_dma.launches.values()), probe_dma.launches


def test_checksum_wraps():
    """Words near 2^31 (negative as int32) sum modulo 2^32."""
    src = torch.full((16, 128), -1, dtype=torch.int32)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32)
    _, checksum, _ = probe_dma.gather_flood(idx, src, 3, 8, 1)
    assert checksum.dtype == torch.int64
    assert int(checksum) == (3 * 8 * 128 * 0xFFFFFFFF) % (1 << 32)


@pytest.mark.parametrize("bad", ["dtype", "lanes", "sub", "sub_big", "ragged_src", "rows",
                                 "repeat", "depth", "depth_fit", "idx_shape", "idx_dtype",
                                 "plane_rows"])
def test_wrappers_reject_bad_arguments(bad):
    idx, src = (torch.from_numpy(a) for a in inputs(8, 4))
    rows, sub, repeat, depth = 4, 8, 2, 8
    if bad == "dtype":
        src = src.to(torch.int64)
    elif bad == "lanes":
        src = src.reshape(-1, 64)
    elif bad == "sub":
        sub = 12
    elif bad == "sub_big":
        sub = 512
    elif bad == "ragged_src":
        src = src[:-8]
        sub = 16
    elif bad == "rows":
        rows, idx = 0, idx[:0]
    elif bad == "repeat":
        repeat = 0
    elif bad == "depth":
        depth = 33
    elif bad == "depth_fit":
        sub, depth = 64, 8           # 8 slots of 32 KB exceed 192 KB
        src = src[: 64 * 8]
    elif bad == "idx_shape":
        idx = idx[:3]
    elif bad == "idx_dtype":
        idx = idx.to(torch.int64)
    with pytest.raises(ValueError):
        if bad == "plane_rows":
            probe_dma.plane_copy(src, src.shape[0] // sub + 1, sub, repeat)
        elif bad.startswith("depth"):
            probe_dma.gather_ring(idx, src, rows, sub, repeat, depth)
        else:
            probe_dma.gather_flood(idx, src, rows, sub, repeat)


def test_measurement_tools_refuse_the_cpu(tmp_path):
    """ThroughputMeter.measure and trace measure the card only: on a host
    without one they raise instead of timing the CPU."""
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not all CUDA"):
            profiling.ThroughputMeter(1).measure(lambda: torch.zeros(4))
        return
    calls = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.ThroughputMeter(1).measure(lambda: calls.append(1) or torch.zeros(4))
    assert not calls
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path / "trace")):
            torch.zeros(4)
    assert not (tmp_path / "trace").exists()


def test_probe_main_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_dma.main()
