"""The port's parallel/ (mesh, ShardedCodec, collective statistics) and
its scaling benchmark against the JAX package's, on the same NumPy inputs.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's counterpart is a mesh of 8 CPU entries.  B = 20 pads to 24 (8
shards of 3 rows); B = 24 splits without padding.  Exact equality on
every output.  One test runs two `gloo` processes that reduce the
statistics across ranks, each wait bounded by its own timeout.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import libpoporon_tpu as pp  # noqa: E402
from libpoporon_tpu.config import LdpcConfig as JaxLdpcConfig  # noqa: E402
from libpoporon_tpu.config import LdpcRate as JaxLdpcRate  # noqa: E402
from libpoporon_tpu.parallel import ShardedCodec as JaxShardedCodec  # noqa: E402
from libpoporon_tpu.parallel import ber_stats as jax_ber_stats  # noqa: E402
from libpoporon_tpu.parallel import iteration_histogram as jax_iteration_histogram  # noqa: E402
from libpoporon_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple  # noqa: E402

import libpoporon_tpu_torch as pt  # noqa: E402
from libpoporon_tpu_torch.benchmarks import scaling  # noqa: E402
from libpoporon_tpu_torch.parallel import (  # noqa: E402
    ShardedCodec, batch_mesh, ber_stats, distributed_init, iteration_histogram, shard_batch)
from libpoporon_tpu_torch.parallel.mesh import pad_to_multiple  # noqa: E402
from libpoporon_tpu_torch.utils.bits import unpack  # noqa: E402

from test_torch_rs import erasure_batch, mixed_batch  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N = 8
_CODECS = {}


def same(got, want):
    """Port outputs (tensors) == JAX outputs, values, dtypes and shapes."""
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), i
        assert np.array_equal(g, w), i


def codecs(name):
    """(port facade on the CPU, its ShardedCodec over 8 CPU entries, JAX
    ShardedCodec over the 8 virtual devices), built once per module."""
    if name not in _CODECS:
        port_cfg, jax_cfg = {
            "rs": (pt.rs_config_default(), pp.rs_config_default()),
            "bch": (pt.bch_config_default(), pp.bch_config_default()),
            "ldpc32": (pt.LdpcConfig(32, pt.LdpcRate.RATE_1_2),
                       JaxLdpcConfig(32, JaxLdpcRate.RATE_1_2)),
            "ldpc128_soft": (pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2),
                             pp.ldpc_config_default(128, JaxLdpcRate.RATE_1_2)),
        }[name]
        codec = pt.create(port_cfg, device="cpu")
        _CODECS[name] = (codec, ShardedCodec(codec, batch_mesh(["cpu"] * N)),
                         JaxShardedCodec(pp.create(jax_cfg)))
    return _CODECS[name]


def flipped(rng, cw, max_bits):
    """cw with 0..max_bits distinct bits flipped in each row."""
    bad = cw.copy()
    nbits = cw.shape[1] * 8
    for i, k in enumerate(rng.integers(0, max_bits + 1, cw.shape[0])):
        for b in rng.choice(nbits, k, replace=False):
            bad[i, b // 8] ^= np.uint8(0x80 >> (b % 8))
    return bad


# ---------------------------------------------------------------- mesh


def test_batch_mesh_of_8_cpu_entries():
    mesh = batch_mesh(["cpu"] * N)
    assert mesh.shape["batch"] == N
    assert mesh.axis_names == ("batch",)
    assert mesh.devices == (torch.device("cpu"),) * N


def test_without_a_card_the_defaults_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.main([])


@pytest.mark.parametrize("shape,axis", [((20, 5), 0), ((24, 5), 0), ((3, 7), 1), ((1,), 0)])
def test_pad_to_multiple_matches_jax(shape, axis):
    x = np.arange(1, np.prod(shape) + 1, dtype=np.uint8).reshape(shape)
    want, m = jax_pad_to_multiple(x, N, axis)
    got, n = pad_to_multiple(x, N, axis)
    assert n == m and got.dtype == want.dtype and np.array_equal(got, want)
    got_t, n = pad_to_multiple(torch.from_numpy(x), N, axis)
    assert n == m and np.array_equal(got_t.numpy(), want)


def test_shard_batch_splits_in_order():
    x = torch.arange(24 * 3).reshape(24, 3)
    shards = shard_batch(x, batch_mesh(["cpu"] * N))
    assert len(shards) == N and all(tuple(s.shape) == (3, 3) for s in shards)
    assert torch.equal(torch.cat(shards), x)
    with pytest.raises(ValueError):
        shard_batch(x[:20], batch_mesh(["cpu"] * N))


def test_distributed_init_is_a_no_op_for_one_process():
    distributed_init()
    distributed_init("localhost:1", 1, 0)
    assert not dist.is_initialized()


# ------------------------------------------------------------ sharded RS


def rs_rows(rng, B):
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    return data, codecs("rs")[0].encode(data).parity.numpy()


@pytest.mark.parametrize("B", [20, 24])
def test_sharded_rs_matches_jax(B):
    codec, sc, jsc = codecs("rs")
    rng = np.random.default_rng(B)
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    enc = sc.encode(data)
    same(enc, jsc.encode(data))
    # clean rows, 0..t+1 errors, parity-only errors, junk rows
    bad, pbad = mixed_batch(rng, data, enc.parity.numpy())
    got = sc.decode(bad, pbad)
    same(got, jsc.decode(bad, pbad))
    same(got, codec.decode(bad, pbad))
    assert got.ok[: B // 8].all()


@pytest.mark.parametrize("B", [20, 24])
def test_sharded_rs_erasure_list_matches_jax(B):
    """A 1-D erasure list is shared by every shard, padded or not."""
    _, sc, jsc = codecs("rs")
    rng = np.random.default_rng(100 + B)
    data, parity = rs_rows(rng, B)
    positions = [3, 50, 100, 222]
    bad = data.copy()
    bad[:, positions] ^= 0x5A
    bad[::2, 7] ^= 0x11                  # one further error on half the rows
    got = sc.decode(bad, parity, erasures=positions)
    same(got, jsc.decode(bad, parity, erasures=positions))
    # rows without the further error come back whole (with it, F1's
    # correction lands on byte 0, in both packages)
    assert got.ok.all() and np.array_equal(got.data[1::2].numpy(), data[1::2])


@pytest.mark.parametrize("kind", ["erasures", "ext_syndrome"])
@pytest.mark.parametrize("B", [20, 24])
def test_sharded_rs_per_row_keywords(kind, B):
    """A per-row array splits with the rows when B divides the mesh; a
    padded batch meets it with a ValueError here, where the JAX package
    fails to broadcast it (ValueError for erasures, TypeError for
    external syndromes)."""
    codec, sc, jsc = codecs("rs")
    rng = np.random.default_rng(200 + B)
    data, parity = rs_rows(rng, B)
    if kind == "erasures":
        bad, value, _ = erasure_batch(rng, data, 6, 2)
    else:
        bad, parity = mixed_batch(rng, data, parity)
        rs = codec._rs
        value = rs.exp2log[rs._syndrome(torch.from_numpy(bad),
                                        torch.from_numpy(parity)).long()].numpy()
    kw = {kind: value}
    if B % N:
        with pytest.raises(ValueError):
            sc.decode(bad, parity, **kw)
        with pytest.raises(ValueError if kind == "erasures" else TypeError):
            jsc.decode(bad, parity, **kw)
        return
    got = sc.decode(bad, parity, **kw)
    same(got, jsc.decode(bad, parity, **kw))
    same(got, codec.decode(bad, parity, **kw))


# ------------------------------------------------------- sharded LDPC, BCH


@pytest.mark.parametrize("B", [16, 20])
def test_ldpc_decode_step_matches_jax(B):
    """Outputs, iterations and both statistics; at B = 20 the statistics
    count the 4 zero pad rows (codewords: ok at 0 iterations), as the JAX
    package's psum does."""
    codec, sc, jsc = codecs("ldpc32")
    rng = np.random.default_rng(300 + B)
    info = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    enc = sc.encode(info)
    cw = np.concatenate([enc.data.numpy(), enc.parity.numpy()], axis=1)
    bad = flipped(rng, cw, 24)
    ok, out, iters, st = sc.ldpc_decode_step(bad)
    j_ok, j_out, j_iters, j_st = jsc.ldpc_decode_step(bad)
    same((ok, out, iters), (j_ok, j_out, j_iters))
    assert st == j_st
    assert 0 < st["converged"] - (N - B % N) % N < B        # some rows fail

    ref, dec = unpack(torch.from_numpy(cw)), unpack(out)
    got = ber_stats(ref, dec, group=None)
    want = jax_ber_stats(jnp.asarray(ref.numpy()), jnp.asarray(dec.numpy()), axis_name=None)
    assert [int(got["errors"]), int(got["total"])] == [int(want["errors"]), int(want["total"])]
    assert got["ber"].dtype == torch.float32
    assert got["ber"].item() == float(want["ber"])
    mi = codec._ldpc.max_iterations
    same((iteration_histogram(iters, mi, group=None),),
         (np.asarray(jax_iteration_histogram(jnp.asarray(j_iters), mi, axis_name=None),
                     dtype=np.int64),))


def test_sharded_ldpc_soft_matches_jax():
    """Soft decode through decode(soft_llr=...) on the interleaved 128 B
    preset; the LLRs are padded and split with the rows."""
    _, sc, jsc = codecs("ldpc128_soft")
    rng = np.random.default_rng(400)
    B = 20
    info = rng.integers(0, 256, (B, 128), dtype=np.uint8)
    enc = sc.encode(info.copy())
    same(enc, jsc.encode(info.copy()))
    sent = unpack(torch.cat([enc.data, enc.parity], dim=1)).numpy()
    llr = np.where(sent == 1, -60, 60) + rng.normal(0, 40, sent.shape)
    llr = np.clip(llr, -127, 127).astype(np.int8)
    data, parity = enc.data.numpy(), enc.parity.numpy()
    got = sc.decode(data, parity, soft_llr=llr)
    same(got, jsc.decode(data, parity, soft_llr=llr))
    assert got.ok.any()


def test_sharded_bch_matches_jax():
    codec, sc, jsc = codecs("bch")
    rng = np.random.default_rng(500)
    B = 20
    data = rng.integers(0, 32, (B, 1), dtype=np.uint8)
    enc = sc.encode(data)
    same(enc, jsc.encode(data))
    bad = data ^ (rng.integers(0, 4, (B, 1)) << rng.integers(0, 4, (B, 1))).astype(np.uint8)
    pbad = enc.parity.numpy() ^ rng.integers(0, 2, enc.parity.shape).astype(np.uint8)
    got = sc.decode(bad, pbad)
    same(got, jsc.decode(bad, pbad))
    same(got, codec.decode(bad, pbad))


def test_encode_corrupt_decode_with_reduced_statistics():
    """Counterpart of test_parallel.py's dry run (__graft_entry__
    dryrun_multichip): encode, corrupt, decode and reduce the statistics
    on a mesh of 8; every codeword converges."""
    _, sc, _ = codecs("ldpc32")
    B = 2 * N
    info = np.random.default_rng(1).integers(0, 256, (B, 32), dtype=np.uint8)
    enc = sc.encode(info)
    cw = torch.cat([enc.data, enc.parity], dim=1)
    bad = cw.clone()
    bad[:, 3] ^= 0x40
    ok, out, iters, st = sc.ldpc_decode_step(bad)
    assert st["converged"] == B and bool(ok.all())
    assert int(ber_stats(unpack(cw), unpack(out), group=None)["errors"]) == 0
    assert int(iteration_histogram(iters, 50, group=None).sum()) == B


# ------------------------------------------------------------- statistics


def test_stats_local_match_jax():
    rng = np.random.default_rng(600)
    ref = rng.integers(0, 2, (16, 8), dtype=np.int32)
    out = ref ^ (rng.random((16, 8)) < 0.2)
    got = ber_stats(torch.from_numpy(ref), torch.from_numpy(out), group=None)
    want = jax_ber_stats(jnp.asarray(ref), jnp.asarray(out), axis_name=None)
    assert (int(got["errors"]), int(got["total"])) == (int(want["errors"]), int(want["total"]))
    assert got["ber"].item() == float(want["ber"])
    # counts outside 0..max_iterations are dropped, as by JAX's one_hot
    iters = np.array([-1, 0, 3, 4, 5, 4, 2, -7, 9, 0], dtype=np.int32)
    got = iteration_histogram(torch.from_numpy(iters), 4, group=None)
    want = np.asarray(jax_iteration_histogram(jnp.asarray(iters), 4, axis_name=None))
    assert got.tolist() == want.tolist() == [2, 0, 1, 1, 2]


def test_stats_default_group_raises_without_a_process_group():
    """The default scope is the process group; with none open it raises,
    never reducing locally in its place."""
    assert not dist.is_initialized()
    bits = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no process group"):
        ber_stats(bits, bits)
    with pytest.raises(RuntimeError, match="no process group"):
        iteration_histogram(torch.zeros(4, dtype=torch.int32), 4)


# ------------------------------------------------------------- benchmark


def test_scaling_main_on_a_cpu_mesh_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = sorted(p.name for p in (REPO / "libpoporon_tpu_torch" / "benchmarks").iterdir())
    res = scaling.main(["--devices", "cpu:2", "--batch", "64"])
    assert (res["devices"], res["platform"], res["per_device_batch"]) == (2, "cpu", 64)
    for name in ("rs_decode_2err", "rs_erasure_32", "bch15", "ldpc_hard_128B",
                 "ldpc_soft_128B"):
        row = res[name]
        assert row["one_device_cws"] > 0 and row["2_device_cws"] > 0
        assert row["scaling_efficiency"] == pytest.approx(row["one_device_ms"] / row["2_device_ms"])
    assert list(tmp_path.iterdir()) == []
    after = sorted(p.name for p in (REPO / "libpoporon_tpu_torch" / "benchmarks").iterdir())
    assert after == before


# ------------------------------------------------- two processes, gloo

RANK_CODE = r"""
import datetime, json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rdzv, npz = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + rdzv, world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=30))
try:
    import libpoporon_tpu_torch as pt
    from libpoporon_tpu_torch.parallel import (ShardedCodec, batch_mesh, ber_stats,
                                               iteration_histogram)
    from libpoporon_tpu_torch.utils.bits import unpack
    f = np.load(npz)
    half = f["bad"].shape[0] // world
    mine = slice(rank * half, (rank + 1) * half)
    codec = pt.create(pt.LdpcConfig(32, pt.LdpcRate.RATE_1_2), device="cpu")
    sc = ShardedCodec(codec, batch_mesh(["cpu"]), group=dist.group.WORLD)
    ok, out, iters, st = sc.ldpc_decode_step(f["bad"][mine])
    ber = ber_stats(unpack(torch.from_numpy(f["cw"][mine])), unpack(out))
    hist = iteration_histogram(iters, codec._ldpc.max_iterations)
    print(json.dumps({"stats": st, "errors": int(ber["errors"]), "total": int(ber["total"]),
                      "ber": float(ber["ber"]), "hist": hist.tolist()}), flush=True)
finally:
    dist.destroy_process_group()
"""


def test_two_gloo_ranks_reduce_the_statistics(tmp_path):
    """Two processes, each a one-entry mesh over its half of one batch,
    reduce over WORLD: both print the single-process sums.  Every wait has
    a timeout and the children are killed in `finally`, so a hung
    collective costs at most 60 s."""
    codec, _, _ = codecs("ldpc32")
    rng = np.random.default_rng(700)
    B = 16
    info = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    cw = np.concatenate([info, codec.encode(info).parity.numpy()], axis=1)
    bad = flipped(rng, cw, 24)
    np.savez(tmp_path / "batch.npz", cw=cw, bad=bad)

    sc = ShardedCodec(codec, batch_mesh(["cpu"] * 2))
    _, out, iters, st = sc.ldpc_decode_step(bad)
    ber = ber_stats(unpack(torch.from_numpy(cw)), unpack(out), group=None)
    want = {"stats": st, "errors": int(ber["errors"]), "total": int(ber["total"]),
            "ber": float(ber["ber"]),
            "hist": iteration_histogram(iters, codec._ldpc.max_iterations, group=None).tolist()}

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_CODE, str(rank), "2", str(tmp_path / "rdzv"),
                 str(tmp_path / "batch.npz")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
        deadline = time.monotonic() + 60
        outputs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    for p, (stdout, stderr) in zip(procs, outputs):
        assert p.returncode == 0, stderr[-2000:]
        assert json.loads(stdout.strip().splitlines()[-1]) == want
