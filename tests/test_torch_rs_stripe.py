"""The port's stripe decode, `Codec.reconstruct` (device cpu, the plain
version), against the row decode it is defined by, against the JAX
package's erasure decode, and against the benchmark's plain reference
(fecbench/reference/rs_stripe.py); the stripe kernel's plan
(models/rs_cuda.py `stripe_plan`) emulated in NumPy against the plain
version; the stripe path's spans; and, on a card, the kernel against the
plain version.

Cells are shard-major [n, L]: column t holds codeword t.  The lost cells
are filled with junk, which the decode must ignore.  ok and the count
come from `Codec.decode` of the rows cells.T with the lost cells zeroed
and given as erasures; the rebuilt bytes are the lost cells' own, data
and parity, in the order named, wherever the survivors hold at most
(nr - e) / 2 errors, and the plain reference's (each correction at its
root's location) everywhere.  The row decode's erasure form puts its
t-th correction on the t-th erasure named and into data cells only, so
its bytes are compared only where that is the same: data cells named
ascending, in columns without other errors.

JAX is imported only by the test that compares with it, so that the card
test runs on a machine without it:
`python -m pytest --noconftest tests/test_torch_rs_stripe.py -k card`.
"""

import json

import numpy as np
import pytest
import torch

import libpoporon_tpu_torch as pt
from fecbench.reference import rs_stripe
from libpoporon_tpu_torch.models.rs_cuda import gf_tables, stripe_plan

torch.set_num_threads(2)

CODES = {14: 4, 9: 3}       # cells -> parity cells: RS-10-4 and RS-6-3


def codec_of(n, device="cpu"):
    return pt.create(pt.RSConfig(num_roots=CODES[n]), device=device)


def codewords(codec, n, L, seed):
    """Shard-major cells uint8 [n, L] of L random codewords."""
    rng = np.random.default_rng(seed)
    k = n - codec._rs.num_roots
    data = rng.integers(0, 256, (L, k), dtype=np.uint8)
    parity = codec.encode(data).parity.cpu().numpy()
    return np.concatenate([data, parity], axis=1).T.copy()


def hurt(cells, lost, extra, share, seed):
    """cells with junk in the lost cells and `extra` symbol errors among
    the survivors of a `share` of the columns (all where share is 1)."""
    rng = np.random.default_rng(seed + 1)
    n, L = cells.shape
    out = cells.copy()
    out[list(lost)] = rng.integers(0, 256, (len(lost), L), dtype=np.uint8)
    surv = [j for j in range(n) if j not in lost]
    for c in np.nonzero(rng.random(L) < share)[0]:
        for j in rng.choice(surv, extra, replace=False):
            out[j, c] ^= rng.integers(1, 256, dtype=np.uint8)
    return out


def reference_of(n):
    nr = CODES[n]
    return rs_stripe.Reference({"symbol_size": 8, "generator_polynomial": 285,
                                "first_consecutive_root": 1, "primitive_element": 1,
                                "num_roots": nr, "data_cells": n - nr}, "cpu")


def by_decode(codec, cells, lost):
    """What the stripe decode must give, column by column: (ok and
    corrected uint8 of the row decode with the lost cells zeroed and
    given as erasures, and the lost cells' bytes [e, L] of the codeword
    found, from the plain reference)."""
    k = cells.shape[0] - codec._rs.num_roots
    z = cells.copy()
    z[list(lost)] = 0
    res = codec.decode(z[:k].T.copy(), z[k:].T.copy(), erasures=list(lost))
    ok, rebuilt, _, corrected = reference_of(cells.shape[0]).decode(torch.as_tensor(cells), lost)
    assert torch.equal(ok, res.ok) and torch.equal(corrected, res.corrected.to(torch.uint8))
    return res.ok, rebuilt, res.corrected.to(torch.uint8)


def assert_true_bytes(got, clean, lost, columns):
    """The lost cells' own bytes come back, ok, in `columns`."""
    columns = torch.as_tensor(columns)
    assert bool(got.ok[columns].all())
    assert torch.equal(got.rebuilt[:, columns], torch.as_tensor(clean[list(lost)])[:, columns])


def assert_equal(got, ok, rebuilt, corrected):
    assert got.ok.dtype == torch.bool and got.rebuilt.dtype == torch.uint8
    assert got.corrected.dtype == torch.uint8 and got.failed.dtype == torch.int32
    assert got.failed.shape == ()
    assert torch.equal(got.ok, ok)
    assert torch.equal(got.rebuilt, rebuilt)
    assert torch.equal(got.corrected, corrected)
    assert int(got.failed) == int((~ok).sum())


def lost_cells(n, e, kind, seed):
    """e distinct lost cells, in an order drawn from the seed: data cells,
    parity cells, or a data and a parity cell and the rest anywhere."""
    rng = np.random.default_rng(seed + 2)
    k = n - CODES[n]
    if kind != "mixed":
        pool = range(k) if kind == "data" else range(k, n)
        return rng.choice(list(pool), e, replace=False).tolist()
    lost = [int(rng.integers(0, k)), int(rng.integers(k, n))][:e]
    rest = [c for c in range(n) if c not in lost]
    lost += rng.choice(rest, e - len(lost), replace=False).tolist()
    rng.shuffle(lost)
    return lost


CASES = [(14, 1, "data"), (14, 1, "parity"), (14, 2, "mixed"), (14, 3, "data"),
         (14, 4, "mixed"), (14, 4, "parity"), (9, 1, "data"), (9, 2, "parity"),
         (9, 3, "mixed")]


@pytest.mark.parametrize("n,e,kind", CASES)
def test_reconstruct_equals_row_decode(n, e, kind):
    codec = codec_of(n)
    lost = lost_cells(n, e, kind, seed=n * 10 + e)
    clean = codewords(codec, n, 300, seed=e)
    cells = hurt(clean, lost, 1, 0.3, seed=e)
    got = codec.reconstruct(cells, lost)
    assert_equal(got, *by_decode(codec, cells, lost))
    sound = (cells == clean)[[c for c in range(n) if c not in lost]].all(0)
    within = sound | (e + 2 <= CODES[n])
    assert_true_bytes(got, clean, lost, within)
    # a few columns one at a time, through the single-codeword decode
    k = n - CODES[n]
    order = sorted(lost)
    for t in (0, 7, 299):
        col = cells[:, t].copy()
        col[lost] = 0
        res = codec.decode(col[:k], col[k:], erasures=order)
        assert bool(res.ok) == bool(got.ok[t]) and int(res.corrected) == int(got.corrected[t])
        if sound[t]:      # the erasure form's apply is right there, for data cells
            for u, q in enumerate(lost):
                if q < k:
                    assert int(res.data[q]) == int(got.rebuilt[u, t])


@pytest.mark.parametrize("n,e", [(14, 1), (14, 2), (14, 3), (14, 4), (9, 2)])
def test_matches_jax_erasure_decode(n, e):
    jax_rs = pytest.importorskip("libpoporon_tpu.models.rs")
    jax_config = pytest.importorskip("libpoporon_tpu.config")
    nr, k = CODES[n], n - CODES[n]
    codec = codec_of(n)
    lost = lost_cells(n, e, "mixed", seed=40 + e)
    cells = hurt(codewords(codec, n, 17, seed=40 + e), lost, 1, 0.5, seed=40 + e)
    clean = codewords(codec, n, 17, seed=40 + e)
    z = cells.copy()
    z[lost] = 0
    jax_codec = jax_rs.RSCodec(jax_config.RSConfig(num_roots=nr, use_pallas="off"))
    pos = np.tile(np.asarray(sorted(lost), np.int32), (17, 1))
    ok, data, parity, corrected = (np.asarray(a) for a in jax_codec._decode_erasure(
        z[:k].T.copy(), z[k:].T.copy(), pos, np.full(17, e, np.int32)))
    got = codec.reconstruct(cells, lost)
    assert np.array_equal(got.ok.numpy(), ok)
    assert np.array_equal(got.corrected.numpy(), corrected.astype(np.uint8))
    # the lost data cells where JAX's erasure apply is right: erasures named
    # ascending, no other error in the column
    sound = (cells == clean)[[c for c in range(n) if c not in lost]].all(0)
    data_lost = [u for u, q in enumerate(lost) if q < k]
    assert np.array_equal(got.rebuilt.numpy()[data_lost][:, sound],
                          data[:, [lost[u] for u in data_lost]].T[:, sound])
    assert_true_bytes(got, clean, lost, sound | (e + 2 <= nr))


@pytest.mark.parametrize("e,extra,within", [(1, 1, True), (2, 1, True), (1, 2, False),
                                            (3, 1, False)])
def test_extra_errors_take_the_errors_and_erasures_path(e, extra, within):
    """Survivors with symbol errors besides the erasures: ok, and the lost
    cells' own bytes back, wherever e + 2 extra <= 4; mostly not ok past
    it, those columns' lost cells zero."""
    codec = codec_of(14)
    lost = lost_cells(14, e, "mixed", seed=60 + e)
    clean = codewords(codec, 14, 200, seed=60 + e)
    cells = hurt(clean, lost, extra, 1.0, seed=60 + e)
    got = codec.reconstruct(cells, lost)
    assert_equal(got, *by_decode(codec, cells, lost))
    if within:
        assert_true_bytes(got, clean, lost, np.ones(200, bool))
    else:
        assert float(got.ok.float().mean()) < 0.5
        assert not got.rebuilt[:, ~got.ok].any()


@pytest.mark.parametrize("lost", [[3], [3, 12]])
def test_lost_cell_of_zeros(lost):
    """A lost data cell whose true bytes are zero comes back zero, ok, its
    correction not counted."""
    codec = codec_of(14)
    rng = np.random.default_rng(70)
    data = rng.integers(0, 256, (64, 10), dtype=np.uint8)
    data[:, 3] = 0
    parity = codec.encode(data).parity.numpy()
    clean = np.concatenate([data, parity], 1).T.copy()
    cells = hurt(clean, lost, 0, 0.0, seed=70)
    got = codec.reconstruct(cells, lost)
    assert_equal(got, *by_decode(codec, cells, lost))
    assert bool(got.ok.all()) and not got.rebuilt[0].any()
    assert torch.equal(got.corrected, torch.as_tensor(
        (clean[lost[1:]] != 0).sum(axis=0).astype(np.uint8)))


@pytest.mark.parametrize("L", [1, 17, 4099])
def test_any_column_count(L):
    codec = codec_of(14)
    lost = [2, 5, 13]
    clean = codewords(codec, 14, L, seed=L)
    cells = hurt(clean, lost, 1, 0.25, seed=L)
    got = codec.reconstruct(torch.as_tensor(cells), lost)
    assert tuple(got.rebuilt.shape) == (3, L) and tuple(got.ok.shape) == (L,)
    assert_equal(got, *by_decode(codec, cells, lost))
    # columns without errors among the survivors: the lost cells back,
    # parity cell 13 too
    assert_true_bytes(got, clean, lost, (cells == clean)[[0, 1, 3, 4] + list(range(6, 13))].all(0))


@pytest.mark.parametrize("lost", [[12, 3], [13, 11, 10], [10, 0, 13, 6], [8, 4, 2, 0]])
def test_any_order_gives_each_cell_its_own_bytes(lost):
    """Naming the lost cells in another order permutes the rebuilt rows
    and nothing else: each row holds its own cell's bytes, data or
    parity."""
    codec = codec_of(14)
    clean = codewords(codec, 14, 96, seed=len(lost) + 100)
    cells = hurt(clean, lost, 1, 0.2, seed=len(lost) + 100)
    got = codec.reconstruct(cells, lost)
    back = codec.reconstruct(cells, sorted(lost))
    perm = [sorted(lost).index(q) for q in lost]
    assert torch.equal(got.rebuilt, back.rebuilt[perm])
    assert torch.equal(got.ok, back.ok) and torch.equal(got.corrected, back.corrected)
    sound = (cells == clean)[[c for c in range(14) if c not in lost]].all(0)
    assert_true_bytes(got, clean, lost, sound | (len(lost) + 2 <= 4))


def test_cpu_path_launches_nothing():
    """A codec on the CPU has no kernel: reconstruct is the plain version."""
    codec = codec_of(14)
    assert codec._rs.kernel is None
    cells = codewords(codec, 14, 8, seed=1)
    got = codec.reconstruct(cells, [0])
    want = codec._rs._reconstruct(torch.as_tensor(cells), (0,))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lost,n,error", [
    ([], 14, ValueError), ([1, 1], 14, ValueError), ([14], 14, ValueError),
    ([0, 1, 2, 3, 4], 14, ValueError), ([0], 4, ValueError)])
def test_bad_arguments(lost, n, error):
    codec = codec_of(14)
    with pytest.raises(error):
        codec.reconstruct(np.zeros((n, 8), np.uint8), lost)


def test_reconstruct_is_rs_only():
    ldpc = pt.create(pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2), device="cpu")
    with pytest.raises(TypeError):
        ldpc.reconstruct(np.zeros((14, 8), np.uint8), [0])


# ------------------------------------------------------------ the plan

def emulate(codec, cells, lost):
    """The stripe kernel's table path in NumPy: the outputs of each column
    and the columns it leaves to the errors-and-erasures path."""
    rs = codec._rs
    n, L = cells.shape
    plan = stripe_plan(gf_tables(rs), rs.num_roots, rs.fcr, rs.prim, rs.prim_inv, n,
                       tuple(lost))
    assert plan.fast
    acc = np.zeros(L, np.uint32)
    for r, j in enumerate(plan.surv):
        x = cells[j].astype(np.int64)
        acc ^= plan.nibbles[r, 0][x & 15] ^ plan.nibbles[r, 1][x >> 4]
    rebuilt = np.stack([((acc >> 8 * t) & 0xFF).astype(np.uint8) for t in range(len(lost))])
    return (acc & plan.tmask) != 0, rebuilt, (rebuilt != 0).sum(axis=0).astype(np.uint8)


@pytest.mark.parametrize("n,lost", [(14, [0]), (14, [13]), (14, [9, 2]), (14, [1, 7, 12]),
                                    (14, [13, 0, 5, 10]), (9, [4, 8]), (9, [0, 3, 6])])
def test_plan_tables_equal_the_plain_version(n, lost):
    """Where the tables leave a column to the table path, its outputs are
    the plain version's; every column whose survivors hold at most
    nr - e errors goes to the errors-and-erasures path."""
    codec = codec_of(n)
    e, nr = len(lost), CODES[n]
    cells = hurt(codewords(codec, n, 500, seed=80 + e), lost, 1, 0.4, seed=80 + e)
    got = codec.reconstruct(cells, lost)
    todo, rebuilt, count = emulate(codec, cells, lost)
    table = ~todo
    assert bool(got.ok.numpy()[table].all())
    assert np.array_equal(got.rebuilt.numpy()[:, table], rebuilt[:, table])
    assert np.array_equal(got.corrected.numpy()[table], count[table])
    hit = (cells != hurt(codewords(codec, n, 500, seed=80 + e), lost, 0, 0.0,
                         seed=80 + e)).any(axis=0)
    if e < nr:
        assert todo[hit].all() and not todo[~hit].any()
    else:
        assert not todo.any()


def test_plan_without_tables_past_four_roots():
    rs = pt.create(pt.RSConfig(num_roots=32), device="cpu")._rs
    plan = stripe_plan(gf_tables(rs), 32, rs.fcr, rs.prim, rs.prim_inv, 40, (1, 2))
    assert not plan.fast and plan.surv == tuple(c for c in range(40) if c not in (1, 2))


# ---------------------------------------------------- the plain reference

@pytest.mark.parametrize("n,lost", [(14, [6]), (14, [2, 11]), (14, [12, 4, 0]),
                                    (14, [0, 1, 10, 13]), (9, [1, 7])])
def test_benchmark_reference_equals_the_port(n, lost):
    nr = CODES[n]
    ref = reference_of(n)
    codec = codec_of(n)
    clean = codewords(codec, n, 400, seed=90 + len(lost))
    info = torch.as_tensor(clean[: n - nr])
    assert np.array_equal(ref.encode(info).numpy(), clean)
    cells = hurt(clean, lost, 1, 0.3, seed=90)
    cells[:, ::7] = hurt(clean, lost, 2, 1.0, seed=91)[:, ::7]
    ok, rebuilt, parity, corrected = ref.decode(torch.as_tensor(cells), lost)
    got = codec.reconstruct(cells, lost)
    assert parity.numel() == 0
    assert torch.equal(ok, got.ok) and torch.equal(rebuilt, got.rebuilt)
    assert torch.equal(corrected, got.corrected)


def test_benchmark_control_is_not_correct():
    cfg = json.loads(open("fecbench/configs/rs14_10_hdfs.json").read())
    clean = torch.as_tensor(codewords(codec_of(14), 14, 400, seed=95))
    want = rs_stripe.Reference(cfg, "cpu").decode(clean, [3])
    got = rs_stripe.control(cfg, "cpu").decode(clean, [3])
    assert bool(want[0].all()) and torch.equal(want[1][0], clean[3])
    assert float((got[1] != want[1]).float().mean()) > 0.5


# ------------------------------------------------------------ spans

def profiled(fn, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("cat") == "user_annotation"]


def test_stripe_spans_nest(tmp_path):
    codec = codec_of(14)
    cells = codewords(codec, 14, 32, seed=5)
    _, events = profiled(lambda: [codec.reconstruct(cells, [4]) for _ in range(2)], tmp_path)
    facade = [e for e in events if e["name"] == "poporon.facade.reconstruct"]
    inner = [e for e in events if e["name"] == "poporon.codec.reconstruct"]
    assert len(facade) == len(inner) == 2
    for f in facade:
        a, b = float(f["ts"]), float(f["ts"]) + float(f["dur"])
        assert sum(a <= float(c["ts"]) and float(c["ts"]) + float(c["dur"]) <= b + 1e-3
                   for c in inner) == 1
    # the CPU runs the plain version: no launch span
    assert not [e for e in events if e["name"].startswith("poporon.launch.")]


def test_no_profiler_no_record_function(tmp_path, monkeypatch):
    codec = codec_of(14)
    cells = codewords(codec, 14, 32, seed=6)
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    plain = codec.reconstruct(cells, [4, 11])
    assert calls == []
    traced, _ = profiled(lambda: codec.reconstruct(cells, [4, 11]), tmp_path)
    assert calls == ["poporon.facade.reconstruct", "poporon.codec.reconstruct"]
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the card

@pytest.mark.parametrize("L", [131072, 131071])
def test_card_stripe_kernel_equals_plain(L):
    """One launch of the stripe kernel, equal to the plain version on the
    card (16-byte loads at 131,072 columns, bytes at 131,071), the last
    pattern with more shared memory than the one before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card, and torch sees none")
    codec = codec_of(14, "cuda")
    kern = codec._rs.kernel
    for lost in ([5], [0, 12], [13, 2, 7], [1, 4, 10, 11], [6]):
        clean = codewords(codec, 14, L, seed=len(lost))
        hurt_cells = hurt(clean, lost, 1, 0.1, seed=len(lost))
        cells = torch.as_tensor(hurt_cells, device="cuda")
        before = kern.stripe_launches
        got = codec.reconstruct(cells, lost)
        assert kern.stripe_launches == before + 1
        want = codec._rs._reconstruct(cells, tuple(lost))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        sound = (hurt_cells == clean)[[c for c in range(14) if c not in lost]].all(0)
        got = type(got)(*(t.cpu() for t in got))
        assert_true_bytes(got, clean, lost, sound | (len(lost) + 2 <= 4))
