"""The readers of the program's spans (fecbench/spans.py and the six
metrics that use it): hand-made event lists with known answers, and
recorded stretches of the cells on an H100 with the program's spans and
the `correlation` arguments kept
(fecbench/tests/data/<cell>.spans.trace.json, written by
fecbench/tests/record_trace.py)."""

import json
import types
from pathlib import Path

import pytest

from fecbench import run, spans
from fecbench.tracing import Trace

DATA = Path(__file__).resolve().parent / "data"
ONE_CARD = ["rs255.ser2.dev", "ldpc128.soft.dev"]
MESH = "ldpc128.soft.mesh4"
NEW = ["facade.host_us", "codec.host_us", "launch.host_us", "facade.idle_us",
       "shard.issue_lag_ms", "shard.split_device_ms"]
PEER_COPY = ("PtoP", "direct_copy")
KERNELS = {"rs255.ser2.dev": {"rs_syndrome_kernel": "poporon.launch.rs_syndrome",
                              "rs_decode_kernel": "poporon.launch.rs_decode"},
           "ldpc128.soft.dev": {"ldpc_bp_kernel": "poporon.launch.ldpc_bp"}}


def host(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(corr, ts, tid=1):
    return host("cudaLaunchKernel", ts, 1.0, cat="cuda_runtime", tid=tid, corr=corr)


def device(name, corr, ts, dur, dev=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": dev, "tid": 7, "ts": ts, "dur": dur,
            "args": {"device": dev, "correlation": corr}}


def ctx_of(events, requests, n_devices=1):
    return types.SimpleNamespace(trace=Trace(events), stretch_requests=requests,
                                 n_devices=n_devices)


def one_card_events():
    """Two requests on one card: an RS decode (syndromes inside the decode
    launch, a copy from the facade's own code) and an LDPC decode; a read
    by the harness between them launches outside any span."""
    return [
        host("fecbench.stretch", 0.0, 100.0),
        host("poporon.facade.decode", -5.0, 3.0),        # begins before the stretch
        host("poporon.facade.decode", 10.0, 40.0),
        host("poporon.codec.decode", 15.0, 30.0),
        host("poporon.launch.rs_decode", 20.0, 20.0),
        host("poporon.launch.rs_syndrome", 22.0, 8.0),
        launch(1, 25.0), device("rs_syndrome_kernel", 1, 26.0, 10.0),
        launch(2, 35.0), device("rs_decode_kernel", 2, 36.0, 11.0),
        launch(3, 48.0), device("Memcpy HtoD", 3, 49.0, 3.0, cat="gpu_memcpy"),
        launch(4, 60.0), device("Memcpy DtoH", 4, 61.0, 1.0, cat="gpu_memcpy"),
        host("poporon.facade.decode", 70.0, 20.0),
        host("poporon.codec.decode", 72.0, 16.0),
        host("poporon.launch.ldpc_bp", 74.0, 6.0),
        launch(5, 76.0), device("ldpc_bp_kernel", 5, 77.0, 18.0),
    ]


def mesh_events():
    """One sharded request over three cards: the split's copy and copy
    kernel, three shards' decodes, and the join's copy back."""
    return [
        host("fecbench.stretch", 0.0, 100.0),
        host("poporon.shard.decode", 0.0, 95.0),
        host("poporon.shard.split", 2.0, 18.0),
        launch(11, 5.0), device("Memcpy PtoP", 11, 6.0, 10.0, dev=1, cat="gpu_memcpy"),
        launch(12, 10.0), device("direct_copy_kernel_cuda", 12, 10.0, 4.0),
        host("poporon.facade.decode", 21.0, 9.0),
        host("poporon.facade.decode", 31.0, 9.0),
        host("poporon.facade.decode", 41.0, 19.0),
        host("poporon.shard.join", 61.0, 29.0),
        launch(13, 65.0), device("Memcpy PtoP", 13, 66.0, 4.0, dev=2, cat="gpu_memcpy"),
    ]


def value(name, ctx):
    got = run.reader(name)(ctx)
    return None if got is None else got["value"]


def test_nesting_and_attribution():
    found = spans.of(ctx_of(one_card_events(), 2))
    assert [r.name for r in found.roots] == ["poporon.facade.decode"] * 2
    owners = {op["args"]["correlation"]: s.name for r in found.roots for s in r.walk()
              for op in s.ops}
    assert owners == {1: "poporon.launch.rs_syndrome", 2: "poporon.launch.rs_decode",
                      3: "poporon.facade.decode", 5: "poporon.launch.ldpc_bp"}
    (syn,) = found.select("poporon.launch.rs_syndrome")
    (dec,) = found.select("poporon.launch.rs_decode")
    assert syn in dec.children and dec.self_us == 12.0
    assert len(found.select("poporon.launch.")) == 3


def test_one_card_metrics():
    ctx = ctx_of(one_card_events(), 2)
    got = {n: value(n, ctx) for n in NEW}
    # self times: facade 10 and 4, codec 10 and 10, launches 12 + 8 and 6
    assert got["facade.host_us"] == pytest.approx(7.0)
    assert got["codec.host_us"] == pytest.approx(10.0)
    assert got["launch.host_us"] == pytest.approx(13.0)
    # facade [10, 50] busy 26-47 and 49-50: idle 18; [70, 90] busy 77-90: idle 7
    assert got["facade.idle_us"] == pytest.approx(12.5)
    assert got["shard.issue_lag_ms"] is None and got["shard.split_device_ms"] is None


def test_mesh_metrics():
    ctx = ctx_of(mesh_events(), 1, n_devices=3)
    assert value("shard.issue_lag_ms", ctx) == pytest.approx(41.0 / 1e3)
    assert value("shard.split_device_ms", ctx) == pytest.approx(14.0 / 1e3)
    # the old reader counts the join's copy too
    assert value("shard.peer_copy_ms", ctx) == pytest.approx(18.0 / 1e3)
    # a facade span that launched nothing is idle over every card's time
    assert value("facade.idle_us", ctx) == pytest.approx(9.0 + 9.0 + 19.0)


@pytest.mark.parametrize("rate,offset,idle", [
    (-4e-3, 0.0, 70.0),    # the card's clock loses 4 ms a second, as seen on an H100
    (0.0, -30.0, 60.0),    # every operation 20 us before its launch: moved to its call
])
def test_card_clock_mapped_onto_the_host(rate, offset, idle):
    """Twenty requests over a second; each kernel starts 10 us after its
    launch, 70 us into the facade span, on the host's clock.  The trace
    shows it at (1 + rate) times that, plus offset."""
    events = [host("fecbench.stretch", 0.0, 1e6)]
    for i in range(20):
        t = i * 50e3 + 10.0
        events += [host("poporon.facade.decode", t, 100.0), launch(100 + i, t + 60.0),
                   device("k", 100 + i, (t + 70.0) * (1 + rate) + offset, 500.0)]
    got = run.reader("facade.idle_us")(ctx_of(events, 20))
    assert got["value"] == pytest.approx(idle, abs=0.05)
    assert got["clock_drift_us_per_s"] == pytest.approx(rate * 1e6, abs=1.0)
    assert got["least_launch_lag_us"] == pytest.approx(idle - 60.0, abs=0.05)


def test_requests_must_be_outermost_spans():
    with pytest.raises(ValueError, match="outermost program spans"):
        spans.of(ctx_of(one_card_events(), 3))


@pytest.mark.parametrize("workload", ONE_CARD + [MESH])
def test_program_without_spans_reads_nothing(workload):
    """The older recordings hold no program span, as a program without
    them gives: every new reader returns None and none raises."""
    events = json.loads((DATA / f"{workload}.trace.json").read_text())["traceEvents"]
    ctx = ctx_of(events, 1)
    assert all(run.reader(n)(ctx) is None for n in NEW)
    ctx.trace = None
    assert all(run.reader(n)(ctx) is None for n in NEW)


def recorded(workload):
    raw = json.loads((DATA / f"{workload}.spans.trace.json").read_text())
    return ctx_of(raw["traceEvents"], raw["requests"], 4 if workload == MESH else 1)


@pytest.mark.parametrize("workload", ONE_CARD)
def test_recorded_self_times_partition_the_facade(workload):
    ctx = recorded(workload)
    found = spans.of(ctx)
    facade = found.select("poporon.facade.decode")
    assert len(found.roots) == len(facade) == ctx.stretch_requests
    total = sum(value(n, ctx) for n in ("facade.host_us", "codec.host_us", "launch.host_us"))
    assert total == pytest.approx(sum(s.dur for s in facade) / len(facade), rel=1e-9)
    # every kernel of the port's own is launched from its launch span
    mine = [(op["name"], s.name) for r in found.roots for s in r.walk() for op in s.ops
            if any(k in op["name"] for k in KERNELS[workload])]
    assert len(mine) == len(KERNELS[workload]) * ctx.stretch_requests
    assert all(KERNELS[workload][k] == span for name, span in mine
               for k in KERNELS[workload] if k in name)


@pytest.mark.parametrize("workload", ONE_CARD)
def test_recorded_idle_on_a_microsecond_grid(workload):
    ctx = recorded(workload)
    found = spans.of(ctx)
    busy, edges, want = set(), 0, 0
    for a, b in found.busy[0]:
        busy.update(range(int(a), int(b)))
    for s in found.select("poporon.facade.decode"):
        want += sum(t not in busy for t in range(int(s.start), int(s.end)))
        edges += 2 + 2 * sum(a < s.end and b > s.start for a, b in found.busy[0])
    got = run.reader("facade.idle_us")(ctx)
    assert got["value"] > 0 and got["value"] == pytest.approx(
        want / ctx.stretch_requests, abs=edges / ctx.stretch_requests)
    # a stretch of a few requests is too short to tell a rate
    assert got["clock_drift_us_per_s"] == 0.0


def test_recorded_split_against_peer_copies():
    ctx = recorded(MESH)
    found = spans.of(ctx)
    split = value("shard.split_device_ms", ctx)
    peer = value("shard.peer_copy_ms", ctx)
    assert 0 < split <= peer
    # the difference is the join's copies, which the older reader counts too
    join = sum(float(op["dur"]) for s in found.select("poporon.shard.join")
               for op in s.launched() if any(k in op["name"] for k in PEER_COPY))
    assert peer - split == pytest.approx(join / 1e3 / ctx.stretch_requests)
    lag = value("shard.issue_lag_ms", ctx)
    top = found.select("poporon.shard.decode")
    assert 0 < lag < sum(s.dur for s in top) / len(top) / 1e3
