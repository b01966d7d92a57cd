"""Each per-layer metric's reader on small recorded traces: stretches of
two or three requests cut from traced runs of the cells on an H100
(fecbench/tests/data/<cell>.trace.json).  A reader that finds nothing to
read returns None."""

import json
import types
from pathlib import Path

import pytest
import torch

from fecbench import roofline, run
from fecbench.generator import reference
from fecbench.tracing import Trace

from .cells import spec

DATA = Path(__file__).resolve().parent / "data"
CELLS = {"rs255.ser2.dev": 3, "ldpc128.soft.dev": 2, "ldpc128.soft.mesh4": 1}


def ctx_for(workload, launches=()):
    s = spec(workload)
    events = json.loads((DATA / f"{workload}.trace.json").read_text())["traceEvents"]
    return types.SimpleNamespace(
        trace=Trace(events), stretch_requests=CELLS[workload],
        launches=list(launches), reference=reference(s["config"], "cpu", s["traffic"]),
        config=s["config"], n_devices=s["cell"]["chips"], power_limit="test card, 700 W")


def durations(ctx, kernel):
    return [float(e["dur"]) for e in ctx.trace.device if e["cat"] == "kernel" and kernel in e["name"]]


@pytest.mark.parametrize("workload,count", [("rs255.ser2.dev", 2), ("ldpc128.soft.dev", 4)])
def test_kernels_per_call(workload, count):
    assert run.reader("codec.kernels_per_call")(ctx_for(workload))["value"] == count


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_idle_share(workload):
    ctx = ctx_for(workload)
    got = run.reader("device.idle_pct")(ctx)["value"]
    busy = {}
    for e in ctx.trace.device:            # a microsecond grid: union by counting
        a = max(int(float(e["ts"])), int(ctx.trace.t0))
        b = min(int(float(e["ts"]) + float(e["dur"])), int(ctx.trace.t1))
        busy.setdefault(Trace.device_of(e), set()).update(range(a, b))
    want = 100 * (1 - sum(map(len, busy.values())) / ctx.n_devices / (ctx.trace.t1 - ctx.trace.t0))
    assert 0 < got < 100 and got == pytest.approx(want, abs=0.5)


def test_rs_rooflines():
    errors = torch.full((131072,), 2, dtype=torch.int32)
    ctx = ctx_for("rs255.ser2.dev", launches=[{"ok": torch.ones(131072, dtype=torch.bool),
                                               "corrected": errors}])
    syn = run.reader("rs_syndrome_roofline")(ctx)
    dec = run.reader("rs_decode_roofline")(ctx)
    b_syn = roofline.rs_syndrome_bound(131072, 255, 32)
    b_dec = roofline.rs_decode_bound(255, 32, 255, errors)
    us = durations(ctx, "rs_syndrome_kernel")
    assert len(us) == 3 and syn["value"] == pytest.approx(100 * b_syn["bound_ms"] * 1e3 * 3 / sum(us))
    us = durations(ctx, "rs_decode_kernel")
    assert dec["value"] == pytest.approx(100 * b_dec["bound_ms"] * 1e3 * 3 / sum(us))
    assert syn["bound_by"] == "operations" and dec["bound_by"] == "bytes"
    assert 0 < syn["value"] < 100 and 0 < dec["value"] < 100
    assert syn["power_limit"] == "test card, 700 W"


def test_ldpc_roofline():
    ok = torch.ones(131072, dtype=torch.bool)
    iters = torch.full((131072,), 2, dtype=torch.int32)
    ctx = ctx_for("ldpc128.soft.dev", launches=[{"ok": ok, "corrected": iters}])
    got = run.reader("ldpc_bp_roofline")(ctx)
    b = roofline.ldpc_bp_bound(ctx.reference.E, 2048, ok, iters)
    us = durations(ctx, "ldpc_bp_kernel")
    assert got["value"] == pytest.approx(100 * b["bound_ms"] * 1e3 * len(us) / sum(us))
    assert got["bound_by"] == "operations" and 0 < got["value"] < 100


def test_readers_find_nothing():
    rs = ctx_for("rs255.ser2.dev")
    for name in ("shard.peer_copy_ms", "rs_syndrome_roofline", "ldpc_bp_roofline"):
        assert run.reader(name)(rs) is None
    rs.trace = None
    for name in ("codec.kernels_per_call", "device.idle_pct"):
        assert run.reader(name)(rs) is None


def test_peer_copies():
    ctx = ctx_for("ldpc128.soft.mesh4")
    copies = [e for e in ctx.trace.device if "PtoP" in e["name"] or "direct_copy" in e["name"]]
    # one request: the LLR shards by peer memcpy, the data and parity shards by
    # copy kernels, and the four fields of three shards joined back
    assert sum("PtoP" in e["name"] for e in copies) == 3 + 12
    assert sum("direct_copy" in e["name"] for e in copies) == 6
    want = sum(float(e["dur"]) for e in copies) / 1e3
    assert run.reader("shard.peer_copy_ms")(ctx)["value"] == pytest.approx(want)
    assert run.reader("ldpc_bp_roofline")(ctx_for("ldpc128.soft.mesh4", launches=[
        {"ok": torch.ones(131072, dtype=torch.bool),
         "corrected": torch.full((131072,), 2, dtype=torch.int32)}] * 4))["value"] < 100
