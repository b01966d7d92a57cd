"""BENCHMARK.json keeps to the benchmark's contract as far as files can
show it: every name, unit and limit, every configuration, traffic mix and
reader in place, and every cell with its metrics."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "fecbench/run.py"] and BENCH["paths"] == ["fecbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("fecbench/configs/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert c["source"].startswith("https://") and len(c["source"]) <= 200


def test_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = BENCH["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "fecbench" / "traffic" / f"{w['traffic']}.json").exists()
    assert configs == {w["config"] for w in cells}


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "fecbench" / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for w in cells:        # every cell reports a per-layer metric
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
