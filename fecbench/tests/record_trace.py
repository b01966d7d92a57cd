"""Record a short stretch of a cell's trace for the readers' tests.

    python3 -m fecbench.tests.record_trace --workload W --seed N --requests K

runs the cell once with `--trace 1` for 3 seconds on the machine's cards,
keeps the profiled stretch's events, cuts them to K requests from the
stretch's second (the first pays for the profiler's first CUDA call,
about 2 ms) and writes them to fecbench/tests/data/<W>.spans.trace.json:
the program's `poporon.*` spans, the harness's annotations, host
operations, runtime calls and device operations, each with the only
arguments the readers read (`device` and `correlation`), and a
`fecbench.stretch` annotation around the K requests and the gap after
the last.  The file's `requests` is K.  It prints the run's result line
and the mean `fecbench.request` duration of the whole stretch, which is
what tracing costs a request while the profiler records.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
DATA = Path(__file__).resolve().parent / "data"
KEEP_ARGS = ("device", "correlation")


def record(spec: dict, seed: int, seconds: float, devices: list) -> tuple[dict, list[dict]]:
    """One traced run of the cell: its result line and every event of
    its profiled stretch."""
    from fecbench import run, tracing
    kept = []
    events = tracing.Stretch.events

    def keep(self):
        out = events(self)
        kept.append(out)
        return out

    tracing.Stretch.events = keep
    try:
        result = run.run_cell(spec, seed, seconds, True, devices, T_PROCESS)
    finally:
        tracing.Stretch.events = events
    return result, kept[0] or []


def requests(events: list[dict]) -> list[dict]:
    """The stretch's `fecbench.request` annotations, in order."""
    return sorted((e for e in events if e.get("name") == "fecbench.request"
                   and e.get("cat") == "user_annotation"), key=lambda e: float(e["ts"]))


def cut(events: list[dict], k: int) -> dict:
    """The events of k requests from the stretch's second, from the start
    of the first of them to the start of the next (or the stretch's end)."""
    from fecbench.tracing import DEVICE_CATS, HOST_CATS
    reqs = requests(events)
    stretch = next(e for e in events if e.get("name") == "fecbench.stretch")
    t0 = float(reqs[1]["ts"])
    t1 = float(reqs[k + 1]["ts"]) if len(reqs) > k + 1 else \
        float(stretch["ts"]) + float(stretch["dur"])
    out = [{"ph": "X", "cat": "user_annotation", "name": "fecbench.stretch",
            "pid": stretch.get("pid"), "tid": stretch.get("tid"), "ts": t0, "dur": t1 - t0}]
    for e in events:
        if e.get("cat") not in DEVICE_CATS + HOST_CATS or "dur" not in e \
                or e.get("name") == "fecbench.stretch":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        inside = (a < t1 and b > t0) if e["cat"] in DEVICE_CATS else (a >= t0 and b <= t1)
        if inside:
            args = {n: e["args"][n] for n in KEEP_ARGS if n in e.get("args", {})}
            out.append({f: e[f] for f in ("ph", "cat", "name", "pid", "tid", "ts", "dur")}
                       | ({"args": args} if args else {}))
    return {"requests": k, "traceEvents": out}


def main(argv=None) -> int:
    from fecbench import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    run.pin()
    import torch
    torch.set_num_threads(1)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"record_trace: the cell needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    result, events = record(spec, args.seed, 3.0, [f"cuda:{i}" for i in range(chips)])
    print(json.dumps(result), flush=True)
    durs = [float(e["dur"]) for e in requests(events)]
    print(json.dumps({"workload": args.workload, "stretch_requests": len(durs),
                      "request_us_mean": statistics.fmean(durs) if durs else None}), flush=True)
    path = DATA / f"{args.workload}.spans.trace.json"
    path.write_text(json.dumps(cut(events, args.requests)))
    print(f"wrote {path} ({path.stat().st_size} bytes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
