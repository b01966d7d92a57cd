"""Run one cell of the benchmark of libpoporon_tpu_torch once, on the
cards of the machine it is started on.

    python3 fecbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(fecbench/configs/<config>.json) and a traffic mix
(fecbench/traffic/<mix>.json), which name the entry, the channel and the
reference that fecbench/generator.py loads; the per-layer metrics are
readers in fecbench/metrics/<metric>.py.  Set-up builds the port's codec, makes the
inputs from the seed and warms up every call the window makes; then one
closed-loop caller sends requests for `--seconds`.  After the window the
program's state is freed and the plain reference (fecbench/reference/)
judges a seeded sample of the window's answers.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics with
`--trace 0`, the per-layer ones with `--trace 1`), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each number compared
beside its limit (also the last lines of standard error).  Without
enough CUDA cards, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with 2 or 3.

`--control 1` puts the control (fecbench/control.py) in the program's
place, for setting the limits; the benchmark's own runs never use it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)        # the checkout's root, not this folder

FORBIDDEN = ("jax", "jaxlib", "flax", "libpoporon_tpu")
CORES = 2          # a run keeps to the last CORES cores it may use


def pin():
    """Keep the process on fixed cores, with one intra-op thread, so that
    the one caller's host time does not wander between cores and threads.
    Call before torch is imported, so that its threads start pinned."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-CORES:])
    os.environ["OMP_NUM_THREADS"] = "1"


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """A cell of BENCHMARK.json with its configuration, traffic mix and
    metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "fecbench" / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(name: str):
    """The `read(ctx)` function of fecbench/metrics/<name>.py."""
    from fecbench import generator
    return generator.load("metrics", name).read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The first card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Phases:
    """Seconds of each step of set-up, in order."""

    def __init__(self, start: float):
        self.mark, self.seconds = start, {}

    def __call__(self, name: str):
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.mark
        self.mark = now


def sync(devices):
    import torch
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def build_system(spec, mix, control: bool):
    """The port's system for the mix, or the control in its place."""
    from fecbench import control as control_mod
    from fecbench import generator
    if control:
        return control_mod.system(mix)
    import libpoporon_tpu_torch as pt
    return mix.build(pt.create(generator.port_config(spec["config"]), device=mix.dev))


def warm_up(mix, system, devices, samples: int):
    """Every call the window makes, as many held at once as the sampler
    holds, so that the window compiles nothing and allocates nothing new."""
    items = [mix.order[i % len(mix.order)] for i in range(max(samples + 2, len(mix.kinds)))]
    held = [mix.call(system, item) for item in items]
    sync(devices)
    del held


def window(mix, system, seconds: float, seed: int, stretch=None):
    """One closed-loop caller for `seconds`: returns the request times,
    the payload bytes completed, the window's length and the sampled
    answers."""
    import torch

    from fecbench.generator import Sampler
    per_kind = max(1, mix.traffic["samples"] // len(mix.kinds))
    sampler = Sampler(seed ^ 0x5A17, per_kind)
    times, payload = [], 0
    t_start = time.perf_counter()
    t_end, i = t_start, 0
    while t_end - t_start < seconds:
        item = mix.order[i % len(mix.order)]
        traced = stretch.before(t_end - t_start, i % len(mix.kinds) == 0) if stretch else False
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.record_function("fecbench.request"):
                answer = mix.call(system, item)
        else:
            answer = mix.call(system, item)
        t_end = time.perf_counter()
        times.append(t_end - t0)
        payload += mix.payload(item)
        sampler.offer(item[0], item, answer)
        i += 1
    if stretch:
        stretch.close()
    return types.SimpleNamespace(times=times, payload=payload, seconds=t_end - t_start,
                                 samples=sampler.samples())


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, devices: list,
             t_process: float, control: bool = False) -> dict:
    """One run of a cell on `devices`; returns the result line's object."""
    import torch

    from fecbench import generator, tracing
    phases = Phases(t_process)
    for d in devices:
        torch.zeros(1, device=d)
    sync(devices)
    phases("import_and_device_init")
    mix = generator.make_mix(spec["config"], spec["traffic"], seed, devices)
    system = build_system(spec, mix, control)
    phases("codec_build")
    mix.make_inputs()
    sync(devices)
    phases("inputs")
    mix.call(system, mix.order[0])
    sync(devices)
    phases("first_call")
    warm_up(mix, system, devices, mix.traffic["samples"])
    stretch = tracing.Stretch(devices) if trace else None
    if stretch:
        stretch.warm(lambda: mix.call(system, mix.order[0]))
    phases("warm_up")
    setup_s = time.perf_counter() - t_process

    win = window(mix, system, seconds, seed, stretch)
    sync(devices)
    cuda = [d for d in devices if torch.device(d).type == "cuda"]
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    samples = [(item, mix.keep(answer)) for item, answer in win.samples]
    del system, win.samples
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    phases.mark = time.perf_counter()
    ref = generator.reference(spec["config"], mix.dev, spec["traffic"])
    mix.run_reference(ref)
    checks = mix.check(samples)
    phases("reference")
    failed = checks["requests_differ"]
    correct = bool(samples) and all(v == 0 for v in checks.values())

    n = len(win.times)
    card = power_limit() if cuda else "no card"
    if trace:
        events = stretch.events()
        tr = tracing.Trace(events) if events else None
        ctx = types.SimpleNamespace(
            trace=tr, stretch_requests=stretch.requests, launches=mix.launches(len(devices)), reference=ref, config=spec["config"],
            n_devices=len(devices), power_limit=card)
        metrics = {}
        for m in spec["per_layer"]:
            got = reader(m["name"])(ctx)
            if got is not None:
                metrics[m["name"]] = {"value": got.pop("value"), "unit": m["unit"], **got}
    else:
        ms = sorted(t * 1e3 for t in win.times)
        values = {"goodput_MB_per_s": win.payload / win.seconds / 1e6,
                  "call_ms_p95": statistics.quantiles(ms, n=20, method="inclusive")[18]
                  if n > 1 else ms[0],
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics,
              "device": device}
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s(len(devices))
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["card"] = card
    result["measured_s"] = win.seconds
    result["requests_checked"] = len(samples)
    result["setup_split_s"] = phases.seconds
    result["checks"] = {name: {"value": v, "limit": 0} for name, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    pin()
    import torch
    torch.set_num_threads(1)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fecbench: the cell needs {chips} CUDA card(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      [f"cuda:{i}" for i in range(chips)], T_PROCESS,
                      control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"fecbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
