"""Read a cell's compared numbers over many seeds in one process, for the
program and for the control, to set the limits of `correct` from.

    python3 fecbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 2]

Each seed is a whole run of the cell (inputs, warm-up, window, check) at
the cell's own size, after one process start and one library load.  One
JSON line a run: the seed, program or control, `correct`, the checks and
the end-to-end metrics.  The benchmark's own runs never call this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from fecbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    run.pin()
    import torch
    torch.set_num_threads(1)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate: the cell needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t = time.perf_counter()
            r = run.run_cell(spec, seed, args.seconds, False, devices, t, control=control)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()},
                              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                              "reference_s": r["setup_split_s"]["reference"],
                              "run_s": time.perf_counter() - t}), flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"calibrate: loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
