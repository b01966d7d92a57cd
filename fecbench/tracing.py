"""What a `--trace 1` run records: a torch.profiler trace of a bounded
stretch of the window, reduced to device busy time, kernel times by name
and the idle gaps by what the host was doing.

The profiler records host operations and every device operation
(kernels, copies, memsets) of the stretch; its Chrome trace goes to a
file under TMPDIR, is read back, and is deleted.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

import torch

STRETCH_AFTER_S = 1.0   # the stretch starts at the first request past this
STRETCH_S = 1.0         # and ends at the first request past this much more
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Stretch:
    """Starts and stops the profiler around whole requests of the window."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.prof = None
        self.done = False
        self.requests = 0

    def _sync(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def warm(self, fn):
        """Profile one call of fn outside the window, so that the profiler's
        own first start is paid in set-up."""
        with torch.profiler.profile(activities=self._activities()):
            fn()
            self._sync()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in self.devices):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def before(self, elapsed: float, at_cycle: bool) -> bool:
        """Called before each request with the seconds since the window's
        start and whether the request begins a cycle of the mix's kinds;
        says whether the request is inside the stretch, which starts and
        ends at cycles only."""
        if self.done:
            return False
        if at_cycle and self.prof is None and elapsed >= STRETCH_AFTER_S:
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.annotation = torch.profiler.record_function("fecbench.stretch")
            self.annotation.__enter__()
            self.t_start = elapsed
        elif at_cycle and self.prof is not None and elapsed >= self.t_start + STRETCH_S:
            self.close()
            return False
        if self.prof is None:
            return False
        self.requests += 1
        return True

    def close(self):
        if self.prof is not None and not self.done:
            self._sync()
            self.annotation.__exit__(None, None, None)
            self.prof.stop()
        self.done = True

    def events(self):
        """The trace's events as Chrome trace dicts (None if the window
        ended before the stretch began)."""
        self.close()
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(prefix="fecbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return events


class Trace:
    """The stretch's events, split into device and host operations, with
    the stretch's bounds in the trace's clock (microseconds)."""

    def __init__(self, events: list[dict]):
        stretch = [e for e in events if e.get("name") == "fecbench.stretch"
                   and e.get("cat") == "user_annotation"]
        if not stretch:
            raise ValueError("the trace has no fecbench.stretch annotation")
        self.t0 = float(stretch[0]["ts"])
        self.t1 = self.t0 + float(stretch[0]["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
                     and e.get("name") != "fecbench.stretch"]

    @staticmethod
    def device_of(e) -> int:
        return int(e.get("args", {}).get("device", e.get("pid", 0)))

    def busy(self) -> dict[int, list[tuple[float, float]]]:
        """Per device, the union of its operations' intervals inside the
        stretch, as sorted disjoint (start, end) pairs."""
        spans = collections.defaultdict(list)
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                spans[self.device_of(e)].append((a, b))
        out = {}
        for dev, iv in spans.items():
            iv.sort()
            merged = [list(iv[0])]
            for a, b in iv[1:]:
                if a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            out[dev] = [tuple(m) for m in merged]
        return out

    def busy_s(self, n_devices: int) -> float:
        """Seconds some operation ran, averaged over the devices used."""
        total = sum(b - a for iv in self.busy().values() for a, b in iv)
        return total / n_devices / 1e6

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        by = collections.Counter()
        for e in self.device:
            by[short(e["name"])] += float(e["dur"]) / 1e6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Device idle time inside the stretch, summed by the innermost
        host operation under each gap's midpoint: [name, seconds]."""
        gaps = []
        for iv in self.busy().values():
            edges = [self.t0] + [x for ab in iv for x in ab] + [self.t1]
            gaps += [((a + b) / 2, b - a) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = sorted(((float(e["ts"]), float(e["dur"]), e["name"]) for e in self.host))
        by = collections.Counter()
        active, j = [], 0
        for mid, length in sorted(gaps):
            while j < len(host) and host[j][0] <= mid:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[0] + h[1] >= mid]
            name = min(active, key=lambda h: h[1])[2] if active else "harness, between requests"
            by[short(name)] += length / 1e6
        return [[n, s] for n, s in by.most_common(top)]


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list, at most 96 letters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].strip()[:96]
