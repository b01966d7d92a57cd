"""Tracing and throughput metrics on the card.

Counterpart of libpoporon_tpu/utils/profiling.py.  `trace` captures a
torch.profiler trace of host and device activity and writes it into
`log_dir` as a Chrome trace; `time_ms` and `ThroughputMeter.measure` time
a callable with CUDA events.  `trace` and `measure` measure the card
only: they raise where torch sees no CUDA device, and `measure` raises
when its callable's results are not on a CUDA device, so that no CPU time
is reported under a device metric's name.  `card_info` names the card and its power limit, which
every number taken on it carries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time

import torch


def card_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card, and torch sees no CUDA device")


def _tensors(x):
    """The tensors in a result: a tensor, or tuples, lists, dicts and
    dataclasses of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host and CUDA activity; on exit synchronise and
    write the Chrome trace to `log_dir`/trace_<ns>.json.  Yields the
    torch.profiler.profile object (for key_averages() after the block)."""
    _require_card("trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def time_ms(fn, *args, warmup: int = 3, iters: int = 10, devices=None) -> float:
    """Mean milliseconds of `iters` calls of fn(*args) after `warmup`
    calls, by CUDA events on the current stream of each card in `devices`
    (default: the current card); with several cards, the longest of their
    spans."""
    devices = [None] if devices is None else list(devices)
    for _ in range(warmup):
        fn(*args)
    for d in devices:
        torch.cuda.synchronize(d)
    spans = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in devices]
    for (start, _), d in zip(spans, devices):
        start.record(torch.cuda.current_stream(d))
    for _ in range(iters):
        fn(*args)
    for (_, end), d in zip(spans, devices):
        end.record(torch.cuda.current_stream(d))
    for _, end in spans:
        end.synchronize()
    return max(start.elapsed_time(end) for start, end in spans) / iters


class ThroughputMeter:
    """Steady-state throughput of a call on the card, by CUDA events.

    meter = ThroughputMeter(codewords_per_call=B, bits_per_codeword=n)
    stats = meter.measure(lambda: codec.decode(data, parity))
    """

    def __init__(self, codewords_per_call: int, bits_per_codeword: int = 0):
        self.codewords = codewords_per_call
        self.bits = bits_per_codeword

    def measure(self, fn, warmup: int = 2, iters: int = 5) -> dict:
        """Mean time of `iters` calls of fn() after `warmup` calls (at least
        one: the first call's results are checked to lie on a CUDA device,
        and the meter raises if any does not, or if there is none)."""
        _require_card("ThroughputMeter.measure")
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        found = list(_tensors(fn()))
        if not found or any(t.device.type != "cuda" for t in found):
            raise RuntimeError("ThroughputMeter.measure: the call's results are not all "
                               "CUDA tensors, so its work is not timed on the card")
        dt = time_ms(fn, warmup=max(warmup - 1, 0), iters=iters) / 1e3
        stats = {
            "seconds_per_call": dt,
            "codewords_per_s": self.codewords / dt,
            "device": torch.cuda.get_device_name(),
        }
        if self.bits:
            stats["mbit_per_s"] = self.codewords * self.bits / dt / 1e6
        return stats
