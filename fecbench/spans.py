"""The port's program spans in a traced stretch, for the readers of the
per-layer metrics that read them (fecbench/metrics/).

The port opens a span at each layer boundary of a decode
(`libpoporon_tpu_torch.utils.profiling.span`: `poporon.facade.decode`,
`poporon.codec.decode`, `poporon.launch.<kernel>`, `poporon.shard.*`)
while a torch profiler records, so the spans lie in the stretch's trace
as `user_annotation` host events, on the clock of the card's operations.
Here the spans that lie wholly inside the stretch are nested by
containment on their thread: a span's parent is the innermost program
span that holds it, and its self time is its duration less the part its
child spans cover.  The outermost span of a call is one request.  Each
device operation is attributed to the innermost program span that holds
the runtime call that launched it, matched by the trace's
`args.correlation`.

The profiler's device timestamps are aligned with the host's at the
profiler's start but can run at another rate: on an H100 a kernel
appeared up to 4.3 ms before the runtime call that launched it by the
end of a one-second stretch.  So each card's clock is rescaled to the
host's before device time is set against host spans: the rate is the
slope of the lower envelope of the launch lags (an operation's start
less its runtime call's) over the stretch, anchored at the stretch's
start, and where an operation would still start before its runtime call
the card's clock moves later by as much.
"""

from __future__ import annotations

import bisect
import collections

from fecbench.tracing import Trace

PREFIX = "poporon."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
EPS_US = 1e-3          # the trace's timestamps are rounded to the nanosecond
DRIFT_BIN_US = 50e3    # one envelope point, the least launch lag, a bin
DRIFT_BINS = 4         # fewer bins with launches: too short to tell a rate


class Span:
    __slots__ = ("name", "start", "end", "children", "ops")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end
        self.children: list[Span] = []
        self.ops: list[dict] = []       # device operations launched from here

    @property
    def dur(self) -> float:
        return self.end - self.start

    @property
    def self_us(self) -> float:
        return self.dur - sum(c.dur for c in self.children)

    def walk(self):
        """The span and every span inside it, in order of start."""
        yield self
        for c in self.children:
            yield from c.walk()

    def launched(self) -> list[dict]:
        """The device operations launched from the span or any inside it."""
        return [op for s in self.walk() for op in s.ops]


def _innermost(spans: list[Span], starts: list[float], ts: float) -> Span | None:
    """The innermost of the nested `spans` (siblings, sorted by start) that
    holds the instant ts."""
    i = bisect.bisect_right(starts, ts) - 1
    if i < 0 or ts > spans[i].end + EPS_US:
        return None
    inner = _innermost(spans[i].children, [c.start for c in spans[i].children], ts)
    return inner or spans[i]


class Spans:
    """The stretch's program spans, nested, with their device operations."""

    def __init__(self, trace: Trace):
        threads = collections.defaultdict(list)
        for e in trace.host:
            if e["cat"] != "user_annotation" or not e["name"].startswith(PREFIX):
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if a >= trace.t0 - EPS_US and b <= trace.t1 + EPS_US:
                threads[(e.get("pid"), e.get("tid"))].append(Span(e["name"], a, b))
        self.roots: list[Span] = []
        self._roots_of = {}
        for thread, spans in threads.items():
            spans.sort(key=lambda s: (s.start, -s.end))
            roots, stack = [], []
            for s in spans:
                while stack and s.end > stack[-1].end + EPS_US:
                    stack.pop()
                (stack[-1].children if stack else roots).append(s)
                stack.append(s)
            self._roots_of[thread] = (roots, [r.start for r in roots])
            self.roots += roots
        self.roots.sort(key=lambda s: s.start)
        launch = {}
        for e in trace.host:
            corr = e.get("args", {}).get("correlation")
            if e["cat"] in RUNTIME_CATS and corr is not None:
                launch[corr] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
        lags = collections.defaultdict(list)
        for op in trace.device:
            thread, ts = launch.get(op.get("args", {}).get("correlation"), (None, None))
            if ts is None:
                continue
            lags[Trace.device_of(op)].append((ts, float(op["ts"]) - ts))
            if thread in self._roots_of:
                owner = _innermost(*self._roots_of[thread], ts)
                if owner is not None:
                    owner.ops.append(op)
        # each card's device clock mapped onto the host's, and its busy
        # intervals on the host's clock (overlapping, not merged)
        self.t0 = trace.t0
        self.clock = {card: clock(pairs, trace.t0) for card, pairs in lags.items()}
        # the least launch lag on the host's clock: what a card's clock
        # could still run late by, read as idle
        self.least_lag = {card: min(self.on_host(card, t + lag) - t for t, lag in pairs)
                          for card, pairs in lags.items()}
        self.busy = collections.defaultdict(list)
        for op in trace.device:
            card = Trace.device_of(op)
            start = self.on_host(card, float(op["ts"]))
            self.busy[card].append((start, start + float(op["dur"])))

    def on_host(self, card: int, ts: float) -> float:
        """A device timestamp of the card on the host's clock."""
        rate, shift = self.clock.get(card, (0.0, 0.0))
        return self.t0 + (ts - self.t0) / (1 + rate) + shift

    def select(self, name: str) -> list[Span]:
        """Every span called `name`, or, for a name that ends in a dot,
        every span whose name starts with it."""
        return [s for r in self.roots for s in r.walk()
                if s.name == name or (name.endswith(".") and s.name.startswith(name))]

    def per_request(self, total: float, spans: list[Span]) -> dict | None:
        """A reader's result: `total` over the requests, None where no span
        of the kind was found."""
        return {"value": total / len(self.roots)} if spans else None


def of(ctx) -> Spans | None:
    """The program spans of a reader's traced stretch; None where the trace
    holds none (no trace, or a program without spans).  Raises where the
    outermost spans are not the stretch's requests, one each."""
    if ctx.trace is None:
        return None
    spans = Spans(ctx.trace)
    if not spans.roots:
        return None
    if len(spans.roots) != ctx.stretch_requests:
        raise ValueError(f"{len(spans.roots)} outermost program spans in the stretch, "
                         f"which had {ctx.stretch_requests} requests")
    return spans


def clock(pairs: list[tuple[float, float]], t0: float) -> tuple[float, float]:
    """How a card's clock in the trace maps onto the host's, from (runtime
    call start, launch lag) pairs: (rate, shift), the host's time of a
    device timestamp ts being t0 + (ts - t0) / (1 + rate) + shift.  The
    rate is the least-squares slope through the least lag of each
    DRIFT_BIN_US of the stretch (0 where fewer than DRIFT_BINS bins have a
    launch); the shift keeps every operation from starting before its
    call."""
    least = {}
    for t, lag in pairs:
        k = int((t - t0) // DRIFT_BIN_US)
        if k not in least or lag < least[k][1]:
            least[k] = (t, lag)
    rate = 0.0
    if len(least) >= DRIFT_BINS:
        pts = list(least.values())
        tm = sum(t for t, _ in pts) / len(pts)
        lm = sum(lag for _, lag in pts) / len(pts)
        rate = (sum((t - tm) * (lag - lm) for t, lag in pts)
                / sum((t - tm) ** 2 for t, _ in pts))
    early = max((t - t0 - (t + lag - t0) / (1 + rate) for t, lag in pairs), default=0.0)
    return rate, max(0.0, early)


def idle_us(span: Span, busy: dict[int, list[tuple[float, float]]]) -> float:
    """Time inside the span at which no operation runs on its cards: those
    of the operations it launched, or every card of the trace where it
    launched none.  busy: Spans.busy, each card's operations on the host's
    clock."""
    cards = {Trace.device_of(op) for op in span.launched()} or set(busy)
    intervals = sorted(iv for c in cards for iv in busy.get(c, []))
    covered, reach = 0.0, span.start
    for a, b in intervals:
        a, b = max(a, reach), min(b, span.end)
        if b > a:
            covered += b - a
            reach = b
    return span.dur - covered
