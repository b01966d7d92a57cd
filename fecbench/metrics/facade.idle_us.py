"""facade.idle_us: the time a request inside `poporon.facade.decode`
spans at which no operation runs on the codec's card (fecbench/spans.py):
the idle that the program's own host work causes, apart from the
caller's reads of the results and the time between requests.  The
card's clock is mapped onto the host's first (fecbench/spans.py);
`clock_drift_us_per_s` is the rate by which it ran ahead, the largest
over the cards, and `least_launch_lag_us` the least time from a runtime
call to its operation's start after that: a bound on how late the
card's clock may still run, which would read as idle."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    facade = found.select("poporon.facade.decode")
    got = found.per_request(sum(spans.idle_us(s, found.busy) for s in facade), facade)
    if got is not None:
        rates = [rate for rate, _ in found.clock.values()]
        got["clock_drift_us_per_s"] = max(rates, key=abs, default=0.0) * 1e6
        got["least_launch_lag_us"] = max(found.least_lag.values(), default=None)
    return got
