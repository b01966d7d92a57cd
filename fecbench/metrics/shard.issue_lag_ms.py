"""shard.issue_lag_ms: how late the last card gets its work a request,
from the start of a `poporon.shard.decode` span to the start of the last
shard's `poporon.facade.decode` inside it (fecbench/spans.py)."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    lags = [max(f.start for f in facades) - s.start
            for s in found.select("poporon.shard.decode")
            if (facades := [f for f in s.walk() if f.name == "poporon.facade.decode"])]
    return found.per_request(sum(lags) / 1e3, lags)
