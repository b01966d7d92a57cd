"""shard.split_device_ms: device time a request, summed over the cards,
of the operations launched from inside `poporon.shard.split` spans: the
split's copies of the batch off the first card, found by the runtime
call that launched them (fecbench/spans.py) and not by kernel name."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    split = found.select("poporon.shard.split")
    us = sum(float(op["dur"]) for s in split for op in s.launched())
    return found.per_request(us / 1e3, split)
