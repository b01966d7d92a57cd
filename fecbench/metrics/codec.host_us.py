"""codec.host_us: the host's own time in the codec a request, the self
time of the `poporon.codec.decode` spans (fecbench/spans.py): RSCodec's
and LDPCCodec's checks and dispatch, outside the kernels' launch
paths."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    codec = found.select("poporon.codec.decode")
    return found.per_request(sum(s.self_us for s in codec), codec)
