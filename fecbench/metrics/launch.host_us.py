"""launch.host_us: the host's time in the kernels' launch paths a
request, the self time of the `poporon.launch.*` spans summed
(fecbench/spans.py): the wrappers' checks, output allocations, launch
sizing and the library call.  With facade.host_us and codec.host_us it
adds up to the mean `poporon.facade.decode` span of a one-card cell."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    launch = found.select("poporon.launch.")
    return found.per_request(sum(s.self_us for s in launch), launch)
