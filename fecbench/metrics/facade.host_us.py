"""facade.host_us: the host's own time in the facade a request, the self
time of the `poporon.facade.decode` spans (fecbench/spans.py): the
inputs' `as_tensor`, the checks and, for LDPC, the outer gather and the
`where` that keeps a failed row's data, issued from the host."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    facade = found.select("poporon.facade.decode")
    return found.per_request(sum(s.self_us for s in facade), facade)
