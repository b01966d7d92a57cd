"""stripe.host_us: the host's own time a request in the port's stripe
path, the self times of its three spans summed (fecbench/spans.py):
`poporon.facade.reconstruct` (the input's as_tensor and the result),
`poporon.codec.reconstruct` (the checks of the cells and the lost list)
and `poporon.launch.rs_stripe` (the plan's lookup, the output
allocations and the library call)."""

from fecbench import spans

NAMES = ("poporon.facade.reconstruct", "poporon.codec.reconstruct", "poporon.launch.rs_stripe")


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    mine = [s for name in NAMES for s in found.select(name)]
    return found.per_request(sum(s.self_us for s in mine), mine)
