"""bch.host_us: the host's own time a request in the port's BCH decode
below the facade, the self times of its two spans summed
(fecbench/spans.py): `poporon.codec.decode` (the choice of path) and
`poporon.launch.bch_decode` (the inputs' checks, the output allocations
and the library call)."""

from fecbench import spans

NAMES = ("poporon.codec.decode", "poporon.launch.bch_decode")


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    mine = [s for name in NAMES for s in found.select(name)]
    return found.per_request(sum(s.self_us for s in mine), mine)
