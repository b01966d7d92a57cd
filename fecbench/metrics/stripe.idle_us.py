"""stripe.idle_us: the time a request inside `poporon.facade.reconstruct`
spans at which no operation runs on the codec's card (fecbench/spans.py,
the card's clock mapped onto the host's): the idle that the stripe
path's own host work causes, apart from the caller's read of `failed`
and the time between requests."""

from fecbench import spans


def read(ctx):
    found = spans.of(ctx)
    if found is None:
        return None
    facade = found.select("poporon.facade.reconstruct")
    return found.per_request(sum(spans.idle_us(s, found.busy) for s in facade), facade)
