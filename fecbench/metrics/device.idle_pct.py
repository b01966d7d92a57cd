"""device.idle_pct: the share of the profiled stretch in which no
operation ran on a card, averaged over the cards the cell uses."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s:
        return None
    return {"value": 100 * (1 - ctx.trace.busy_s(ctx.n_devices) / ctx.trace.window_s)}
