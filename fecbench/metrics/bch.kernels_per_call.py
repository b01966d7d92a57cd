"""bch.kernels_per_call: device kernels launched a request of the BCH
cell, counted in the profiled stretch (memory copies and memsets are not
kernels): 1 where the BCH decode kernel carries the decode, hundreds
where the plain version does."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_requests:
        return None
    n = sum(1 for e in ctx.trace.device if e["cat"] == "kernel")
    return {"value": n / ctx.stretch_requests} if n else None
