"""rs544.kernels_per_call: device kernels launched a request of the KP4
cell, counted in the profiled stretch (memory copies and memsets are not
kernels): 2 where the syndrome and the decode kernel carry the decode."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_requests:
        return None
    n = sum(1 for e in ctx.trace.device if e["cat"] == "kernel")
    return {"value": n / ctx.stretch_requests} if n else None
