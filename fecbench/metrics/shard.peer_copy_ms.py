"""shard.peer_copy_ms: device time of the copies between cards a request
(the split of the batch off the first card and the join back), summed
over the profiled stretch and divided by its requests.

A copy between cards shows in the trace either as a peer memcpy ("Memcpy
PtoP") or, where PyTorch copies through a kernel, as a `direct_copy`
kernel; in the sharded cell every such kernel is a split copy of the
data or parity rows from the first card (no shard casts on its own
card), so both kinds count."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_requests:
        return None
    us = sum(float(e["dur"]) for e in ctx.trace.device
             if (e["cat"] == "gpu_memcpy" and "PtoP" in e["name"])
             or (e["cat"] == "kernel" and "direct_copy_kernel" in e["name"]))
    return {"value": us / 1e3 / ctx.stretch_requests} if us else None
