"""Batch sharding over a device mesh, and the statistics reduced across
it (counterpart of libpoporon_tpu/parallel)."""

from .mesh import batch_mesh, shard_batch, distributed_init
from .pipeline import ShardedCodec
from .stats import ber_stats, iteration_histogram

__all__ = [
    "batch_mesh",
    "shard_batch",
    "distributed_init",
    "ShardedCodec",
    "ber_stats",
    "iteration_histogram",
]
