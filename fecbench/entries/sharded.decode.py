"""sharded.decode: each request is one `ShardedCodec.decode` over a mesh
of the cell's cards (`parallel.batch_mesh`), of a batch on the first
card, joined back there."""

from fecbench.generator import BatchDecode


class Mix(BatchDecode):
    def build(self, codec):
        from libpoporon_tpu_torch.parallel import ShardedCodec, batch_mesh
        return ShardedCodec(codec, batch_mesh(self.devices))
