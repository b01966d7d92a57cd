"""facade.decode: each request is one `Codec.decode` of the port's
facade (`libpoporon_tpu_torch.create(config)`), of a batch already on
the card."""

from fecbench.generator import BatchDecode


class Mix(BatchDecode):
    def build(self, codec):
        return codec
