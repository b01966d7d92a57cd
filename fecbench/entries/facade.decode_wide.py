"""facade.decode_wide: each request is one `Codec.decode` of the port's
facade of a batch already on the card, for an RS code whose symbols are
wider than a byte: data and parity 16-bit words, each holding one m-bit
symbol.  The inputs are made from the seed: random data symbols, the
plain reference's encode, then the mix's channel.  The payload is the
data's bits, m / 8 bytes a symbol.  A codec whose `symbol_dtype` is not
16 bits wide would cut the symbols to bytes, so `build` refuses it."""

import torch

from fecbench.generator import BatchDecode, blocks, reference


class Mix(BatchDecode):
    def make_inputs(self):
        tr, dev = self.traffic, self.dev
        ref = reference(self.config, dev, tr)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        B = tr["batch"]
        self.pool = []
        for _ in range(tr["pool"]):
            info = torch.randint(0, ref.fs + 1, (B, ref.k), generator=g, device=dev,
                                 dtype=torch.int32).to(ref.symbol_dtype)
            data, parity = blocks(ref.encode, info)
            self.pool.append(self.channel.hurt(g, data, parity, tr["channel"], ref))
        self.payload_bytes = B * ref.k * ref.m // 8
        return self

    def build(self, codec):
        dtype = getattr(codec, "symbol_dtype", None)
        if dtype is None or dtype.itemsize != 2:
            raise SystemExit(f"facade.decode_wide: the codec's symbols are not 16-bit words "
                             f"(symbol_dtype {dtype}); it would cut them to bytes")
        return codec
