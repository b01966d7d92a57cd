"""facade.reconstruct: each request is one `Codec.reconstruct` of the
port's facade (`libpoporon_tpu_torch.create(config)`), of a whole block
group already on the card: the shard-major cells [n, columns] of
`columns` codewords, with the mix's `lost[g]` cells of group g lost in
every column, drawn from the seed, named in the order drawn and
zero-filled.  The caller reads `failed` on the host and leaves the
rebuilt cells, ok and corrected on the card.  A request's kind is its
count of lost cells, so that the check samples each count.  It holds
every column of a sampled request to the reference
(fecbench/reference/rs_stripe.py), its ok, its rebuilt bytes and its
count, and to the encoded group, whose lost cells' bytes it must give
back; and the request's `failed` to the reference's."""

import random

import torch

from fecbench import control, generator


def kind(lost: int) -> str:
    return f"lost{lost}"


class Mix:
    def __init__(self, config, traffic, seed, devices):
        self.config, self.traffic, self.devices = config, traffic, devices
        self.dev = torch.device(devices[0])
        self.seed = seed
        self.kinds = tuple(sorted({kind(e) for e in traffic["lost"]}))
        order = list(range(len(traffic["lost"])))
        random.Random(seed).shuffle(order)
        self.order = [(kind(traffic["lost"][i]), i) for i in order]
        self.ref, self.expected = None, {}

    def make_inputs(self):
        """The pool: a block group's cells and lost cells a request, and
        the bytes the lost cells held (`truth`)."""
        tr, dev = self.traffic, self.dev
        ref = generator.reference(self.config, dev, tr)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        pick = random.Random(self.seed ^ 0x1057)
        L = tr["columns"]
        self.pool, self.truth = [], []
        for e in tr["lost"]:
            info = torch.randint(0, 256, (ref.k, L), generator=g, device=dev, dtype=torch.uint8)
            cells = ref.encode(info)
            del info
            lost = pick.sample(range(ref.n), e)
            self.truth.append(cells[lost].clone())
            cells[lost] = 0
            self.pool.append({"cells": cells, "lost": lost})
        self.payload_bytes = ref.k * L
        return self

    def build(self, codec):
        return codec

    def payload(self, item) -> int:
        return self.payload_bytes

    def call(self, system, item):
        x = self.pool[item[1]]
        if isinstance(system, control.ControlDecoder):
            # the control stands in for the facade with decode alone, and
            # gives no count: counted here
            ok, rebuilt, _, corrected = system.decode(**x)
            return int((~ok).sum()), ok, rebuilt, corrected
        res = system.reconstruct(x["cells"], x["lost"])
        return int(res.failed), res.ok, res.rebuilt, res.corrected

    def keep(self, answer):
        failed, *tensors = answer
        return (failed, *(t.cpu() for t in tensors))

    def run_reference(self, ref):
        """The reference decodes a pool group when the check first asks
        for it: only the sampled groups are needed."""
        self.ref = ref

    def _expected(self, i):
        if i not in self.expected:
            self.expected[i] = self.ref.decode(**self.pool[i])
        return self.expected[i]

    def check(self, samples) -> dict:
        """Columns of the sampled answers whose ok, rebuilt bytes or count
        differ from the reference's, or whose rebuilt bytes differ from
        the lost cells' own, and the sampled requests that hold such a
        column or whose `failed` differs from the reference's."""
        rows = requests = 0
        for (_, i), (failed, ok, rebuilt, corrected) in samples:
            w_ok, w_rebuilt, _, w_corr = self._expected(i)
            if (ok.shape, rebuilt.shape, corrected.shape) != (w_ok.shape, w_rebuilt.shape,
                                                              w_corr.shape):
                rows += w_ok.numel()
                requests += 1
                continue
            rebuilt = rebuilt.to(self.dev)
            bad = ((ok.to(self.dev) != w_ok) | (corrected.to(self.dev) != w_corr)
                   | (rebuilt != w_rebuilt).any(dim=0) | (rebuilt != self.truth[i]).any(dim=0))
            n_bad = int(bad.sum())
            rows += n_bad
            requests += int(n_bad > 0 or failed != int((~w_ok).sum()))
        return {"requests_differ": requests, "rows_differ": rows}

    def launches(self, n_devices: int) -> list[dict]:
        """The shape of each stripe launch the cell cycles through: one a
        pool group."""
        return [{"cells": x["cells"].shape[0], "columns": x["cells"].shape[1],
                 "lost": len(x["lost"])} for x in self.pool]
