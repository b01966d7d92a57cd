"""GF(2^m) products by log/antilog index lookups.

Counterpart of libpoporon_tpu/ops/gfint.py's `gf_mul`.  The JAX package
multiplies with a carry-less multiply and replaces table lookups by
compare-and-select (`table_select`, `onehot_select`, `scatter_mod2`)
because gathers are slow on a TPU; on a GPU an index gather is exact and
cheap, so this module keeps only the product, done the reference's way
(gf.c, common.h:102-110).
"""

from __future__ import annotations

import torch


def gf_mul(a: torch.Tensor, b: torch.Tensor, log: torch.Tensor,
           antilog: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^m) product of int tensors with values in [0, fs].

    log: [fs + 1] int32, log[0] = fs (sentinel); antilog: [fs + 1] int32,
    antilog[fs] = 0.  Operands broadcast against each other.
    """
    fs = antilog.shape[0] - 1
    s = log[a.long()] + log[b.long()]
    s = torch.where(s >= fs, s - fs, s)
    return torch.where((a == 0) | (b == 0), 0, antilog[s.long()])
