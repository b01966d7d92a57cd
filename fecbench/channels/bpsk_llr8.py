"""bpsk_llr8: each transmitted bit is sent as +-`amplitude` plus
N(0, `sigma`), rounded and clipped to int8 (negative = 1).  The decode
gets the LLRs as `soft_llr`, and their hard decisions as data and
parity beside them."""

import torch

from fecbench.generator import blocks
from fecbench.reference.ldpc import pack, unpack


def llr8(g: torch.Generator, word: torch.Tensor, amplitude, sigma) -> torch.Tensor:
    """int8 LLRs [B, 8 * bytes] of the transmitted words uint8 [B, bytes]."""
    def one(w):
        sign = 1 - 2 * unpack(w).to(torch.float32)
        noise = torch.randn(sign.shape, generator=g, device=w.device) * sigma
        return (sign * amplitude + noise).round().clamp(-127, 127).to(torch.int8)
    return blocks(one, word)


def hurt(g, data, parity, params, ref):
    k = data.shape[1]
    llr = llr8(g, torch.cat([data, parity], dim=1), params["amplitude"], params["sigma"])
    hard = blocks(lambda x: pack((x < 0).to(torch.int32)), llr)
    return {"data": hard[:, :k], "parity": hard[:, k:], "soft_llr": llr}
