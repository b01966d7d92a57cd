"""bit_flips: every bit of every m-bit symbol, data and parity, flips
independently with probability `per_bit`, as on a link whose bit errors
are independent (no bursts); a symbol's error is the XOR of its flips.
m is the reference's symbol width.  The decode gets the hurt data and
parity, in their own dtype."""

import torch

BLOCK_ROWS = 16384     # rows drawn at a time, to bound the draw's memory


def errors(g: torch.Generator, rows: int, n: int, m: int, per_bit: float, device) -> torch.Tensor:
    """int32 [rows, n]: each of a symbol's m bits set with probability
    per_bit."""
    out = torch.zeros(rows, n, dtype=torch.int32, device=device)
    for r in range(0, rows, BLOCK_ROWS):
        part = out[r: r + BLOCK_ROWS]
        for b in range(m):
            flip = torch.rand(part.shape, generator=g, device=device) < per_bit
            part |= flip.to(torch.int32) << b
    return out


def hurt(g, data, parity, params, ref):
    k = data.shape[1]
    err = errors(g, data.shape[0], k + parity.shape[1], ref.m, params["per_bit"], data.device)
    return {"data": data ^ err[:, :k].to(data.dtype), "parity": parity ^ err[:, k:].to(parity.dtype)}
