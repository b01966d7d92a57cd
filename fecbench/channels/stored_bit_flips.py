"""stored_bit_flips: every bit of every stored byte, data and parity,
flips independently with probability `per_bit`, as a worn flash page's
raw bit errors do (independent of each other, no 1 -> 0 retention
asymmetry).  The decode gets the hurt data and parity bytes."""

import torch

BLOCK_ROWS = 16384     # rows drawn at a time, to bound the draw's memory


def errors(g: torch.Generator, rows: int, n: int, per_bit: float, device) -> torch.Tensor:
    """uint8 [rows, n]: each of a byte's 8 bits set with probability
    per_bit."""
    out = torch.zeros(rows, n, dtype=torch.uint8, device=device)
    for r in range(0, rows, BLOCK_ROWS):
        part = out[r: r + BLOCK_ROWS]
        for b in range(8):
            flip = torch.rand(part.shape, generator=g, device=device) < per_bit
            part |= flip.to(torch.uint8) << b
    return out


def hurt(g, data, parity, params, ref):
    k = data.shape[1]
    err = errors(g, data.shape[0], k + parity.shape[1], params["per_bit"], data.device)
    return {"data": data ^ err[:, :k], "parity": parity ^ err[:, k:]}
