"""symbol_errors: every symbol of data and parity is hit independently
with probability `per_symbol` = [numerator, denominator] by a random
nonzero XOR, so the errors a row are Binomial.  The decode gets the hurt
data and parity."""

import torch


def errors(g: torch.Generator, rows: int, n: int, per_symbol, device) -> torch.Tensor:
    """uint8 [rows, n]: each symbol hit with probability num/den by a
    random nonzero value, else 0."""
    num, den = per_symbol
    hit = torch.rand((rows, n), generator=g, device=device) < num / den
    val = torch.randint(1, 256, (rows, n), generator=g, device=device, dtype=torch.int32)
    return torch.where(hit, val, 0).to(torch.uint8)


def hurt(g, data, parity, params, ref):
    k = data.shape[1]
    err = errors(g, data.shape[0], k + parity.shape[1], params["per_symbol"], data.device)
    return {"data": data ^ err[:, :k], "parity": parity ^ err[:, k:]}
