"""Each traffic mix's inputs and order are fixed by the seed, at small
sizes of the cells' own mixes."""

import pytest
import torch

from fecbench.generator import make_mix

from .cells import SMALL, spec


def made(workload, seed):
    s = spec(workload, SMALL[workload])
    mix = make_mix(s["config"], s["traffic"], seed, ["cpu"] * s["cell"]["chips"]).make_inputs()
    return mix.order, [t.clone() for batch in mix.pool for t in batch.values()]


def equal(a, b):
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_same_seed_same_inputs(workload):
    seed = 2**31 + 977
    first, again, other = made(workload, seed), made(workload, seed), made(workload, seed + 1)
    assert equal(first, again)
    assert not equal(first, other)
