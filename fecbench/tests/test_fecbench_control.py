"""The control (fecbench/control.py: the plain reference in the program's
place, with Berlekamp-Massey cut to half or the iteration budget to 3) has to
come out not correct.  On the CPU at sizes a test run holds, with seeds
fixed; with the `card` marker at each cell's own size on three seeds."""

import time

import pytest

from fecbench import run

from .cells import spec

# big enough that the cut shows on a fixed seed: RS rows with more than 8
# errors are about 2.4e-4 of all at 2 errors a row on average, LDPC
# frames needing more than 3 iterations about 6e-4 at 1e-2 BER
CPU = {"rs255.ser2.dev": {"batch": 32768, "pool": 1},
       "ldpc128.soft.dev": {"batch": 8192, "pool": 1},
       "ldpc128.soft.mesh4": {"batch": 8192, "pool": 1}}
CARD_SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def control_run(workload, seed, devices, overrides=None):
    """A run whose window holds at least one request."""
    return run.run_cell(spec(workload, overrides), seed, 0.05, False, devices,
                        time.perf_counter(), control=True)


@pytest.mark.parametrize("workload", sorted(CPU))
def test_control_fails_on_cpu(workload):
    devices = ["cpu"] * spec(workload)["cell"]["chips"]
    r = control_run(workload, 2**31 + 7, devices, CPU[workload])
    assert not r["correct"]


@pytest.mark.card
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("workload", sorted(CPU))
def test_control_fails_on_card(card, workload, seed):
    chips = spec(workload)["cell"]["chips"]
    if card < chips:
        pytest.skip(f"the cell needs {chips} cards, torch sees {card}")
    r = control_run(workload, seed, [f"cuda:{i}" for i in range(chips)])
    assert not r["correct"]
