"""The cells the tests drive: BENCHMARK.json's, at the sizes the tests
use."""

from fecbench import run

SMALL = {"rs255.ser2.dev": {"batch": 512},
         "ldpc128.soft.dev": {"batch": 128},
         "ldpc128.soft.mesh4": {"batch": 128}}


def spec(workload: str, overrides: dict | None = None) -> dict:
    """run.load_cell's spec of a cell, its traffic updated by `overrides`."""
    out = run.load_cell(workload)
    out["traffic"].update(overrides or {})
    return out
