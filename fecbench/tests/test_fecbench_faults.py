"""A run of each cell, past the harness's look for a card, with the timed
path broken underneath, has to come out not correct: once for each fault
the cell can have.  Small batches of the cells' own mixes, on the CPU.

- unchanged: a decode returns its input as it came, as if the step had
  not run;
- half: only the first half of a batch is decoded;
- exchange: the sharded join keeps the first card's rows and never
  receives the others';
- altered: one byte of an answer is changed where it is produced."""

import time

import pytest
import torch

from fecbench import run
from libpoporon_tpu_torch.facade import Codec, DecodeResult
from libpoporon_tpu_torch.parallel import ShardedCodec

from .cells import SMALL, spec

REAL_DECODE, REAL_JOIN = Codec.decode, ShardedCodec._join


def unchanged_decode(self, data, parity, **kw):
    B = data.shape[0]
    return DecodeResult(torch.ones(B, dtype=torch.bool, device=data.device), data, parity,
                        torch.zeros(B, dtype=torch.int32, device=data.device))


def half_decode(self, data, parity, **kw):
    out = REAL_DECODE(self, data, parity, **kw)
    rest = unchanged_decode(self, data, parity)
    h = (len(out.ok) + 1) // 2
    return DecodeResult(*(torch.cat([a[:h], b[h:]]) for a, b in zip(out, rest)))


def altered_decode(self, data, parity, **kw):
    out = REAL_DECODE(self, data, parity, **kw)
    d = out.data.clone()
    d[0, 8] ^= 1
    return DecodeResult(out.ok, d, out.parity, out.corrected)


def exchange_join(self, parts, n):
    first = parts[0]
    return REAL_JOIN(self, [first] + [[torch.zeros_like(t) for t in first]] * (len(parts) - 1), n)


FAULTS = {"unchanged": {"decode": unchanged_decode},
          "half": {"decode": half_decode},
          "altered": {"decode": altered_decode},
          "exchange": {"_join": exchange_join}}
CASES = [(w, f) for w in sorted(SMALL) for f in FAULTS
         if f != "exchange" or w.endswith("mesh4")]


def small_run(workload, seed=2**31 + 4242):
    s = spec(workload, SMALL[workload])
    return run.run_cell(s, seed, 0.05, False, ["cpu"] * s["cell"]["chips"], time.perf_counter())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    r = small_run(workload)
    assert r["correct"] and r["requests_checked"] > 0


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(monkeypatch, workload, fault):
    for name, fn in FAULTS[fault].items():
        monkeypatch.setattr(ShardedCodec if name == "_join" else Codec, name, fn)
    r = small_run(workload)
    assert not r["correct"]
    assert r["checks"]["requests_differ"]["value"] > 0
