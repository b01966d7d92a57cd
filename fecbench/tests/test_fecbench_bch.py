"""The NAND sector cell (`bch4200.rber5e-4.dev`) at small sizes on the
CPU: the channel's bit error rate, the configuration through
`generator.port_config` and the payload, inputs fixed by the seed, the
plain reference against the port's plain version, the control
(Berlekamp's algorithm cut to t - 1 steps) coming out not correct on
every seed, the readers' counting functions on a hand-counted case, and
the faults of test_fecbench_faults.py caught in this cell."""

import math
import time
import types

import pytest
import torch

from fecbench import control, generator, run
from fecbench.reference import bch as bch_ref
from libpoporon_tpu_torch.facade import Codec

from .cells import spec
from .test_fecbench_faults import FAULTS

WORKLOAD = "bch4200.rber5e-4.dev"
SMALL = {"batch": 256, "pool": 2}
# 8.4 bit errors a sector: rows of exactly t = 8 errors, which only the
# full algorithm corrects, in every batch
HEAVY = dict(SMALL, channel={"kind": "stored_bit_flips", "per_bit": 2e-3})


def mix_of(seed, overrides=SMALL):
    s = spec(WORKLOAD, overrides)
    mix = generator.make_mix(s["config"], s["traffic"], seed, ["cpu"]).make_inputs()
    mix.run_reference(generator.reference(s["config"], "cpu", s["traffic"]))
    return s, mix


def answers(mix, system):
    return [(item, mix.keep(mix.call(system, item))) for item in mix.order]


def test_channel_bit_error_rate():
    """5e-4 a bit, 2.1 bit errors a sector of 525 bytes, on 2 10^4 rows:
    within four standard errors."""
    channel = generator.load("channels", "stored_bit_flips")
    p = spec(WORKLOAD)["traffic"]["channel"]["per_bit"]
    g = torch.Generator().manual_seed(2**31 + 3)
    rows, count = 20_000, 0
    for _ in range(rows // 5_000):
        err = channel.errors(g, 5_000, 525, p, "cpu")
        count += int(sum(((err >> b) & 1).sum() for b in range(8)))
    mean = count / rows
    assert abs(4200 * p - 2.1) < 1e-9
    assert abs(mean - 2.1) < 4 * math.sqrt(2.1 / rows)


def test_config_and_payload():
    s, mix = mix_of(2**31 + 977)
    cfg = generator.port_config(s["config"])
    assert (cfg.symbol_size, cfg.generator_polynomial, cfg.correction_capability,
            cfg.data_length) == (13, 0x201B, 8, 4096)
    assert mix.payload_bytes == 256 * 512
    assert spec(WORKLOAD)["traffic"]["batch"] * 512 == 67_108_864     # 64 MiB a request
    x = mix.pool[0]
    assert x["data"].dtype == x["parity"].dtype == torch.uint8
    assert tuple(x["data"].shape) == (256, 512) and tuple(x["parity"].shape) == (256, 13)


def test_same_seed_same_inputs():
    seed = 2**31 + 977
    (_, a), (_, b), (_, c) = mix_of(seed), mix_of(seed), mix_of(seed + 1)
    assert a.order == b.order
    for x, y, z in zip(a.pool, b.pool, c.pool):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert not all(torch.equal(x[k], z[k]) for k in x)


@pytest.mark.parametrize("overrides", [SMALL, HEAVY], ids=["cell_rate", "heavy"])
def test_reference_equals_the_port(overrides):
    """The reference's answers are the port's plain version's, and the
    check reads 0 and 0 on them, at the cell's rate and past t."""
    import libpoporon_tpu_torch as pt
    s, mix = mix_of(2**31 + 7, overrides)
    codec = pt.create(generator.port_config(s["config"]), device="cpu")
    got = answers(mix, codec)
    assert mix.check(got) == {"requests_differ": 0, "rows_differ": 0}
    item, (ok, corrected, data, parity) = got[0]
    assert int(corrected.sum()) > 0
    bad = data.clone()
    bad[3, 100] ^= 0x10
    assert mix.check([(item, (ok, corrected, bad, parity))]) == {
        "requests_differ": 1, "rows_differ": 1}


@pytest.mark.parametrize("seed", [2**31 + 11, 2**32 + 5, 12345])
def test_control_is_not_correct(seed):
    _, mix = mix_of(seed, HEAVY)
    ctl = control.ControlDecoder(bch_ref.control(mix.config, "cpu"))
    checks = mix.check(answers(mix, ctl))
    assert checks["requests_differ"] == 2 and checks["rows_differ"] > 0


def test_harness_control_run_is_not_correct():
    r = run.run_cell(spec(WORKLOAD, HEAVY), 2**31 + 13, 0.05, False, ["cpu"], 0.0, control=True)
    assert not r["correct"]


def test_roofline_counts():
    roof = generator.load("metrics", "bch_decode_roofline")
    assert roof.KERNEL == "bch_decode_kernel"
    assert roof.decode_bytes(131072, 512, 13) == 131072 * (525 + 512 + 1 + 4)
    # a clean row, one of two errors and one of four: 525 steps of 4 words
    # and 8 x 26 nibbles each; BM 2 8 3 and verify 4 8 2 for the second,
    # its roots by formula; BM 2 8 5, verify 4 8 4 and Chien 2 4200 4 for
    # the third
    ops = roof.decode_ops(4200, 104, 8, torch.tensor([0, 2, 4]))
    assert ops == 3 * (525 * 4 + 8 * 26) + (48 + 64) + (80 + 128 + 33600)
    assert roof.decode_ops(4200, 104, 8, torch.tensor([3])) == 525 * 4 + 8 * 26 + 64 + 96
    ctx = types.SimpleNamespace(trace=None, launches=[], config=spec(WORKLOAD)["config"],
                                reference=types.SimpleNamespace(n=4200, pb=104, t=8,
                                                                info_bytes=512, parity_bytes=13))
    assert roof.read(ctx) is None                                # no trace: nothing to read
    for name in ("bch.kernels_per_call", "bch.host_us"):
        assert generator.load("metrics", name).read(ctx) is None


@pytest.mark.parametrize("fault", ["none", "unchanged", "half", "altered"])
def test_faults_are_caught(monkeypatch, fault):
    for name, fn in FAULTS.get(fault, {}).items():
        monkeypatch.setattr(Codec, name, fn)
    r = run.run_cell(spec(WORKLOAD, SMALL), 2**31 + 4242, 0.05, False, ["cpu"],
                     time.perf_counter())
    assert r["requests_checked"] > 0
    assert r["correct"] == (fault == "none")
    if fault != "none":
        assert r["checks"]["requests_differ"]["value"] > 0
