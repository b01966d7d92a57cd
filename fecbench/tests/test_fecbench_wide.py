"""The KP4 cell (`rs544.ber2p4e-4.dev`) at small sizes on the CPU: the
channel's symbol error rate, the entry's payload and its refusal of a
codec that holds symbols in bytes, the configuration through
`generator.port_config`, inputs fixed by the seed, the check's verdict on
the program's answers and on altered ones, both controls (symbols cut to
their low byte; Berlekamp-Massey cut short) coming out not correct, and
the roofline readers' counts."""

import math
import types

import pytest
import torch

from fecbench import control, generator, run
from fecbench.reference import rs_wide

from .cells import spec

WORKLOAD = "rs544.ber2p4e-4.dev"
SMALL = {"batch": 512, "pool": 2}


def mix_of(seed, overrides=SMALL):
    s = spec(WORKLOAD, overrides)
    mix = generator.make_mix(s["config"], s["traffic"], seed, ["cpu"]).make_inputs()
    mix.run_reference(generator.reference(s["config"], "cpu", s["traffic"]))
    return s, mix


def answers(mix, system):
    return [(item, mix.keep(mix.call(system, item))) for item in mix.order]


def test_channel_symbol_error_rate():
    """1 - (1 - 2.4e-4)^10 = 2.397e-3 a symbol, 1.304 a codeword of 544, on
    10^5 rows: within four standard errors."""
    s = spec(WORKLOAD)
    ref = generator.reference(s["config"], "cpu")
    channel = generator.load("channels", "bit_flips")
    p_bit = s["traffic"]["channel"]["per_bit"]
    p_sym = 1 - (1 - p_bit) ** 10
    g = torch.Generator().manual_seed(2**31 + 3)
    rows, count = 100_000, 0
    for _ in range(rows // 10_000):
        err = channel.errors(g, 10_000, 544, ref.m, p_bit, "cpu")
        assert int(err.max()) < 1024
        count += int((err != 0).sum())
    mean = count / rows
    assert abs(p_sym * 544 - 1.304) < 1e-3
    assert abs(mean - 544 * p_sym) < 4 * math.sqrt(544 * p_sym / rows)


def test_config_and_payload():
    s, mix = mix_of(2**31 + 977)
    cfg = generator.port_config(s["config"])
    assert (cfg.symbol_size, cfg.generator_polynomial, cfg.first_consecutive_root,
            cfg.primitive_element, cfg.num_roots) == (10, 0x409, 0, 1, 30)
    assert mix.payload_bytes == 512 * 514 * 10 // 8
    assert spec(WORKLOAD)["traffic"]["batch"] * 514 * 10 // 8 == 84_213_760   # the cell's batch
    x = mix.pool[0]
    assert x["data"].dtype == x["parity"].dtype == torch.int16
    assert tuple(x["data"].shape) == (512, 514) and tuple(x["parity"].shape) == (512, 30)
    assert int(x["data"].max()) < 1024 and int(x["data"].min()) >= 0


def test_entry_refuses_a_byte_codec():
    _, mix = mix_of(2**31 + 5)
    for codec in (types.SimpleNamespace(), types.SimpleNamespace(symbol_dtype=torch.uint8)):
        with pytest.raises(SystemExit, match="not 16-bit words"):
            mix.build(codec)


def test_same_seed_same_inputs():
    seed = 2**31 + 977
    (_, a), (_, b), (_, c) = mix_of(seed), mix_of(seed), mix_of(seed + 1)
    assert a.order == b.order
    for x, y, z in zip(a.pool, b.pool, c.pool):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert not all(torch.equal(x[k], z[k]) for k in x)


def test_check_holds_the_program_and_catches_faults():
    pt = pytest.importorskip("libpoporon_tpu_torch")
    s, mix = mix_of(2**31 + 7)
    got = answers(mix, pt.create(generator.port_config(s["config"]), device="cpu"))
    assert mix.check(got) == {"requests_differ": 0, "rows_differ": 0}
    item, (ok, corrected, data, parity) = got[0]
    bad = data.clone()
    bad[3, 100] ^= 0x200                       # a bit past the low byte
    assert mix.check([(item, (ok, corrected, bad, parity))]) == {
        "requests_differ": 1, "rows_differ": 1}


@pytest.mark.parametrize("make", [rs_wide.control_low_byte, rs_wide.control],
                         ids=["low_byte", "bm_cut"])
def test_controls_are_not_correct(make):
    """Both controls in the program's place.  The cut BM corrects 7 errors
    a row, and rows past 7 are some 7 in 131072 at the cell's rate, so here
    the channel flips bits at 2e-3 (10.8 symbol errors a row)."""
    overrides = dict(SMALL, channel={"kind": "bit_flips", "per_bit": 2e-3})
    _, mix = mix_of(2**31 + 11, overrides)
    checks = mix.check(answers(mix, control.ControlDecoder(make(mix.config, "cpu"))))
    assert checks["requests_differ"] == 2 and checks["rows_differ"] > 0


def test_harness_control_run_is_not_correct():
    """run.run_cell with the module's control (BM cut short) on the CPU."""
    overrides = dict(SMALL, channel={"kind": "bit_flips", "per_bit": 2e-3})
    r = run.run_cell(spec(WORKLOAD, overrides), 2**31 + 13, 0.05, False, ["cpu"], 0.0,
                     control=True)
    assert not r["correct"]


def test_roofline_counts():
    syn = generator.load("metrics", "rs544_syndrome_roofline")
    dec = generator.load("metrics", "rs544_decode_roofline")
    assert syn.syndrome_bytes(131072, 544, 30) == 131072 * (1088 + 120)
    assert syn.syndrome_ops(2, 544, 30) == 2 * 30 * 544 / 2
    assert dec.decode_bytes(1, 544, 30) == 1088 + 120 + 1088 + 5
    assert syn.KERNEL == "rs_syndrome_wide_kernel" and dec.KERNEL == "rs_decode_kernel"
    ctx = types.SimpleNamespace(trace=None, launches=[], config=spec(WORKLOAD)["config"],
                                reference=types.SimpleNamespace(nr=30))
    assert syn.read(ctx) is None and dec.read(ctx) is None       # no trace: nothing to read
