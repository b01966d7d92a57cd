"""The stripe cell (`rs14_10.bg128.dev`) at a small size on the CPU: its
inputs fixed by the seed, a kind a count of lost cells, the check's
verdict on the program's answers, on altered answers, on answers the
reference shares but the lost cells do not, and on the control's, and
the roofline's byte count."""

import importlib

import pytest
import torch

from fecbench import control, generator

from .cells import spec

WORKLOAD = "rs14_10.bg128.dev"
SMALL = {"columns": 2048}


def mix_of(seed):
    s = spec(WORKLOAD, SMALL)
    mix = generator.make_mix(s["config"], s["traffic"], seed, ["cpu"]).make_inputs()
    mix.run_reference(generator.reference(s["config"], "cpu", s["traffic"]))
    return s, mix


def answers(mix, system):
    return [(item, mix.keep(mix.call(system, item))) for item in mix.order]


def test_same_seed_same_inputs():
    seed = 2**31 + 977
    (_, a), (_, b), (_, c) = mix_of(seed), mix_of(seed), mix_of(seed + 1)
    assert a.order == b.order and [x["lost"] for x in a.pool] == [x["lost"] for x in b.pool]
    assert all(torch.equal(x["cells"], y["cells"]) for x, y in zip(a.pool, b.pool))
    assert not all(torch.equal(x["cells"], y["cells"]) for x, y in zip(a.pool, c.pool))
    assert sorted(len(x["lost"]) for x in a.pool) == [1, 1, 2]
    for x, truth in zip(a.pool, a.truth):      # lost cells zero-filled, their bytes kept
        assert not x["cells"][x["lost"]].any() and tuple(truth.shape) == (len(x["lost"]), 2048)
    # a kind a count of lost cells, so that the sampler keeps one request of each
    assert a.kinds == ("lost1", "lost2")
    assert all(k == f"lost{len(a.pool[i]['lost'])}" for k, i in a.order)


def test_check_holds_the_program_and_catches_faults():
    pt = importlib.import_module("libpoporon_tpu_torch")
    s, mix = mix_of(2**31 + 5)
    got = answers(mix, pt.create(generator.port_config(s["config"]), device="cpu"))
    assert mix.check(got) == {"requests_differ": 0, "rows_differ": 0}
    item, (failed, ok, rebuilt, corrected) = got[0]
    bad = rebuilt.clone()
    bad[0, 5] ^= 1
    assert mix.check([(item, (failed, ok, bad, corrected))]) == {
        "requests_differ": 1, "rows_differ": 1}
    assert mix.check([(item, (failed + 1, ok, rebuilt, corrected))]) == {
        "requests_differ": 1, "rows_differ": 0}
    assert mix.check([(item, (failed, ok, rebuilt[:, :-1], corrected))])["rows_differ"] == 2048
    # a reference that shares the fault does not hide it: the lost cells' own bytes
    w_ok, w_rebuilt, w_parity, w_corr = mix._expected(item[1])
    w_bad = w_rebuilt.clone()
    w_bad[0, 9] ^= 0x40
    mix.expected[item[1]] = (w_ok, w_bad, w_parity, w_corr)
    assert mix.check([(item, (failed, ok, w_bad.cpu(), corrected))]) == {
        "requests_differ": 1, "rows_differ": 1}


def test_control_is_not_correct():
    _, mix = mix_of(2**31 + 11)
    checks = mix.check(answers(mix, control.system(mix)))
    assert checks["requests_differ"] == 3 and checks["rows_differ"] > 3 * 2048 // 2


@pytest.mark.parametrize("lost,bytes_", [(1, 16 * 100 + 4), (2, 16 * 100 + 4), (4, 16 * 100 + 4)])
def test_roofline_bytes(lost, bytes_):
    reader = generator.load("metrics", "rs_stripe_roofline")
    assert reader.stripe_bytes(14, lost, 100) == bytes_
