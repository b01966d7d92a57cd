"""The plain references against the port's CPU path, at small batches of
each mix's traffic: RS Binomial symbol errors (at rates that also make
rows the code cannot correct), soft LLRs (with noise that also makes
frames that never converge), hard LDPC decodes, and a two-entry CPU
mesh.  The loader refuses a name that has no file."""

import json
from pathlib import Path

import pytest
import torch

import libpoporon_tpu_torch as pt
from fecbench import generator
from fecbench.reference.ldpc import pack
from libpoporon_tpu_torch.parallel import ShardedCodec, batch_mesh

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
symbol_errors = generator.load("channels", "symbol_errors")
bpsk_llr8 = generator.load("channels", "bpsk_llr8")


def config(name, **changes):
    return {**json.loads((CONFIGS / f"{name}.json").read_text()), **changes}


def port(cfg):
    return pt.create(generator.port_config(cfg), device="cpu")


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("per_symbol", [(2, 255), (9, 255), (20, 255)])
def test_rs_against_port(per_symbol):
    cfg = config("rs255_223")
    ref, codec = generator.reference(cfg, "cpu"), port(cfg)
    g = torch.Generator().manual_seed(per_symbol[0])
    info = torch.randint(0, 256, (1024, 223), generator=g, dtype=torch.uint8)
    data, parity = ref.encode(info)
    assert same((data, parity), codec.encode(info))
    x = symbol_errors.hurt(g, data, parity, {"per_symbol": per_symbol}, ref)
    want = ref.decode(**x)
    assert same(want, codec.decode(**x))
    if per_symbol[0] == 20:
        assert not bool(want[0].all())          # rows past t = 16 are compared too


@pytest.mark.parametrize("sigma", [38.6, 70.0])
def test_ldpc_soft_against_port(sigma):
    cfg = config("ldpc128_r12")
    ref, codec = generator.reference(cfg, "cpu"), port(cfg)
    g = torch.Generator().manual_seed(int(sigma))
    info = torch.randint(0, 256, (256, 128), generator=g, dtype=torch.uint8)
    data, parity = ref.encode(info)
    assert same((data, parity), codec.encode(info))
    x = bpsk_llr8.hurt(g, data, parity, {"amplitude": 90, "sigma": sigma}, ref)
    want = ref.decode(**x)
    assert same(want, codec.decode(**x))
    if sigma > 60:
        assert not bool(want[0].all())


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("flips", [0, 4, 40])
def test_ldpc_hard_against_port(soft, flips):
    """Hard decodes of codewords with `flips` bits flipped a row: the hard
    configuration, and the soft one given no LLRs (the C's fallback)."""
    cfg = config("ldpc128_r12", use_soft_decode=soft)
    ref, codec = generator.reference(cfg, "cpu"), port(cfg)
    g = torch.Generator().manual_seed(100 + flips)
    data, parity = ref.encode(torch.randint(0, 256, (256, 128), generator=g, dtype=torch.uint8))
    word = torch.cat([data, parity], dim=1)
    pos = torch.rand((256, word.shape[1] * 8), generator=g).argsort(dim=1)[:, :flips]
    flip = torch.zeros(256, word.shape[1] * 8, dtype=torch.int32).scatter_(1, pos, 1)
    word = word ^ pack(flip)
    d, p = word[:, :128], word[:, 128:]
    want = ref.decode(d, p)
    assert same(want, codec.decode(d, p))
    if flips == 0:
        assert bool(want[0].all()) and not bool(want[3].any())
    if flips == 40:
        assert not bool(want[0].all())


def test_sharded_against_reference():
    cfg = config("ldpc128_r12")
    ref = generator.reference(cfg, "cpu")
    sc = ShardedCodec(port(cfg), batch_mesh(["cpu", "cpu"]))
    g = torch.Generator().manual_seed(3)
    data, parity = ref.encode(torch.randint(0, 256, (64, 128), generator=g, dtype=torch.uint8))
    x = bpsk_llr8.hurt(g, data, parity, {"amplitude": 90, "sigma": 45.0}, ref)
    assert same(ref.decode(**x), sc.decode(**x))


@pytest.mark.parametrize("folder,name", [("reference", "bch"), ("channels", "erasures"),
                                         ("entries", "stream"), ("metrics", "../run")])
def test_unknown_name_is_refused(folder, name):
    with pytest.raises(ValueError, match="no fecbench/"):
        generator.load(folder, name)


def test_unknown_family_is_refused():
    with pytest.raises(ValueError, match="reference/bch.py"):
        generator.reference(config("rs255_223", family="bch"), "cpu")
