"""The port's program spans (`utils.profiling.span`) in torch.profiler
traces: one `poporon.facade.decode` a call around one
`poporon.codec.decode` on the caller's thread, the sharded decode's split,
shards and join in order, nothing recorded and nothing changed without a
profiler, and on the card each `poporon.launch.*` span holding the
runtime call that launched its kernel, matched by `correlation`.

Imports no JAX, so that the card test runs on a machine without it:
`python -m pytest --noconftest tests/test_torch_spans.py`.
"""

import json

import numpy as np
import pytest
import torch

import libpoporon_tpu_torch as pt
from libpoporon_tpu_torch.parallel import ShardedCodec, batch_mesh

torch.set_num_threads(2)

KINDS = ["rs", "ldpc_hard", "ldpc_soft"]
KERNELS = {"poporon.launch.rs_syndrome": "rs_syndrome_kernel",
           "poporon.launch.rs_decode": "rs_decode_kernel",
           "poporon.launch.ldpc_bp": "ldpc_bp_kernel"}


def call(kind, device, rows=16, seed=0):
    """A facade codec of the kind on `device` and the arguments of one
    decode: RS with two symbol errors a row, LDPC 128 B rate 1/2 hard
    (4 flipped bits a row) or soft (int8 LLRs about 1e-2 BER)."""
    rng = np.random.default_rng(seed)
    if kind == "rs":
        codec = pt.create(pt.rs_config_default(), device=device)
        data = rng.integers(0, 256, (rows, 223), dtype=np.uint8)
        parity = codec.encode(data).parity.cpu().numpy()
        data[np.arange(rows), rng.integers(0, 223, rows)] ^= 0x5A
        parity[:, 3] ^= 0x11
        return codec, (data, parity), {}
    cfg = (pt.LdpcConfig(128, pt.LdpcRate.RATE_1_2) if kind == "ldpc_hard"
           else pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2))
    codec = pt.create(cfg, device=device)
    enc = codec.encode(rng.integers(0, 256, (rows, 128), dtype=np.uint8))
    word = np.concatenate([enc.data.cpu().numpy(), enc.parity.cpu().numpy()], axis=1)
    bits = np.unpackbits(word, axis=1)
    if kind == "ldpc_hard":
        for r in range(rows):
            bits[r, rng.choice(bits.shape[1], 4, replace=False)] ^= 1
        word = np.packbits(bits, axis=1)
        return codec, (word[:, :128], word[:, 128:]), {}
    llr = np.where(bits == 1, -90.0, 90.0) + rng.normal(0, 38.6, bits.shape)
    return codec, (word[:, :128], word[:, 128:]), {
        "soft_llr": np.clip(np.round(llr), -127, 127).astype(np.int8)}


def profiled(fn, tmp_path, cuda=False):
    """fn()'s result and the events of the Chrome trace of a
    torch.profiler run around it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


def spans(events, name):
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == name), key=lambda e: float(e["ts"]))


def inside(inner, outer):
    a, b = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return (inner["pid"], inner["tid"]) == (outer["pid"], outer["tid"]) \
        and a <= float(inner["ts"]) and float(inner["ts"]) + float(inner["dur"]) <= b + 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_one_facade_span_around_one_codec_span(kind, tmp_path):
    codec, args, kw = call(kind, "cpu")
    _, events = profiled(lambda: [codec.decode(*args, **kw) for _ in range(2)], tmp_path)
    facade = spans(events, "poporon.facade.decode")
    codec_spans = spans(events, "poporon.codec.decode")
    assert len(facade) == 2 and len(codec_spans) == 2
    for f in facade:
        assert sum(inside(c, f) for c in codec_spans) == 1
    # the CPU runs the plain versions: no kernel is launched
    assert not [e for e in events if str(e.get("name", "")).startswith("poporon.launch.")]


@pytest.mark.parametrize("kind", ["rs", "ldpc_soft"])
def test_sharded_decode_spans_in_order(kind, tmp_path):
    codec, args, kw = call(kind, "cpu", rows=15)
    sc = ShardedCodec(codec, batch_mesh(["cpu"] * 2))
    _, events = profiled(lambda: sc.decode(*args, **kw), tmp_path)
    (top,) = spans(events, "poporon.shard.decode")
    (split,) = spans(events, "poporon.shard.split")
    (join,) = spans(events, "poporon.shard.join")
    facade = spans(events, "poporon.facade.decode")
    assert len(facade) == 2
    order = [split, *facade, join]
    assert all(inside(s, top) for s in order)
    for a, b in zip(order, order[1:]):
        assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"]) + 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_no_profiler_no_record_function(kind, tmp_path, monkeypatch):
    codec, args, kw = call(kind, "cpu")
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    plain = codec.decode(*args, **kw)
    assert calls == []
    traced, _ = profiled(lambda: codec.decode(*args, **kw), tmp_path)
    assert calls[:2] == ["poporon.facade.decode", "poporon.codec.decode"]
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("kind", ["rs", "ldpc_soft"])
def test_launch_spans_hold_their_kernels_launch(kind, tmp_path):
    """Each launch span holds, on the caller's thread, the runtime call
    whose `correlation` names its kernel.  The kernel's own timestamp is
    not compared with the span's: the profiler's device clock can run
    early or late against the host's (fecbench/spans.py maps it)."""
    codec, args, kw = call(kind, "cuda", rows=4096)
    codec.decode(*args, **kw)           # builds and loads the kernels
    torch.cuda.synchronize()
    _, events = profiled(lambda: codec.decode(*args, **kw), tmp_path, cuda=True)
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    names = [n for n in KERNELS if spans(events, n)]
    assert names == ([*KERNELS][:2] if kind == "rs" else ["poporon.launch.ldpc_bp"])
    for name in names:
        (s,) = spans(events, name)
        mine = [kernels[r["args"]["correlation"]]["name"] for r in launches if inside(r, s)]
        assert sum(KERNELS[name] in k for k in mine) == 1, (name, mine)
