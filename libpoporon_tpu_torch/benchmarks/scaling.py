"""Scaling benchmark (counterpart of benchmarks/scaling.py): the five
BASELINE.json configs, weak scaling from 1 device to the whole mesh.

Codewords are independent, so the data path moves nothing between
devices and codewords/s should grow linearly with devices.  Method, the
JAX script's (weak scaling, identical work):

* Every device decodes the SAME per-device batch, byte for byte: the
  1-device input tiled across the mesh.  BP time is gated by the worst
  codeword of a launch, so independently drawn shards would make the
  N-device run a harder workload than the 1-device one.
* efficiency = (N * B / t_N) / (N * B / t_1) = t_1 / t_N.
* Each shard runs through the port's public codec methods on its
  device's codec (the facade's `decode` for RS, `BCHCodec.decode_bits`,
  `LDPCCodec.decode_hard` and `decode_soft`), every shard issued before
  any is waited on.  Every shard's outputs must equal the 1-device
  run's, or the script raises.

On cards a call is timed by CUDA events on every card of the mesh (the
longest span); each row carries the card's name and power limit.  One
card gives the trivial n = 1 row: multi-card scaling needs several.  A
CPU mesh (`--devices cpu:N`) runs the plain PyTorch versions with its N
shards sharing this host's cores, timed on the host clock; as in the JAX
script it shows that the sharded program runs with constant per-device
work (`efficiency_vs_core_cap`), not that hardware scales.

    python -m libpoporon_tpu_torch.benchmarks.scaling [--devices cpu:N]
        [--batch B] [--out PATH]

Without a card, and without `--devices cpu:N`, it raises.  It prints the
results as JSON and writes them to PATH only when given --out.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

import libpoporon_tpu_torch as pt
from libpoporon_tpu_torch.config import LdpcConfig, LdpcRate
from libpoporon_tpu_torch.models.bch import BCHCodec
from libpoporon_tpu_torch.models.ldpc import LDPCCodec
from libpoporon_tpu_torch.parallel.mesh import batch_mesh, shard_batch
from libpoporon_tpu_torch.utils import bits as bitutils
from libpoporon_tpu_torch.utils.faults import awgn_llrs
from libpoporon_tpu_torch.utils.profiling import card_info, time_ms

CARD_BATCH = 16384      # per device on cards: the JAX script's size on a TPU
CPU_BATCH = 2048        # per device on a CPU mesh: its size off the TPU
LDPC_MI = 50


def _configs(rng, B, dev):
    """(name, make(device) -> model, local(model, *shard), 1-device arrays)
    for the five configs, their inputs drawn as the JAX script draws them
    (the encodes run on `dev`)."""
    rs_cfg = pt.rs_config_default()
    rs = pt.create(rs_cfg, device=dev)

    def rs_parity(data):
        return rs.encode(data).parity.cpu().numpy()

    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = rs_parity(data)
    bad = data.copy()
    bad[:, 5] ^= 0x1F
    bad[:, 99] ^= 0xE3
    rs_2err = [bad, parity]

    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = rs_parity(data)
    epos = np.sort(rng.choice(223, 32, replace=False)).astype(np.int32)
    bad = data.copy()
    bad[:, epos] ^= 0xFF
    rs_erasure = [bad, parity, np.broadcast_to(epos[None], (B, 32)).copy(),
                  np.full(B, 32, dtype=np.int32)]

    words = rng.integers(0, 1 << 15, (B,), dtype=np.int32)
    bch = [((words[:, None] >> np.arange(15)) & 1).astype(np.int32)]

    ldpc_cfg = LdpcConfig(block_size=128, rate=LdpcRate.RATE_1_2)
    lc = LDPCCodec(ldpc_cfg, dev)

    def codewords():
        info = rng.integers(0, 256, (B, lc.info_bytes), dtype=np.uint8)
        return np.concatenate([info, lc.encode(info).cpu().numpy()], axis=1)

    cw = codewords()
    fl = np.argsort(rng.random((B, lc.codeword_bits)), axis=1)[:, :4]
    rows4 = np.repeat(np.arange(B), 4)
    np.bitwise_xor.at(cw, (rows4, fl.reshape(-1) // 8),
                      (1 << (7 - (fl.reshape(-1) % 8))).astype(np.uint8))
    ldpc_hard = [cw]
    cb = bitutils.unpack_np(codewords(), lc.codeword_bits)
    ldpc_soft = [awgn_llrs(cb, snr_db=4.3, rng=2)]

    def make_rs(d):
        return pt.create(rs_cfg, device=d)

    def make_ldpc(d):
        return LDPCCodec(ldpc_cfg, d)

    return [
        ("rs_decode_2err", make_rs, lambda c, d, p: c.decode(d, p), rs_2err),
        ("rs_erasure_32", make_rs,
         lambda c, d, p, e, n: c.decode(d, p, erasures=(e, n)), rs_erasure),
        ("bch15", lambda d: BCHCodec(pt.bch_config_default(), d),
         lambda c, w: c.decode_bits(w), bch),
        ("ldpc_hard_128B", make_ldpc, lambda c, x: c.decode_hard(x, LDPC_MI), ldpc_hard),
        ("ldpc_soft_128B", make_ldpc, lambda c, x: c.decode_soft(x, LDPC_MI), ldpc_soft),
    ]


def _shard_run(mesh, make, local, arrays):
    """A callable that runs local(model, *shard) on every shard of
    `arrays` over `mesh`, one model per distinct device."""
    models = {d: make(d) for d in dict.fromkeys(mesh.devices)}
    shards = list(zip(*(shard_batch(a, mesh) for a in arrays)))
    return lambda: [local(models[d], *s) for d, s in zip(mesh.devices, shards)]


def _measure_ms(fn, mesh, on_card):
    """ms a call: CUDA events on the mesh's cards, or on a CPU mesh the
    host clock (1 warm-up and 3 calls, the JAX script's counts)."""
    if on_card:
        return time_ms(fn, devices=list(dict.fromkeys(mesh.devices)))
    fn()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    return (time.perf_counter() - t0) / 3 * 1e3


def _devices(spec):
    """--devices: None for every visible card, "cpu:N" for N CPU shards."""
    if spec is None:
        return None
    m = re.fullmatch(r"cpu:(\d+)", spec)
    if not m or int(m.group(1)) < 1:
        raise ValueError(f"--devices takes cpu:N (N >= 1), got {spec!r}")
    return ["cpu"] * int(m.group(1))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default=None,
                    help="cpu:N for a CPU mesh of N (default: every visible card)")
    ap.add_argument("--batch", type=int, default=None,
                    help=f"codewords a device (default {CARD_BATCH} on cards, "
                         f"{CPU_BATCH} on the CPU)")
    ap.add_argument("--out", default=None, help="write the JSON results here")
    args = ap.parse_args(argv)

    mesh = batch_mesh(_devices(args.devices))
    n = len(mesh.devices)
    on_card = mesh.devices[0].type == "cuda"
    B = args.batch or (CARD_BATCH if on_card else CPU_BATCH)
    card = card_info() if on_card else None
    cores = os.cpu_count() or 1
    core_cap = 1.0 if on_card else min(1.0, cores / n)
    results = {
        "devices": n, "platform": "gpu" if on_card else "cpu", "card": card,
        "per_device_batch": B, "host_cores": cores,
        "clock": "CUDA events" if on_card else "host",
        "methodology": (
            "weak scaling, every device decodes the IDENTICAL per-device batch "
            "(1-device input tiled across the mesh); efficiency = t_1 / t_N.  On a "
            "CPU mesh the N shards share this host's cores, capping efficiency at "
            "host_cores/N; efficiency_vs_core_cap divides that cap out and validates "
            "constant per-device work, NOT hardware scaling.  One card gives the "
            "trivial n = 1 row."),
    }
    one_mesh = batch_mesh(mesh.devices[:1])
    for name, make, local, a1 in _configs(np.random.default_rng(0), B, mesh.devices[0]):
        fn_1 = _shard_run(one_mesh, make, local, a1)
        t_1 = _measure_ms(fn_1, one_mesh, on_card)
        one = B / t_1 * 1e3
        if n > 1:
            aN = [np.tile(a, (n,) + (1,) * (a.ndim - 1)) for a in a1]
            fn_n = _shard_run(mesh, make, local, aN)
            t_n = _measure_ms(fn_n, mesh, on_card)
            # identical shards decode to the 1-device outputs on every device
            want = [t.cpu() for t in fn_1()[0]]
            for shard in fn_n():
                if not all(torch.equal(g.cpu(), w) for g, w in zip(shard, want)):
                    raise RuntimeError(f"{name}: a shard's outputs != the 1-device run's")
        else:
            t_n = t_1
        full = n * B / t_n * 1e3
        eff = full / (one * n)
        results[name] = {
            "one_device_ms": t_1, f"{n}_device_ms": t_n,
            "one_device_cws": one, f"{n}_device_cws": full,
            "scaling_efficiency": eff, "efficiency_vs_core_cap": eff / core_cap,
            "card": card,
        }
        print(f"# {name}: 1dev={one:,.0f} cw/s  {n}dev={full:,.0f} cw/s  "
              f"eff={eff:.1%}  vs-core-cap={eff / core_cap:.1%}",
              file=sys.stderr, flush=True)

    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
