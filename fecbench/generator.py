"""The one traffic generator: it reads a traffic mix's parameters
(`fecbench/traffic/<mix>.json`), makes the cell's inputs from the seed,
builds the system under test, and drives it as one closed-loop caller.

Everything that belongs to one kind of thing is a file of its own, found
by the name that the configuration or the mix gives:

- `fecbench/entries/<entry>.py`, named by the mix's `entry`: the public
  path the requests take, as a class `Mix` (most entries subclass
  `BatchDecode` below and say only how the system is built);
- `fecbench/channels/<kind>.py`, named by the mix's `channel.kind`: how a
  batch of clean codewords is hurt, as `hurt(g, data, parity, params,
  ref)` returning the decode's named inputs;
- `fecbench/reference/<family>.py`, named by the configuration's
  `family` (or the mix's `reference`, where a mix needs a reference
  path of its own): the plain reference, as `Reference(config, device)`
  and `control(config, device)`;
- the port's configuration object is the class of the program that the
  configuration's `port_config` names, filled from the keys of the
  configuration file that are its fields.

A name with no file is an error, never a fall-through to another family.
Clean codewords come from the plain reference's encoder, never from the
program.  Every seed gets the same sizes and the same amount of hurt in
distribution; only the values and the order differ.
"""

from __future__ import annotations

import enum
import importlib.util
import random
import re
import sys
import typing
from pathlib import Path

import torch

FECBENCH = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
BLOCK_ROWS = 65536     # rows a block when making inputs
REF_ROWS = 16384       # rows a block of a reference decode


def load(folder: str, name: str):
    """The module fecbench/<folder>/<name>.py; ValueError where there is
    none."""
    path = FECBENCH / folder / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"no fecbench/{folder}/{name}.py for the name {name!r}")
    key = f"fecbench.{folder}.{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def reference_module(config: dict, traffic: dict | None = None):
    return load("reference", (traffic or {}).get("reference") or config["family"])


def reference(config: dict, device, traffic: dict | None = None):
    """The plain reference of a configuration (and mix) on `device`."""
    return reference_module(config, traffic).Reference(config, device)


def port_config(config: dict):
    """The port's configuration object: the class `port_config` of the
    program, each of its fields that the file holds taken from there (an
    enum field by its member's name)."""
    import libpoporon_tpu_torch as pt
    cls = getattr(pt, config["port_config"])
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, kind in hints.items():
        if name not in config or name not in cls.__dataclass_fields__:
            continue
        value = config[name]
        if isinstance(kind, type) and issubclass(kind, enum.Enum) and isinstance(value, str):
            value = kind[value]
        kwargs[name] = value
    return cls(**kwargs)


def blocks(fn, *tensors, rows: int = BLOCK_ROWS, **named):
    """fn over row blocks of the tensors (positional and named), each
    output joined back."""
    n = (tensors[0] if tensors else next(iter(named.values()))).shape[0]
    parts = [fn(*(t[i: i + rows] for t in tensors), **{k: v[i: i + rows] for k, v in named.items()})
             for i in range(0, n, rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


class Sampler:
    """A reservoir of `per_kind` answers of each kind of request, drawn
    from the seed, so that the check reads a fair sample of the window."""

    def __init__(self, seed: int, per_kind: int):
        self.rng = random.Random(seed)
        self.per_kind = per_kind
        self.seen, self.kept = {}, {}

    def offer(self, kind, item, answer):
        n = self.seen[kind] = self.seen.get(kind, 0) + 1
        kept = self.kept.setdefault(kind, [])
        if len(kept) < self.per_kind:
            kept.append((item, answer))
        else:
            j = self.rng.randrange(n)
            if j < self.per_kind:
                kept[j] = (item, answer)

    def samples(self):
        return [s for kept in self.kept.values() for s in kept]


class BatchDecode:
    """Requests that are each one decode of a whole batch on the first
    device: a pool of batches, decoded in a seeded order.  The mix gives
    `batch`, `pool`, `samples` and the `channel`; the caller reads `ok`
    and `corrected` on the host and leaves the data on the device.
    Subclasses say how the system is built from the port's codec."""

    kinds = ("decode",)

    def __init__(self, config, traffic, seed, devices):
        self.config, self.traffic, self.devices = config, traffic, devices
        self.dev = torch.device(devices[0])
        self.seed = seed
        self.channel = load("channels", traffic["channel"]["kind"])
        order = list(range(traffic["pool"]))
        random.Random(seed).shuffle(order)
        self.order = [("decode", i) for i in order]

    def make_inputs(self):
        """The pool: per batch the decode's named inputs."""
        tr, dev = self.traffic, self.dev
        ref = reference(self.config, dev, tr)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        B = tr["batch"]
        self.pool = []
        for _ in range(tr["pool"]):
            info = torch.randint(0, 256, (B, ref.info_bytes), generator=g, device=dev,
                                 dtype=torch.uint8)
            data, parity = blocks(ref.encode, info)
            self.pool.append(self.channel.hurt(g, data, parity, tr["channel"], ref))
        self.payload_bytes = B * ref.info_bytes
        return self

    def build(self, codec):
        """The system under test from the port's facade codec."""
        raise NotImplementedError

    def payload(self, item) -> int:
        return self.payload_bytes

    def call(self, system, item):
        res = system.decode(**self.pool[item[1]])
        return res.ok.cpu(), res.corrected.cpu(), res.data, res.parity

    def keep(self, answer):
        """An answer as the check holds it, off the program's devices."""
        return tuple(t.cpu() for t in answer)

    def run_reference(self, ref):
        """The reference's (ok, data, parity, corrected) of every batch."""
        self.expected = [tuple(t.cpu() for t in blocks(ref.decode, rows=REF_ROWS, **x))
                         for x in self.pool]
        return self.expected

    def check(self, samples) -> dict:
        """Rows of the sampled answers that differ from the reference in
        any field, and the sampled requests that hold such a row."""
        rows = requests = 0
        for (_, i), (ok, corrected, data, parity) in samples:
            w_ok, w_data, w_parity, w_corr = self.expected[i]
            bad = ((ok != w_ok) | (corrected != w_corr) | (data != w_data).any(dim=1)
                   | (parity != w_parity).any(dim=1))
            rows += int(bad.sum())
            requests += int(bool(bad.any()))
        return {"requests_differ": requests, "rows_differ": rows}

    def launches(self, n_devices: int) -> list[dict]:
        """The reference's per-row results of each decode launch the cell
        cycles through: one a batch, or one a shard of it."""
        out = []
        for ok, _, _, corrected in self.expected:
            for idx in torch.arange(len(ok)).tensor_split(n_devices):
                out.append({"ok": ok[idx], "corrected": corrected[idx]})
        return out


def make_mix(config, traffic, seed, devices):
    """The mix's entry, set up for one run."""
    return load("entries", traffic["entry"]).Mix(config, traffic, seed, devices)
