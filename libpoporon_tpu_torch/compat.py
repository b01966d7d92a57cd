"""C-API compatibility layer (counterpart of libpoporon_tpu/compat.py).

Shims mirroring the reference's public C API (poporon.h) for migrating
users: the same function names and constants, the same in/out buffer
semantics (NumPy arrays are mutated in place exactly where the C mutates
caller buffers) and the same return conventions.  Each call runs on the
batched codecs of this package, on the handle's device (the card unless
`poporon_create` is given another); results come back to the caller's
buffers through the host.

    from libpoporon_tpu_torch import compat as pp

    cfg  = pp.poporon_config_rs_default()
    h    = pp.poporon_create(cfg)            # device="cpu" to stay on the host
    data = np.frombuffer(b"...", dtype=np.uint8).copy()
    parity = np.zeros(32, np.uint8)
    pp.poporon_encode(h, data, len(data), parity)
    ok, n = pp.poporon_decode(h, data, len(data), parity)

One codeword per call, as in C: `data` and `parity` are one codeword's
buffers (1-D), and `poporon_decode` then returns the C result, (ok,
corrected count) of that codeword.  Given 2-D buffers, data [B, k] and
parity [B, nr] with size = B, it decodes the B rows and returns the JAX
shim's reduction over them, (all rows ok, largest corrected count), which
C has no counterpart for (ROADMAP.md Queue 3, F4); with size < B the
batches of data[:size] and parity differ, and it returns (False, 0).

The C API rejects bad input with NULL or false, and so do these shims,
where the input is what they reject: a ValueError (GFError among them) or
a TypeError from the codec.  Every other error propagates: a missing card,
a kernel that fails to build or launch, a CUDA error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import BchConfig, FecType, LdpcConfig, LdpcMatrixType, LdpcRate, RSConfig
from .erasure import Erasure
from .facade import Codec
from .utils.rng import Xoshiro128pp
from .version import buildtime, version_id

# enum-style constants (poporon.h:22-35)
POPORON_FEC_RS = 1
POPORON_FEC_LDPC = 2
POPORON_FEC_BCH = 3
POPORON_FEC_UNKNOWN = 255
POPORON_LDPC_RATE_1_3 = 0
POPORON_LDPC_RATE_1_2 = 1
POPORON_LDPC_RATE_2_3 = 2
POPORON_LDPC_RATE_3_4 = 3
POPORON_LDPC_RATE_4_5 = 4
POPORON_LDPC_RATE_5_6 = 5
POPORON_LDPC_MATRIX_RANDOM = 1
POPORON_LDPC_MATRIX_QC_RANDOM = 2

XOSHIRO128PP = 0

# What a codec raises on input the C API rejects (GFError is a ValueError).
_REJECTED = (ValueError, TypeError)


@dataclasses.dataclass
class _CompatConfig:
    inner: object
    erasure: Erasure | None = None
    syndrome: np.ndarray | None = None
    soft_llr: np.ndarray | None = None


def _host(x) -> np.ndarray:
    """A codec output (tensor on any device, or a number) as NumPy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------------- configs

def poporon_rs_config_create(symbol_size, generator_polynomial,
                             first_consecutive_root, primitive_element,
                             num_roots, erasure=None, syndrome=None):
    return _CompatConfig(
        RSConfig(symbol_size, generator_polynomial, first_consecutive_root,
                 primitive_element, num_roots),
        erasure=erasure,
        syndrome=None if syndrome is None else np.asarray(syndrome, np.uint16),
    )


def poporon_ldpc_config_create(block_size, rate, matrix_type, column_weight,
                               use_soft_decode, use_outer_interleave,
                               use_inner_interleave, interleave_depth,
                               lifting_factor, max_iterations, soft_llr,
                               soft_llr_size, seed):
    llr = None
    if soft_llr is not None:
        llr = np.asarray(soft_llr, np.int8)[: soft_llr_size or None]
    return _CompatConfig(
        LdpcConfig(
            block_size=block_size, rate=LdpcRate(rate),
            matrix_type=LdpcMatrixType(matrix_type),
            column_weight=column_weight, use_soft_decode=use_soft_decode,
            use_outer_interleave=use_outer_interleave,
            use_inner_interleave=use_inner_interleave,
            interleave_depth=interleave_depth, lifting_factor=lifting_factor,
            max_iterations=max_iterations, seed=seed,
        ),
        soft_llr=llr,
    )


def poporon_bch_config_create(symbol_size, generator_polynomial,
                              correction_capability):
    return _CompatConfig(
        BchConfig(symbol_size, generator_polynomial, correction_capability)
    )


def poporon_config_rs_default():
    return poporon_rs_config_create(8, 0x11D, 1, 1, 32)


def poporon_config_ldpc_default(block_size, rate):
    return poporon_ldpc_config_create(
        block_size, rate, POPORON_LDPC_MATRIX_RANDOM, 3, True, True, True,
        0, 0, 0, None, 0, 0)


def poporon_config_ldpc_burst_resistant(block_size, rate):
    return poporon_ldpc_config_create(
        block_size, rate, POPORON_LDPC_MATRIX_RANDOM, 7, True, True, True,
        0, 0, 0, None, 0, 0)


def poporon_config_bch_default():
    return poporon_bch_config_create(4, 0x13, 3)


def poporon_config_destroy(config):
    pass


# -------------------------------------------------------------- codec

class _Handle:
    def __init__(self, cfg: _CompatConfig, device):
        if not isinstance(cfg, _CompatConfig):
            raise TypeError(f"not a poporon config: {type(cfg)}")
        self.codec = Codec(cfg.inner, device)
        self.erasure = cfg.erasure
        self.syndrome = cfg.syndrome
        self.soft_llr = cfg.soft_llr


def poporon_create(config, device: str | torch.device = "cuda") -> _Handle | None:
    """A codec handle on `device`, or None for no config or one the codec
    rejects.  Raises where the device is missing."""
    if config is None:
        return None
    try:
        return _Handle(config, device)
    except _REJECTED:
        return None


def poporon_destroy(pprn) -> None:
    pass


def poporon_encode(pprn, data: np.ndarray, size: int, parity: np.ndarray) -> bool:
    """Mutates `parity` (and `data` for interleaved LDPC) in place."""
    if pprn is None or data is None or parity is None:
        return False
    try:
        res = pprn.codec.encode(np.asarray(data[:size], np.uint8))
    except _REJECTED:
        return False
    d, p = _host(res.data), _host(res.parity)
    parity[: len(p)] = p
    data[: len(d)] = d
    return True


def poporon_decode(pprn, data: np.ndarray, size: int, parity: np.ndarray):
    """Returns (ok, corrected_num); mutates `data`/`parity` in place.
    One codeword's buffers give its C result; a batch gives (all ok,
    largest count) (module docstring)."""
    if pprn is None or data is None or parity is None or not size:
        return False, 0
    kw = {}
    if pprn.codec.fec_type == FecType.RS:
        if pprn.syndrome is not None:
            kw["ext_syndrome"] = pprn.syndrome.astype(np.int32)
        elif pprn.erasure is not None:
            kw["erasures"] = pprn.erasure.positions.astype(np.int32)
    elif pprn.codec.fec_type == FecType.LDPC and pprn.soft_llr is not None:
        kw["soft_llr"] = pprn.soft_llr
    try:
        res = pprn.codec.decode(np.asarray(data[:size], np.uint8),
                                np.asarray(parity, np.uint8), **kw)
    except _REJECTED:
        return False, 0
    d, p = _host(res.data), _host(res.parity)
    data[: len(d)] = d
    parity[: len(p)] = p
    return bool(_host(res.ok).all()), int(_host(res.corrected).max())


def poporon_get_fec_type(pprn):
    return int(pprn.codec.fec_type) if pprn else POPORON_FEC_UNKNOWN


def poporon_get_iterations_used(pprn):
    if pprn is None or pprn.codec.fec_type != FecType.LDPC:
        return 0
    it = _host(pprn.codec.iterations_used)
    return int(it.max()) if it.size else 0


def poporon_get_parity_size(pprn):
    return pprn.codec.parity_size if pprn else 0


def poporon_get_info_size(pprn):
    return pprn.codec.info_size if pprn else 0


def poporon_version_id():
    return version_id()


def poporon_buildtime():
    return buildtime()


# ---------------------------------------------------------------- rng

def poporon_rng_create(rng_type, seed, seed_size=None):
    if isinstance(seed, (bytes, bytearray)):
        seed = seed[:seed_size] if seed_size else seed
    return Xoshiro128pp(seed)


def poporon_rng_next(rng, size: int) -> bytes | None:
    if rng is None or size == 0:
        return None
    return rng.fill_bytes(size)


def poporon_rng_destroy(rng) -> None:
    pass


# ------------------------------------------------------------ erasure

def poporon_erasure_create(num_roots, initial_capacity=0):
    return Erasure(num_roots, initial_capacity)


def poporon_erasure_create_from_positions(num_roots, positions, count=None):
    if positions is None or (count is not None and count == 0):
        return None
    pos = list(positions)[:count] if count else list(positions)
    if not pos:
        return None
    return Erasure.from_positions(num_roots, pos)


def poporon_erasure_add_position(erasure, position) -> bool:
    if erasure is None:
        return False
    erasure.add_position(position)
    return True


def poporon_erasure_reset(erasure) -> None:
    if erasure is not None:
        erasure.reset()


def poporon_erasure_destroy(erasure) -> None:
    pass
