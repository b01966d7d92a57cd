"""libpoporon_tpu_torch — the PyTorch and CUDA port of libpoporon_tpu.

The JAX package stays the reference; this package mirrors its module
names.  It imports torch and never jax.  So far it carries two slices:

- RS: configs and presets, GF(2^m) tables, RS encode, and the three RS
  decode paths (plain, erasure, external syndrome), whose decode runs
  through a hand-written CUDA kernel (csrc/rs_decode.cu) on CUDA tensors;
- LDPC: the seeded parity-check structure and interleavers, encode, and
  min-sum BP decode, hard and soft, whose BP runs through a hand-written
  CUDA kernel (csrc/ldpc_bp.cu) on CUDA tensors.

    import libpoporon_tpu_torch as pt

    codec  = pt.create(pt.rs_config_default(), device="cuda")
    parity = codec.encode(data).parity       # data: uint8 [B, k] (or [k])
    res    = codec.decode(data, parity)      # -> DecodeResult of tensors

    ldpc = pt.create(pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), device="cuda")
    enc  = ldpc.encode(info)                 # interleaved data and parity
    res  = ldpc.decode(enc.data, enc.parity, soft_llr=llr)   # llr: int8 [B, 2048]

The device is explicit: `create` defaults to "cpu", and inputs are moved
to the codec's device.  BCH configs raise NotImplementedError.
"""

from .config import (
    FecType,
    LdpcMatrixType,
    LdpcRate,
    RSConfig,
    LdpcConfig,
    BchConfig,
    rs_config_default,
    ldpc_config_default,
    ldpc_config_burst_resistant,
    bch_config_default,
)
from .facade import Codec, DecodeResult, create
from .erasure import Erasure
from .version import version_id, buildtime

__all__ = [
    "FecType",
    "LdpcMatrixType",
    "LdpcRate",
    "RSConfig",
    "LdpcConfig",
    "BchConfig",
    "rs_config_default",
    "ldpc_config_default",
    "ldpc_config_burst_resistant",
    "bch_config_default",
    "Codec",
    "DecodeResult",
    "create",
    "Erasure",
    "version_id",
    "buildtime",
]
