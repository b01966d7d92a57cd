"""libpoporon_tpu_torch — the PyTorch and CUDA port of libpoporon_tpu.

The JAX package stays the reference; this package mirrors its module
names.  It imports torch and never jax.  So far it carries:

- RS: configs and presets, GF(2^m) tables, RS encode, and the three RS
  decode paths (plain, erasure, external syndrome), whose decode runs
  through hand-written CUDA kernels (csrc/rs_decode.cu) on the card,
  and the stripe decode (`Codec.reconstruct`: lost cells of shard-major
  stripes rebuilt, one kernel launch on the card); symbols wider than a
  byte (m > 8, such as the KP4 code RS(544,514) over GF(2^10)) as 16-bit
  words (`Codec.symbol_dtype`), encode and plain decode, the kernels at
  m = 10;
- LDPC: the seeded parity-check structure and interleavers, encode, and
  min-sum BP decode, hard and soft, whose BP runs through a hand-written
  CUDA kernel (csrc/ldpc_bp.cu) on the card;
- BCH: binary BCH for m in [3, 16] (models/bch.py), full length or
  shortened (`BchConfig.data_length`), bit, word and byte APIs, in plain
  PyTorch ops; on the card a shortened code of whole data bytes (NAND
  flash's BCH-8 on 512-byte sectors among them) decodes its stored bytes
  through a hand-written CUDA kernel (csrc/bch_decode.cu; the JAX package
  has no BCH kernel);
- the C-shaped shim (compat.py: the `poporon_*` functions over NumPy
  buffers) and byte-stream framing (stream.py: `StreamCodec`);
- measurement: the DMA probes as CUDA bulk-copy kernels
  (csrc/probe_dma.cu, benchmarks/probe_dma.py), the BER waterfall
  (benchmarks/waterfall.py), fault injection and card-only timing
  (utils/faults.py, utils/profiling.py), and weak scaling over a mesh
  (benchmarks/scaling.py);
- parallel: the codeword batch split over a mesh of devices
  (parallel.ShardedCodec over parallel.batch_mesh, one codec a device),
  and BER and iteration statistics summed across processes through
  torch.distributed (parallel.ber_stats, parallel.iteration_histogram).

    import libpoporon_tpu_torch as pt

    codec  = pt.create(pt.rs_config_default(), device="cuda")
    parity = codec.encode(data).parity       # data: uint8 [B, k] (or [k])
    res    = codec.decode(data, parity)      # -> DecodeResult of tensors

    ldpc = pt.create(pt.ldpc_config_default(128, pt.LdpcRate.RATE_1_2), device="cuda")
    enc  = ldpc.encode(info)                 # interleaved data and parity
    res  = ldpc.decode(enc.data, enc.parity, soft_llr=llr)   # llr: int8 [B, 2048]

    bch = pt.create(pt.bch_config_default(), device="cuda")  # BCH(15,5)
    res = bch.decode(data, bch.encode(data).parity)          # data: uint8 [B, 1]

`create` puts the codec on the card ("cuda") unless given another device;
without a card that default raises, and the CPU runs only where the
caller asks for it (`device="cpu"`, as the tests do).  Inputs are moved
to the codec's device.  A codec picks kernel or plain version once, when
it is built: the kernels for a codec on the card whose config is inside
their gate, the plain PyTorch version for every other codec, and for
every codec on the CPU.
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
from .facade import Codec, DecodeResult, ReconstructResult, create
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
    "ReconstructResult",
    "create",
    "Erasure",
    "version_id",
    "buildtime",
]
