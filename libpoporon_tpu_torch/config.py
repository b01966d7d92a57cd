"""Configuration value objects.

PyTorch counterpart of libpoporon_tpu/config.py: the same frozen
dataclasses and presets, with the reference's defaults:

- RS default:   (8, 0x11D, fcr=1, prim=1, 32 roots) -> RS(255,223)
  (poporon.c:281-284)
- LDPC default: RANDOM matrix, column_weight=3, use_soft_decode=True,
  both interleavers on (poporon.c:286-289)
- LDPC burst-resistant: column_weight=7 (poporon.c:291-294)
- BCH default:  (4, 0x13, t=3) -> BCH(15,5) (poporon.c:296-299)

Only RS has a codec in this package so far; the LDPC and BCH configs are
carried over as data so that code written against the JAX package keeps
its imports.
"""

from __future__ import annotations

import dataclasses
import enum


class FecType(enum.IntEnum):
    RS = 1
    LDPC = 2
    BCH = 3
    UNKNOWN = 255


class LdpcRate(enum.IntEnum):
    """Code rates (reference poporon.h:27-32, ldpc.c:38-69)."""

    RATE_1_3 = 0
    RATE_1_2 = 1
    RATE_2_3 = 2
    RATE_3_4 = 3
    RATE_4_5 = 4
    RATE_5_6 = 5

    @property
    def ratio(self) -> tuple[int, int]:
        """(info_num, parity_num) per ldpc.c:38-69."""
        return {
            LdpcRate.RATE_1_3: (1, 2),
            LdpcRate.RATE_1_2: (1, 1),
            LdpcRate.RATE_2_3: (2, 1),
            LdpcRate.RATE_3_4: (3, 1),
            LdpcRate.RATE_4_5: (4, 1),
            LdpcRate.RATE_5_6: (5, 1),
        }[self]


class LdpcMatrixType(enum.IntEnum):
    RANDOM = 1
    QC_RANDOM = 2


@dataclasses.dataclass(frozen=True)
class RSConfig:
    symbol_size: int = 8
    generator_polynomial: int = 0x11D
    first_consecutive_root: int = 1
    primitive_element: int = 1
    num_roots: int = 32
    # Hand-written CUDA decode kernel (models/rs_cuda.py, csrc/rs_decode.cu).
    # "auto": every decode path (plain, erasure, external syndrome) of a
    # config the kernel supports (m = 8, num_roots <= 64,
    # (fcr + num_roots) * prim < 2^15; erasure lists 1..num_roots wide)
    # goes through the kernel wrapper, which launches the kernel for CUDA
    # tensors and runs the plain PyTorch version for CPU tensors.  Other
    # configs and erasure widths always run the plain version.
    # "off": the plain version everywhere.
    use_kernel: str = "auto"

    fec_type = FecType.RS


@dataclasses.dataclass(frozen=True)
class LdpcConfig:
    block_size: int
    rate: LdpcRate
    matrix_type: LdpcMatrixType = LdpcMatrixType.RANDOM
    column_weight: int = 3
    use_soft_decode: bool = False
    use_outer_interleave: bool = False
    use_inner_interleave: bool = False
    interleave_depth: int = 0
    lifting_factor: int = 0
    max_iterations: int = 0  # 0 -> default 50 (ldpc.c:23, 981-983)
    seed: int = 0

    # --- TPU execution policy (no reference analogue; results are
    # bit-identical for every setting — these trade wall-clock only) ---
    # Iterations the cheap first stage of the adaptive cascade runs
    # before straggler compaction.  0 -> default 3 (most error patterns
    # at realistic channel qualities converge in 1-3 BP iterations;
    # models/ldpc.py STAGE1_ITERS).
    adaptive_stage1_iters: int = 0
    # Straggler slots per full-budget pass.  0 -> default 256
    # (models/ldpc.py STRAGGLER_SLOTS).
    adaptive_straggler_slots: int = 0
    # Codewords per BP chunk (gather fast-regime width).  0 -> default
    # 1024 for every block size — measured optimal from 128B through
    # 8192B on v5e (the BP gathers are row-DMA bound, so wider rows win
    # on big codes too; see the sweep in models/ldpc.py __init__).
    decode_chunk: int = 0
    # Batch size at which the facade switches to the adaptive cascade.
    # 0 -> default 512.
    adaptive_batch_threshold: int = 0
    # Fused Pallas BP kernel: "auto" engages it on TPU backends for
    # decode bodies whose iteration budget is past the measured
    # crossover (models/ldpc.py PALLAS_MIN_ITERS) and whose structure
    # fits VMEM (ldpc_pallas.BPPallasKernel.supports); "on" forces it
    # wherever supported (any backend — non-TPU runs interpret mode,
    # for tests); "off" disables it.
    use_pallas: str = "auto"

    fec_type = FecType.LDPC


@dataclasses.dataclass(frozen=True)
class BchConfig:
    symbol_size: int = 4
    generator_polynomial: int = 0x13
    correction_capability: int = 3

    fec_type = FecType.BCH


def rs_config_default() -> RSConfig:
    return RSConfig(8, 0x11D, 1, 1, 32)


def ldpc_config_default(block_size: int, rate: LdpcRate) -> LdpcConfig:
    return LdpcConfig(
        block_size=block_size,
        rate=rate,
        matrix_type=LdpcMatrixType.RANDOM,
        column_weight=3,
        use_soft_decode=True,
        use_outer_interleave=True,
        use_inner_interleave=True,
    )


def ldpc_config_burst_resistant(block_size: int, rate: LdpcRate) -> LdpcConfig:
    return LdpcConfig(
        block_size=block_size,
        rate=rate,
        matrix_type=LdpcMatrixType.RANDOM,
        column_weight=7,
        use_soft_decode=True,
        use_outer_interleave=True,
        use_inner_interleave=True,
    )


def bch_config_default() -> BchConfig:
    return BchConfig(4, 0x13, 3)
