"""Configuration value objects.

PyTorch counterpart of libpoporon_tpu/config.py: the same frozen
dataclasses and presets, with the reference's defaults:

- RS default:   (8, 0x11D, fcr=1, prim=1, 32 roots) -> RS(255,223)
  (poporon.c:281-284)
- LDPC default: RANDOM matrix, column_weight=3, use_soft_decode=True,
  both interleavers on (poporon.c:286-289)
- LDPC burst-resistant: column_weight=7 (poporon.c:291-294)
- BCH default:  (4, 0x13, t=3) -> BCH(15,5) (poporon.c:296-299)

LdpcConfig's `use_pallas` (a TPU knob) is `use_kernel` here, as in
RSConfig; BchConfig has no such knob (BCH has no kernel).
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

    # --- Execution policy (no reference analogue; results are
    # bit-identical for every setting, these trade wall-clock only).
    # The defaults are the JAX package's, tuned on a TPU, not on a GPU. ---
    # Iterations of the adaptive cascade's first stage, before the
    # stragglers are re-decoded at the full budget.  0 -> 3
    # (models/ldpc.py STAGE1_ITERS).  The cascade runs for the plain
    # version only: with the kernel on CUDA tensors an adaptive decode is
    # one full-budget launch.
    adaptive_stage1_iters: int = 0
    # Rows per full-budget straggler pass of the cascade.  0 -> 256, or
    # 1024 when the codec has a kernel (models/ldpc.py STRAGGLER_SLOTS).
    adaptive_straggler_slots: int = 0
    # Codewords per plain-version BP loop (models/ldpc.py DECODE_CHUNK):
    # bounds the plain version's working set and lets each slice stop at
    # its own last converging row.  0 -> 1024.  The kernel takes a whole
    # batch in one launch and ignores it.
    decode_chunk: int = 0
    # Batch size from which the facade decodes through the adaptive
    # decode (decode_*_adaptive).  0 -> 512.
    adaptive_batch_threshold: int = 0
    # Hand-written CUDA BP kernel (models/ldpc_cuda.py, csrc/ldpc_bp.cu).
    # "auto": every decode of a structure the kernel supports (one
    # codeword's state fits one block's shared memory, edges <= 65535: the
    # 128-byte codes, 64 B rate-1/3 and 1024 B rate-1/2 among them) goes through
    # the kernel wrapper, which launches the kernel for CUDA tensors and
    # runs the plain PyTorch version for CPU tensors.  Other structures
    # always run the plain version.  "off": the plain version everywhere.
    use_kernel: str = "auto"

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
