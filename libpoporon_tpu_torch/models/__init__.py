from .bch import BCHCodec
from .bch_cuda import BCHCudaDecoder
from .ldpc import LDPCCodec
from .ldpc_cuda import BPCudaKernel
from .rs import RSCodec
from .rs_cuda import RSCudaDecoder

__all__ = ["BCHCodec", "BCHCudaDecoder", "BPCudaKernel", "LDPCCodec", "RSCodec", "RSCudaDecoder"]
