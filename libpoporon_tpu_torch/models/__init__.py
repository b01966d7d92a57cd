from .bch import BCHCodec
from .ldpc import LDPCCodec
from .ldpc_cuda import BPCudaKernel
from .rs import RSCodec
from .rs_cuda import RSCudaDecoder

__all__ = ["BCHCodec", "BPCudaKernel", "LDPCCodec", "RSCodec", "RSCudaDecoder"]
