from .ldpc import LDPCCodec
from .ldpc_cuda import BPCudaKernel
from .rs import RSCodec
from .rs_cuda import RSCudaDecoder

__all__ = ["BPCudaKernel", "LDPCCodec", "RSCodec", "RSCudaDecoder"]
