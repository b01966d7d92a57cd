from .rs import RSCodec
from .rs_cuda import RSCudaDecoder

__all__ = ["RSCodec", "RSCudaDecoder"]
