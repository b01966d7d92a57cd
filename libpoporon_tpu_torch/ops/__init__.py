from .gf import GF, GFError
from .gf2 import gf2_matmul
from .gfint import gf_mul

__all__ = ["GF", "GFError", "gf2_matmul", "gf_mul"]
