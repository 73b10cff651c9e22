"""The client edge's float32 -> int8 input quantize as one pass of a C++
host kernel, bit-identical to numpy's expression."""
from .ops import quantize_int8

__all__ = ["quantize_int8"]
