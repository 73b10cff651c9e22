"""The int8 conv kernels K1–K3 (CUDA C++ for Hopper) and their plain
PyTorch versions."""
from .ops import (KERNEL_WRAPPERS, qconv, qconv1x1, qconv_fused, qdwconv,
                  qdwconv_fused)

__all__ = ["KERNEL_WRAPPERS", "qconv", "qconv1x1", "qconv_fused", "qdwconv",
           "qdwconv_fused"]
