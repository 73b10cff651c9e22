"""The int8 conv kernels K1–K5, the residual add K9 and squeeze-and-
excite's channel scale K10 (CUDA C++ for Hopper) and their plain PyTorch
versions."""
from .ops import (KERNEL_WRAPPERS, qadd, qconv, qconv1x1, qconv1x1_add,
                  qconv_add, qconv_add_fused, qconv_fused, qdwconv,
                  qdwconv_fused, qscale)

__all__ = ["KERNEL_WRAPPERS", "qadd", "qconv", "qconv1x1", "qconv1x1_add",
           "qconv_add", "qconv_add_fused", "qconv_fused", "qdwconv",
           "qdwconv_fused", "qscale"]
