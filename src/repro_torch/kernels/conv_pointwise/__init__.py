"""The float32 pointwise conv kernel K6 (CUDA C++ for Hopper) and its plain
PyTorch version."""
from .ops import KERNEL_WRAPPERS, conv1x1, conv1x1_fused

__all__ = ["KERNEL_WRAPPERS", "conv1x1", "conv1x1_fused"]
