"""The flash-attention kernel K7 (CUDA C++ for Hopper) and its plain
PyTorch version."""
from .ops import KERNEL_WRAPPERS, flash_attention

__all__ = ["KERNEL_WRAPPERS", "flash_attention"]
