"""The decode-attention kernel K8 (CUDA C++ for Hopper) and its plain
PyTorch version."""
from .ops import KERNEL_WRAPPERS, decode_attention

__all__ = ["KERNEL_WRAPPERS", "decode_attention"]
