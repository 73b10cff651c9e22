"""Host wrapper of the decode-attention kernel K8, under the reference's
public name ``decode_attention``.

The device decides, not a knob (the reference's ``bs`` and ``interpret``
are gone): on CUDA tensors the wrapper launches the Hopper kernel or
raises; on CPU tensors it runs the plain version in ``ref.py``.  No path
falls back from a failed build or launch to the plain version.

q [B,H,D], caches [B,S,K,D] in float32 or bfloat16, H/K in 1..8, D <= 128;
lengths [B] integers >= 1 (each row's valid cache prefix).  The kernel
reads the caches in place through their strides (only the head dimension
must be contiguous) and writes a new contiguous [B,H,D] tensor.
``decode_attention.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import cuda_operands

from . import ref
from .build import DECODE_ATTENTION


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """K8: one query row per head against the first ``lengths[b]`` cache
    rows of batch row b.  Returns [B,H,D] in q's dtype."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("decode_attention: q must be [B,H,D] and the caches "
                         "[B,S,K,D]")
    B, H, D = q.shape
    _, S, K, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"do not fit")
    if H % K:
        raise ValueError(f"decode_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: lengths must be [B={B}], got "
                         f"{tuple(lengths.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        softmax_scale=scale)
    dtype = cuda_operands("decode_attention", (
        ("q", q), ("k_cache", k_cache), ("v_cache", v_cache)))
    if D > 128 or H // K > 8 or B > 65535:
        raise ValueError(f"decode_attention: the kernel takes D <= 128, "
                         f"H/K <= 8 and B <= 65535, got D={D}, H/K={H // K}, "
                         f"B={B}")
    if lengths.device != q.device or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention: lengths must be int32 on "
                         f"{q.device}, got {lengths.dtype} on {lengths.device}")
    lengths = lengths.contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    DECODE_ATTENTION.launch(
        "decode_attention", ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(k_cache.data_ptr()),
        ctypes.c_void_p(v_cache.data_ptr()),
        ctypes.c_void_p(lengths.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, H, K, S, D, *q.stride()[:2], *k_cache.stride()[:3],
        *v_cache.stride()[:3], scale, dtype, q.device.index or 0,
        ctypes.c_void_p(stream))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
KERNEL_WRAPPERS = {"decode_attention": decode_attention}

__all__ = ["KERNEL_WRAPPERS", "decode_attention"]
