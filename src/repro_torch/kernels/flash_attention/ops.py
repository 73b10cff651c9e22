"""Host wrapper of the flash-attention kernel K7, under the reference's
public name ``flash_attention``.

The device decides, not a knob (the reference's ``bq``, ``bk`` and
``interpret`` are gone): on CUDA tensors the wrapper launches the Hopper
kernel or raises; on CPU tensors it runs the plain version in ``ref.py``.
No path falls back from a failed build or launch to the plain version.

q [B,Sq,H,D], k and v [B,Skv,K,D] in float32 or bfloat16, H % K == 0,
D <= 128, any Sq and Skv.  The kernel reads the three in place through
their strides (only the head dimension must be contiguous) and writes a
new contiguous [B,Sq,H,D] tensor.  ``flash_attention.launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import ref
from .build import FLASH_ATTENTION

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cuda_operands(kernel: str, named: Sequence) -> int:
    """The kernel's dtype code for ``(name, tensor)`` pairs that must be
    float32 or bfloat16 CUDA tensors of one type on one device, each with a
    contiguous last dimension; raises on anything else."""
    first = named[0][1]
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}; the "
                             f"kernel takes CUDA tensors (CPU tensors run "
                             f"the plain version)")
        if t.device != first.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}; all "
                             f"operands must be on {first.device}")
        if t.dtype != first.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{kernel}: {name} is {t.dtype}; the kernel "
                             f"takes float32 or bfloat16, one type for all")
        if t.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name}'s last dimension must be "
                             f"contiguous, got strides {t.stride()}")
    return DTYPE_CODES[first.dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """K7: softmax((q · scale) kᵀ, causal mask offset Skv - Sq) v, per query
    head h over kv head h // (H/K).  Returns [B,Sq,H,D] in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B,S,heads,D]")
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if H % K:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, softmax_scale=scale)
    dtype = cuda_operands("flash_attention", (("q", q), ("k", k), ("v", v)))
    if D > 128 or B * H > 65535:
        raise ValueError(f"flash_attention: the kernel takes D <= 128 and "
                         f"B*H <= 65535, got D={D}, B*H={B * H}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH_ATTENTION.launch(
        "flash_attention", ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(k.data_ptr()), ctypes.c_void_p(v.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), B, H, K, Sq, Skv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale,
        int(causal), dtype, q.device.index or 0, ctypes.c_void_p(stream))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
KERNEL_WRAPPERS = {"flash_attention": flash_attention}

__all__ = ["KERNEL_WRAPPERS", "cuda_operands", "flash_attention"]
