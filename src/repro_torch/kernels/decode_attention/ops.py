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

Each (batch row, kv head) is split over a cluster of ``plan_split``
blocks, planned from the shapes alone: ``lengths`` is read only on the
card, so a call never waits for the device.  The wrapper takes the
kernel's 16-byte load path where both caches' pointers and strides and
the row's bytes are multiples of 16, and its scalar path otherwise.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.conv_quant.ops import _current_stream
from repro_torch.kernels.flash_attention.ops import cuda_operands

from . import ref
from .build import DECODE_ATTENTION

# A cluster of at most MAX_SPLIT blocks (portable) per (batch row, kv
# head), enough that the blocks reach BLOCKS_PER_SM per SM, each block's
# share of a full cache at least MIN_SPLIT_ROWS rows (so a short cache,
# as the reference launcher's 96 rows, is not split).  The thresholds come
# from forced-split device times on an H100 (tools/kernel_times.py
# --splits; PERF.md).
MAX_SPLIT = 8
BLOCKS_PER_SM = 2
MIN_SPLIT_ROWS = 128


def plan_split(batch: int, kv_heads: int, seq: int, sms: int) -> int:
    """Blocks per (batch row, kv head) for a cache of ``seq`` rows on a
    card of ``sms`` SMs: 1..MAX_SPLIT, from shapes only."""
    pairs = max(1, batch * kv_heads)
    return max(1, min(MAX_SPLIT, seq // MIN_SPLIT_ROWS,
                      -(-BLOCKS_PER_SM * sms // pairs)))


def vector_loads(elem_size: int, d: int, pointers, strides) -> bool:
    """Whether K8 may read the caches 16 bytes at a time: both pointers,
    every (batch, row, head) stride and a row of ``d`` elements are
    multiples of 16 bytes (``strides`` in elements)."""
    return (d * elem_size % 16 == 0 and all(p % 16 == 0 for p in pointers)
            and all(s * elem_size % 16 == 0 for s in strides))


@functools.lru_cache(maxsize=1024)
def _plan(batch: int, kv_heads: int, seq: int, dev: int) -> int:
    """``plan_split`` for CUDA device ``dev``'s SM count."""
    return plan_split(batch, kv_heads, seq, torch.cuda.get_device_properties(
        dev).multi_processor_count)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """K8: one query row per head against the first ``lengths[b]`` cache
    rows of batch row b.  Returns [B,H,D] in q's dtype."""
    qs, ks = q.shape, k_cache.shape
    if len(qs) != 3 or len(ks) != 4:
        raise ValueError("decode_attention: q must be [B,H,D] and the caches "
                         "[B,S,K,D]")
    B, H, D = qs
    _, S, K, _ = ks
    if ks != v_cache.shape or ks[0] != B or ks[3] != D:
        raise ValueError(f"decode_attention: q {tuple(qs)}, caches "
                         f"{tuple(ks)} / {tuple(v_cache.shape)} "
                         f"do not fit")
    if H % K:
        raise ValueError(f"decode_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: lengths must be [B={B}], got "
                         f"{tuple(lengths.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q.is_cpu:
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
                         f"{q.device}, got {lengths.dtype} on "
                         f"{lengths.device}")
    lengths = lengths.contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dev = q.get_device()
    k_st, v_st = k_cache.stride()[:3], v_cache.stride()[:3]
    kp, vp = k_cache.data_ptr(), v_cache.data_ptr()
    vec = vector_loads(q.element_size(), D, (kp, vp), k_st + v_st)
    DECODE_ATTENTION.launch(
        "decode_attention", q.data_ptr(), kp, vp, lengths.data_ptr(),
        out.data_ptr(), B, H, K, S, D, *q.stride()[:2], *k_st, *v_st, scale,
        dtype, _plan(B, K, S, dev), int(vec), dev, _current_stream(dev))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
KERNEL_WRAPPERS = {"decode_attention": decode_attention}

__all__ = ["KERNEL_WRAPPERS", "decode_attention", "plan_split",
           "vector_loads"]
