"""Plain PyTorch version of the decode-attention kernel K8: one query row
per head against a KV cache, masked to each batch row's valid prefix —
the reference's ``decode_attention/ref.py:decode_attention_ref``, but with
the ``-1e30`` mask of both TPU kernels in place of ``-inf`` (the two agree
whenever a row has at least one valid position).

The kernel wrapper in ``ops.py`` calls this for tensors on the CPU, and
``chip_smoke.py`` holds K8 against it on the card (TF32 off).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.conv_pointwise.ref import full_f32_matmul

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """q [B,H,D]; caches [B,S,K,D]; lengths [B] (valid prefix) -> [B,H,D]"""
    B, H, D = q.shape
    _, S, K, _ = k_cache.shape
    groups = H // K
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, K, groups, D)
    with full_f32_matmul():
        s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
        mask = torch.arange(S, device=q.device)[None] \
            < lengths.to(q.device)[:, None]                     # [B,S]
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


__all__ = ["decode_attention_ref", "NEG_INF"]
