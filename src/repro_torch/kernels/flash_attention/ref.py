"""Plain PyTorch version of the flash-attention kernel K7: naive
materialised softmax attention with causal / GQA semantics — the
reference's ``flash_attention/ref.py:attention_ref``.  O(S²) memory.

The kernel wrapper in ``ops.py`` calls this for tensors on the CPU, and
``chip_smoke.py`` holds K7 against it on the card (float32 products in
full float32 there: TF32 is switched off around them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.conv_pointwise.ref import full_f32_matmul


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,D]; k,v [B,Skv,K,D], H % K == 0.  Returns [B,Sq,H,D].

    The causal mask keeps key j for query i when ``j <= i + Skv - Sq``
    (the queries are the last Sq positions); masked scores are ``-inf``.
    """
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    groups = H // K
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, K, groups, D)
    with full_f32_matmul():
        s = torch.einsum("bikgd,bjkd->bkgij", qf * scale, k.float())
        if causal:
            mask = torch.ones((Sq, Skv), dtype=torch.bool,
                              device=q.device).tril(Skv - Sq)
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgij,bjkd->bikgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


__all__ = ["attention_ref"]
