"""Shared building blocks of the LLM stack: norms, RoPE, chunked
(online-softmax) attention and single-position decode attention.

The counterpart of ``src/repro/models/layers.py``, in the same layout
(``[B, S, H, D]`` activations, ``[B, S, K, D]`` caches).  ``chunked_attention``
and ``decode_attention`` are the model's attention on the CPU; on the card
the model calls the hand-written kernels K7/K8 (``repro_torch.kernels``)
for the same computation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30     # the mask value of the chunked path and of both kernels


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...]; returns cos/sin of shape [..., head_dim//2]."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, D//2] broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ------------------------------------------------- chunked flash attention
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 512,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      sliding_window: int = 0,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks, carrying (acc, running max,
    denominator) from chunk to chunk: peak memory O(B·H·Sq·chunk).

    q: [B, Sq, H, D]; k, v: [B, Skv, K, D] with H % K == 0 (GQA).  The
    chunk order, the ``-1e30`` mask and ``max(denom, 1e-30)`` are the
    reference's.  One difference: the zero rows that pad Skv up to a whole
    chunk are always masked, also without ``causal`` (the reference masks
    them only through the causal test, so a non-causal call with a ragged
    last chunk gives them weight).
    """
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    if H % K:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {K}")
    groups = H // K
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)

    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    valid = torch.ones(n_chunks * chunk, dtype=torch.bool, device=dev)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad),
                             value=torch.iinfo(torch.int32).max)
        valid[Skv:] = False

    # [B, K, groups, Sq, D] so GQA is an einsum over the shared K axis
    qg = (q.float() * scale).reshape(B, Sq, K, groups, D) \
        .permute(0, 2, 3, 1, 4)
    acc = torch.zeros((B, K, groups, Sq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, K, groups, Sq), NEG, dtype=torch.float32, device=dev)
    denom = torch.zeros((B, K, groups, Sq), dtype=torch.float32, device=dev)
    qpos = q_positions[:, None]                           # [Sq, 1]
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kch, vch = k[:, sl].float(), v[:, sl].float()     # [B, chunk, K, D]
        s = torch.einsum("bkgsd,bckd->bkgsc", qg, kch)
        kpos = kv_positions[sl][None, :]                  # [1, chunk]
        mask = valid[sl][None, :].expand(Sq, chunk)
        if causal:
            mask = mask & (kpos <= qpos)
        if sliding_window:
            mask = mask & (kpos > qpos - sliding_window)
        s = s.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgsc,bckd->bkgsd", p,
                                                    vch)
        m = m_new
    out = acc / torch.clamp_min(denom[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, length_mask: torch.Tensor,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention against a cache.

    q: [B, 1, H, D]; caches: [B, S, K, D]; length_mask: [B, S] bool (True =
    attend).  The kernel K8 computes the same for a prefix mask.
    """
    B, _, H, D = q.shape
    _, S, K, _ = k_cache.shape
    groups = H // K
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, K, groups, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s = s.masked_fill(~length_mask[:, None, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


__all__ = ["rms_norm", "layer_norm", "rope_angles", "apply_rope",
           "chunked_attention", "decode_attention", "swiglu", "gelu_mlp"]
