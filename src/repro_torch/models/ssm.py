"""Recurrent mixers of the Zamba2 hybrid and xLSTM: the counterpart of
``src/repro/models/ssm.py`` on PyTorch.

Mamba2 and mLSTM are both *chunked linear attention with per-step decay*:

    state_t = exp(log_decay_t) · state_{t-1} + in_scale_t · k_t ⊗ v_t
    y_t     = q_t · state_t

Mamba2 maps (q, k, v, log_decay, in_scale) to (C, B, x, Δt·A, Δt), B and
C shared across heads; mLSTM to (q, k, v, log σ(f), σ(i)) with a
normaliser column appended to v.  ``chunked_linear_attention`` evaluates
it chunk by chunk (quadratic inside a chunk, the state carried between
chunks); the reference's ``lax.scan`` over chunks is a Python loop here,
as is the sLSTM's scan over time.  The arithmetic is the reference's
(``ssm.py:32-170``): the same clips to ``[-60, 0]`` (intra-chunk decay,
state-update weights, a step's decay; the inter-chunk ``exp(cum)`` and
the carried-state decay are not clipped — every log decay is <= 0), pad
positions with log decay 0 and input scale 0, everything in float32.
No kernel of the repo runs here: the reference computes all of it in
``jnp`` outside its Pallas kernels, so the port computes it in plain
PyTorch on either device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along axis 1."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])], 1)


def chunked_linear_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_decay: torch.Tensor, in_scale: torch.Tensor, *,
        chunk: int = 128, normalize: bool = False,
        state_in: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B,S,H,N]; v: [B,S,H,P]; log_decay, in_scale: [B,S,H].

    Returns (y [B,S,H,P] float32, final state [B,H,N,P(+1)] float32)."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    q, k, v = q.float(), k.float(), v.float()
    log_decay, in_scale = log_decay.float(), in_scale.float()
    if normalize:
        v = torch.cat([v, v.new_ones((B, S, H, 1))], -1)
    Pv = v.shape[-1]
    if normalize and state_in is not None and state_in.shape[-1] == P:
        raise ValueError("state_in must include the normaliser column")

    nz = -(-S // chunk)
    pad = nz * chunk - S
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    log_decay, in_scale = _pad_seq(log_decay, pad), _pad_seq(in_scale, pad)

    state = state_in if state_in is not None \
        else q.new_zeros((B, H, N, Pv))
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]               # j <= i
    ys = []
    for z in range(nz):
        c = slice(z * chunk, (z + 1) * chunk)
        qc, kc, vc, ldc, sc = q[:, c], k[:, c], v[:, c], log_decay[:, c], \
            in_scale[:, c]
        cum = torch.cumsum(ldc, 1)                       # [B,c,H]
        # ---- intra-chunk: scores (q_i·k_j)·exp(cum_i-cum_j)·s_j, j<=i
        att = torch.einsum("bihn,bjhn->bhij", qc, kc)
        cum_t = cum.transpose(1, 2)                      # [B,H,c]
        dec = torch.exp(torch.clamp(cum_t[:, :, :, None]
                                    - cum_t[:, :, None, :], -60.0, 0.0))
        w = att * dec * sc.transpose(1, 2)[:, :, None, :]
        w = torch.where(causal, w, 0.0)
        y_intra = torch.einsum("bhij,bjhp->bihp", w, vc)
        # ---- inter-chunk: carry-in state decayed to each position
        y_inter = torch.einsum("bihn,bhnp->bihp",
                               qc * torch.exp(cum)[..., None], state)
        # ---- state update
        tail = cum[:, -1:, :]                            # [B,1,H]
        wj = torch.exp(torch.clamp(tail - cum, -60.0, 0.0)) * sc
        state = state * torch.exp(tail[:, 0, :])[..., None, None] \
            + torch.einsum("bjhn,bjhp->bhnp", kc * wj[..., None], vc)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, 1)[:, :S]
    if normalize:
        y, denom = y[..., :P], y[..., P:]
        y = y / torch.clamp(denom.abs(), min=1.0)
    return y, state


def linear_attention_step(
        state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, log_decay: torch.Tensor, in_scale: torch.Tensor,
        *, normalize: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  q, k: [B,H,N]; v: [B,H,P]; gates: [B,H]; state:
    [B,H,N,P(+1)].  Returns (y [B,H,P], new state), both float32."""
    q, k, v = q.float(), k.float(), v.float()
    if normalize:
        v = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], -1)
    decay = torch.exp(torch.clamp(log_decay.float(), -60.0, 0.0))
    state = state * decay[..., None, None] \
        + in_scale.float()[..., None, None] \
        * (k[..., :, None] * v[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", q, state)
    if normalize:
        P = y.shape[-1] - 1
        y = y[..., :P] / torch.clamp(y[..., P:].abs(), min=1.0)
    return y, state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x [B,S,C]; w [W,C]; cache [B,W-1,C].
    Returns (silu(y) [B,S,C] in x's dtype, new cache [B,W-1,C]: the
    pre-activation window)."""
    W = w.shape[0]
    B, S, C = x.shape
    if cache is None:
        cache = x.new_zeros((B, W - 1, C))
    xc = torch.cat([cache, x], 1)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for t in range(W):      # W is 4: unrolled taps, as the reference's
        y = y + xc[:, t:t + S].float() * w[t].float()
    new_cache = xc[:, -(W - 1):] if W > 1 else cache
    return F.silu(y).to(x.dtype), new_cache


def slstm_scan(x_gates: torch.Tensor, r: torch.Tensor,
               state: Optional[Tuple[torch.Tensor, ...]] = None,
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """sLSTM with exponential gating and max-stabiliser.

    x_gates: [B,S,4,H,P] pre-activations (i, f, z, o); r: [4,H,P,P]
    per-head recurrent kernels.  Returns (h [B,S,H,P] in x_gates' dtype,
    final (c, n, h, m) float32).  With no ``state`` it starts from
    (0, 1, 0, -10), as the reference's scan does."""
    B, S, _, H, P = x_gates.shape
    if state is None:
        zeros = torch.zeros((B, H, P), dtype=torch.float32,
                            device=x_gates.device)
        state = (zeros, zeros + 1.0, zeros, zeros - 10.0)   # c, n, h, m
    c, n, h, m = state
    rr = r.float()
    hs = []
    for t in range(S):
        rec = torch.einsum("bhp,ghpq->bghq", h, rr)        # [B,4,H,P]
        pre = x_gates[:, t].float() + rec
        i_p, f_p, z_p, o_p = pre.unbind(1)
        log_i = i_p
        log_f = -F.softplus(-f_p)                           # log σ(f)
        m_new = torch.maximum(log_f + m, log_i)
        i_g = torch.exp(log_i - m_new)
        f_g = torch.exp(log_f + m - m_new)
        z = torch.tanh(z_p)
        o = torch.sigmoid(o_p)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1).to(x_gates.dtype), (c, n, h, m)


__all__ = ["causal_conv1d", "chunked_linear_attention",
           "linear_attention_step", "slstm_scan"]
