"""The Mixture-of-Experts FFN of ``src/repro/models/moe.py`` on PyTorch, its
single-device path (``moe_ffn`` with no mesh, ``:101-105``).

Routing is the reference's: router logits in float32, softmax, top-k,
renormalised (``router_topk``).  Each expert takes at most ``capacity``
tokens: a token's slot in expert e is the number of tokens before it in
the flat ``[B*S]`` order that also chose e; a token at or past the
capacity is dropped for that expert (GShard's capacity factor).  The
expert FFNs run batched over the experts, three products over ``[E,
capacity, d]`` buffers with the weights' (bf16) operands accumulated in
float32, as the reference's ``preferred_element_type=f32`` einsums do;
a token's expert outputs are summed in ascending expert id in float32.

The reference loops over the experts one at a time; here each step of
that loop is a batched tensor operation, so the routing costs a fixed
number of launches and no host read (the decode step stays capturable).

On a mesh (``:107-139``) the experts are split over the "model" axis and
the tokens over the batch axes, replicated over "model": each rank runs
its ``E / tp`` experts (global ids from ``rank · E / tp``) on its batch
rows in a mapped body (``sharding.local_map``, the reference's
``shard_map``), with the capacity of those rows (``T_loc = B / dp ·
S``, not ``B · S``: a sharded run may drop other tokens than an
unsharded one), the expert weights all-gathered over "data" first where
``moe_fsdp`` stores them sharded there, and the partial outputs summed
over "model" in the activation dtype.  The router runs outside the body,
on the replicated logits.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .sharding import P, axis_sizes, is_dtensor, local_map, replicate, shard


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (probs [B,S,k] float32, expert ids [B,S,k] int32,
    load-balance aux loss), the reference's ``router_topk`` (``:26-42``).
    Equal probabilities may be ordered differently from ``lax.top_k``."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)                    # [B,S,E]
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    E = w_router.shape[-1]
    # one-hot of the first choice by comparison: F.one_hot reads the ids'
    # range on the host
    ids = torch.arange(E, device=x.device)
    if is_dtensor(top_i):
        ids = replicate(ids, top_i.device_mesh)
    first = (top_i[..., :1] == ids).float()
    f = first.reshape(-1, E).mean(0)
    p = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(f * p)
    return top_p, top_i.to(torch.int32), aux


def dispatch(top_i: torch.Tensor, num_experts: int, capacity: int,
             first_expert: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """top_i [T,k] -> (slot [T,E] int64, kept [T,E] bool): token t's row
    in expert ``first_expert + e``'s buffer and whether it is there.  A
    token that chose that expert gets slot ``cumsum`` of its hits before
    and at it, minus one, and is kept while that is below ``capacity``;
    every other (t, e) gets slot ``capacity``, the overflow row
    (``_expert_pass``, ``:58-63``)."""
    experts = first_expert + torch.arange(num_experts, device=top_i.device)
    hit = (top_i[:, :, None] == experts).any(1)              # [T,E]
    pos = torch.cumsum(hit.long(), 0) - 1
    kept = hit & (pos < capacity)
    return torch.where(kept, pos, capacity), kept


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` with its derivative,
    which PyTorch does not define for ``out_dtype``: the reference's
    ``preferred_element_type=f32`` einsums (``moe.py:72-78``) transposed
    as JAX transposes them, ``grad_a = g @ bᵀ`` and ``grad_b = aᵀ @ g``
    formed in float32 and returned in the operands' dtype.  On the card
    the forward is cuBLAS on the operands as they are; on the CPU, which
    has no ``out_dtype`` product, its plain stand-in widens them to at
    least float32 first (float64 stays float64, for ``gradcheck``)."""

    @staticmethod
    def forward(a, b):
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        acc = torch.promote_types(a.dtype, torch.float32)
        return torch.bmm(a.to(acc), b.to(acc))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.to(g.dtype).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(g.dtype).transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E,m,n] @ b [E,n,p] with float32 accumulation and result: bf16
    products are exact in float32, so only the order of the sums can
    differ from the reference's einsums.  On the card cuBLAS takes the
    bf16 operands as they are (``_BmmF32``, differentiable); on the CPU
    they are widened first."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.bmm(a.float(), b.float())
    return _BmmF32.apply(a, b)


def expert_pass(x_flat: torch.Tensor, top_p: torch.Tensor,
                top_i: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor,
                capacity: int, first_expert: int = 0) -> torch.Tensor:
    """Tokens -> experts -> tokens, capacity-bounded: x_flat [T,d], top_p /
    top_i [T,k], w_gate / w_up [E,d,ff], w_down [E,ff,d], the experts
    ``first_expert ..`` of the model's.  Returns y [T,d] float32: each
    token's outputs of those experts (the reference's ``_expert_pass``;
    all of them without a mesh)."""
    T, d = x_flat.shape
    E, k = w_gate.shape[0], top_i.shape[1]
    wt, dev = w_gate.dtype, x_flat.device
    top_i = top_i.long()
    slot, kept = dispatch(top_i, E, capacity, first_expert)
    experts = first_expert + torch.arange(E, device=dev)
    gate = torch.where(top_i[:, :, None] == experts,
                       top_p[:, :, None], 0.0).sum(1)        # [T,E]
    # the token in each expert's rows (T: none); only the overflow column
    # receives more than one token, and it is dropped
    src = torch.full((E, capacity + 1), T, dtype=torch.long, device=dev)
    src.scatter_(1, slot.t(), torch.arange(T, device=dev).expand(E, T))
    xz = torch.cat([x_flat.to(wt), x_flat.new_zeros((1, d), dtype=wt)])
    buf = xz[src[:, :capacity]]                              # [E,cap,d]
    h = (F.silu(_bmm_f32(buf, w_gate)) * _bmm_f32(buf, w_up)).to(wt)
    out = _bmm_f32(h, w_down)                                # [E,cap,d]
    out = torch.cat([out, out.new_zeros((E, 1, d))], 1).reshape(-1, d)
    # each token's chosen experts in ascending id, their rows and weights;
    # an expert of another rank weighs 0
    ids = torch.sort(top_i, dim=1).values - first_expert     # [T,k]
    mine = (ids >= 0) & (ids < E)
    ids = ids.clamp(0, E - 1)
    rows = ids * (capacity + 1) + slot.gather(1, ids)
    weight = torch.where(kept & (gate > 0), gate, 0.0).gather(1, ids)
    weight = torch.where(mine, weight, 0.0)
    part = out[rows] * weight[:, :, None]                    # [T,k,d]
    y = part[:, 0]
    for j in range(1, k):
        y = y + part[:, j]
    return y


def capacity_of(tokens: int, k: int, num_experts: int,
                capacity_factor: float) -> int:
    """Rows per expert: the reference's ``max(1, int(B*S*k/E*cf))``."""
    return max(1, int(tokens * k / num_experts * capacity_factor))


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, k: int,
            capacity_factor: float = 1.25, mesh=None,
            dp_axes: Tuple[str, ...] = (), tp_axis: str = "model"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d] in x's dtype, aux loss).  w_gate / w_up
    [E,d,ff], w_down [E,ff,d].  With a mesh: expert-parallel over
    ``tp_axis``, the tokens over ``dp_axes`` (``:107-139``); the body
    reads the expert weights all-gathered over "data" where they lie
    sharded there (``moe_fsdp``: the reference's ``fsdp_axis``)."""
    B, S, d = x.shape
    E = w_router.shape[-1]
    top_p, top_i, aux = router_topk(x, w_router, k)
    if mesh is None:
        cap = capacity_of(B * S, k, E, capacity_factor)
        y = expert_pass(x.reshape(-1, d), top_p.reshape(-1, k),
                        top_i.reshape(-1, k), w_gate, w_up, w_down, cap)
        return y.reshape(B, S, d).to(x.dtype), aux

    from torch.distributed.tensor import Partial, Replicate, Shard
    sizes = axis_sizes(mesh)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    tp = sizes[tp_axis]
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} ranks")
    E_loc = E // tp
    T_loc = (B // dp) * S
    cap = capacity_of(T_loc, k, E, capacity_factor)
    tok = P(dp_axes, None, None)
    w_spec = P(tp_axis, None, None)

    def shard_fn(xs, tps, tis, wg, wu, wd):
        first = mesh.get_local_rank(tp_axis) * E_loc
        Bl = xs.shape[0]
        y = expert_pass(xs.reshape(-1, d), tps.reshape(-1, k),
                        tis.reshape(-1, k), wg, wu, wd, cap, first)
        # summed over tp_axis in the activation dtype, not float32
        return y.to(xs.dtype).reshape(Bl, S, d)

    out = tuple(Shard(0) if a in dp_axes else
                (Partial() if a == tp_axis else Replicate())
                for a in mesh.mesh_dim_names)
    y = local_map(shard_fn, mesh, (tok, tok, tok, w_spec, w_spec, w_spec),
                  out)(shard(x, mesh, tok), shard(top_p, mesh, tok),
                       shard(top_i, mesh, tok), w_gate, w_up, w_down)
    return shard(y, mesh, tok).to(x.dtype), aux


__all__ = ["capacity_of", "dispatch", "expert_pass", "moe_ffn",
           "router_topk"]
