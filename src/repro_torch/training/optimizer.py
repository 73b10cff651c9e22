"""AdamW with decoupled weight decay, cosine schedule and global-norm
clipping: ``src/repro/training/optimizer.py`` on PyTorch, formula for
formula (not ``torch.optim.AdamW``, which places the decay and the bias
correction elsewhere).

Moments are kept in float32 whatever the parameter dtype (bf16 training):
the update is computed in float32 and cast back.  Parameter trees are
nested dicts of tensors; their leaves go in the order of the reference's
``jax.tree_util.tree_leaves``, sorted key paths (``tree_items``), which
is also the order ``global_norm`` sums them in.

One departure: ``adamw_update`` updates the parameters, the moments and
the step in place and returns them, as ``torch.optim`` does, where the
reference returns new arrays.  New copies beside the old would double the
optimizer's 12 bytes a parameter (Llama-3.2-3B: 43 GB) on one card.  The
arithmetic is the reference's, one rounding per operation.  Nothing reads
the host: the step, the bias corrections and the learning rate stay
0-d tensors on the parameters' device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.sharding import empty_like_spec, is_dtensor

Tree = Dict[str, Any]


def tree_items(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[("blocks/wq", leaf), ...]``: the leaves of nested dicts with
    their key paths, in sorted key order (``tree_leaves``' order)."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        out += tree_items(v, path + "/") if isinstance(v, dict) \
            else [(path, v)]
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return [v for _, v in tree_items(tree)]


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    mu: Tree
    nu: Tree


def adamw_init(params: Tree, specs: Optional[Tree] = None,
               mesh=None) -> AdamWState:
    """Zero float32 moments like ``params`` and step 0.  With ``specs``
    (a ``param_specs`` tree) and a ``mesh`` the moments are DTensors
    placed by them, made in place on each rank; ``step`` is a plain 0-d
    tensor every rank holds (replicated)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def placed(tree, spec):
        return {k: placed(v, spec[k]) if isinstance(v, dict)
                else empty_like_spec(v.shape, mesh, spec[k],
                                     dtype=torch.float32, device=v.device)
                for k, v in tree.items()}
    dev = tree_leaves(params)[0].device
    mu, nu = (tree_map(zeros, params), tree_map(zeros, params)) \
        if specs is None else (placed(params, specs), placed(params, specs))
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


def cosine_lr(step: torch.Tensor, *, peak: float, warmup: int,
              total: int, floor: float = 0.1) -> torch.Tensor:
    step = step.float()
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, peak * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, in leaf
    order (a tree, or a list of leaves already in that order)."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def _like(t, ref):
    """``t`` placed as DTensor ``ref`` is (``t`` as it is otherwise)."""
    if is_dtensor(t) and tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


@torch.no_grad()
def adamw_update(params: Tree, grads, state: AdamWState, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0):
    """Returns (params, state, metrics), the first two updated in place.
    ``grads``: a tree like ``params``, or its leaves in ``tree_leaves``
    order; bf16 gradients are widened here, after the norm."""
    flat_g = tree_leaves(grads) if isinstance(grads, dict) else list(grads)
    # a DTensor gradient goes where its moment lies (a reduce-scatter of a
    # partial sum, a slice of a replicated one)
    flat_g = [_like(g, m) for g, m in zip(flat_g, tree_leaves(state.mu))]
    gnorm = global_norm(flat_g)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    state.step.add_(1)
    b1c = 1 - b1 ** state.step.float()
    b2c = 1 - b2 ** state.step.float()
    for p, g, m, v in zip(tree_leaves(params), flat_g,
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))               # b1 m + (1 - b1) g
        v.mul_(b2).add_(g.square_().mul_(1 - b2))   # b2 v + (1 - b2) g²
        del g
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
        delta = _like(delta, p)     # ZeRO-1: moments sharded, p not
        if p.ndim >= 2:     # decoupled decay only on >= 2-D tensors
            delta.add_(p.float() * weight_decay)
        p.copy_(delta.mul_(lr).neg_().add_(p))      # p - lr delta
    return params, state, {"grad_norm": gnorm}


__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "tree_items", "tree_leaves", "tree_map"]
