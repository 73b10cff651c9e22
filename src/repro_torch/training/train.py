"""Training step: loss, gradients and AdamW, with optional
gradient-accumulation microbatching and remat (activation checkpointing)
inside the model stack: ``src/repro/training/train.py`` on PyTorch.

The parameters are leaf tensors that require grad; ``torch.autograd.grad``
gives the step its gradients (no ``.grad`` is kept between steps), in
``tree_leaves`` order.  The step returns its metrics as 0-d tensors on
the device and reads nothing back to the host, so a caller decides when
to wait for the card.  ``adamw_update`` updates the state in place: the
returned ``TrainState`` holds the same tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, init_params, param_specs
from repro_torch.models.sharding import full
from .optimizer import (AdamWState, Tree, adamw_init, adamw_update,
                        cosine_lr, tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Tree
    opt: AdamWState


def train_state_init(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None, mesh=None) -> TrainState:
    """Random parameters (``models.init_params``: on ``device``, None the
    card, from ``generator``, None a new one seeded with 0) that require
    grad, and zero float32 moments.  With a ``mesh`` the sharded state of
    the reference's launcher and dry-run (``launch/train.py:40-51``,
    ``launch/dryrun.py:90-102``): parameters placed by ``param_specs``,
    the moments always by ``param_specs(cfg.replace(moe_fsdp=True))``
    (ZeRO-1 keeps the optimizer state sharded over "data" where the
    experts' weights are not), ``step`` replicated (every rank holds
    it)."""
    params = tree_map(lambda t: t.requires_grad_(),
                      init_params(cfg, generator, device, mesh=mesh))
    specs = param_specs(cfg.replace(moe_fsdp=True), mesh) \
        if mesh is not None else None
    return TrainState(params=params, opt=adamw_init(params, specs, mesh))


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    microbatches: int = 1, remat: bool = True
                    ) -> Callable[[TrainState, Dict[str, Any]], Any]:
    """Returns train_step(state, batch) -> (state, metrics): ``ce``,
    ``aux``, ``grad_norm``, ``loss`` and ``lr``, 0-d tensors, the plain
    step (``training.GraphedTrainStep`` captures it on the card, where
    the reference writes ``jax.jit``; it carries ``model`` and
    ``microbatches`` as attributes for that).  With
    ``microbatches`` > 1 the batch splits along dim 0 into that many
    contiguous pieces (the reference's reshape); their gradients add up
    in float32 accumulators, and loss and gradients are divided by
    ``microbatches``, the metrics averaged."""

    def value_and_grad(params: Tree, batch):
        leaves = tree_leaves(params)
        loss, metrics = model.loss_fn(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return full(loss).detach(), \
            {k: full(v).detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: Dict[str, Any]):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(state.params, batch)
        else:
            B = len(batch["tokens"])
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(state.params)]
            loss, ms = 0.0, []
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, m_i, g_i = value_and_grad(state.params, mb)
                for acc, g in zip(grads, g_i):
                    acc.add_(g)
                loss = loss + l_i
                ms.append(m_i)
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        lr = cosine_lr(state.opt.step, peak=peak_lr, warmup=warmup,
                       total=total_steps)
        params, opt, om = adamw_update(state.params, grads, state.opt, lr=lr)
        metrics = dict(metrics)
        metrics.update({k: full(v) for k, v in om.items()})
        metrics["loss"] = loss
        metrics["lr"] = lr
        return TrainState(params, opt), metrics

    # what GraphedTrainStep names in its errors and checks for a mesh
    train_step.model, train_step.microbatches = model, microbatches
    return train_step


__all__ = ["TrainState", "make_train_step", "train_state_init"]
