"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 50 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama3.2-3b@smoke --steps 50 --batch 8 --seq 128 --device cpu

The same flags and print lines as the reference's
``repro.launch.train``, plus ``--device``: the default trains on the card
(and fails without CUDA); ``--device cpu`` runs the plain PyTorch path on
the host (use a ``@smoke`` arch there).  On the card the step is one
captured CUDA graph (``training.GraphedTrainStep``), where the
reference's launcher wraps it in ``jax.jit``: the first two steps warm it
up eagerly, the third records and replays it, the rest replay it.  It
stays eager on the CPU (nothing to capture) and with
``--production-mesh`` (the sharded step's collectives go through the
host, which a graph cannot hold), and with ``--eager``, which keeps the
plain step on the card to compare against.  Every registered architecture
trains; the attention of training is the chunked path on either device,
as in the reference (K7 has no backward).  Weights are random, drawn on
the device from a ``torch.Generator`` seeded with 0, and batches come
from ``repro_torch.data.SyntheticLMDataset(seed=0)``, copied to the
device before each step.

``--production-mesh`` builds the reference's (16, 16) ("data",
"model") mesh over the default process group
(``launch.mesh.make_production_mesh``: every one of its 256 ranks runs
this launcher, after ``torch.distributed.init_process_group``; with
fewer ranks it raises ``RuntimeError``) and shards the state as the
reference's launcher does: parameters by ``param_specs``, the AdamW
moments by ``param_specs(moe_fsdp=True)``, the step replicated
(``training.train_state_init(..., mesh=)``).  ``main`` returns a
``TrainRun``: the final state, the
step function, the dataset and each step's wall seconds (the card
synchronised before and after the step), metrics and, on the card,
``torch.cuda.max_memory_allocated`` and ``memory_reserved`` after it;
for the graphed step also its capture ms and warm-up ms.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.models.sharding import full
from repro_torch.training import (GraphedTrainStep, TrainState,
                                  make_train_step, train_state_init)
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import tree_leaves, tree_map


class TrainRun(NamedTuple):
    state: TrainState
    step_fn: Callable[..., Any]
    dataset: SyntheticLMDataset
    # seconds, metrics, peak_bytes, reserved_bytes
    steps: List[Dict[str, Any]]
    capture_ms: Optional[float] = None      # the graphed step's
    warmup_ms: Optional[float] = None


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b@smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="build the 16x16 mesh (requires 256 devices)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain path)")
    ap.add_argument("--eager", action="store_true",
                    help="run the plain step on the card, not its graph")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else None

    cfg = get_config(args.arch)
    model = Model(cfg, mesh)
    state = train_state_init(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, mesh=mesh)
    n = sum(t.numel() for t in tree_leaves(state.params))
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None
    print(f"arch={cfg.name} params={n/1e6:.1f}M mesh={shape}")

    ds = SyntheticLMDataset(cfg, args.batch, args.seq, seed=0)
    step_fn = make_train_step(
        model, peak_lr=args.lr, warmup=max(args.steps // 10, 1),
        total_steps=args.steps, microbatches=args.microbatches)
    if dev.type == "cuda" and mesh is None and not args.eager:
        step_fn = GraphedTrainStep(step_fn, dev)
    steps, card = [], dev.type == "cuda"
    for i in range(args.steps):
        batch = device_batch(ds.batch(i), dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        _sync(dev)
        steps.append({"seconds": time.perf_counter() - t0, "metrics": m,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)
                      if card else None,
                      "reserved_bytes": torch.cuda.memory_reserved(dev)
                      if card else None})
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.3f} "
                  f"gnorm={float(m['grad_norm']):.2f}", flush=True)
    if args.ckpt_dir:
        print("saved:", save_checkpoint(args.ckpt_dir, tree_map(
            full, state.params), args.steps))
    graphed = isinstance(step_fn, GraphedTrainStep)
    return TrainRun(state, step_fn, ds, steps,
                    step_fn.capture_ms if graphed else None,
                    step_fn.warmup_ms if graphed else None)


if __name__ == "__main__":
    main()
