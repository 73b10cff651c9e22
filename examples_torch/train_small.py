"""Train a small LM for a few hundred steps on the synthetic Markov data
pipeline with the PyTorch port — loss drops well below the unigram
entropy, demonstrating the full training substrate (AdamW + cosine
schedule + remat + checkpointing).  On the card the step is one captured
CUDA graph (``training.GraphedTrainStep``), as the reference's example
jits it; on the CPU it runs eagerly.

    PYTHONPATH=src python examples_torch/train_small.py [--steps 200]  # card
    PYTHONPATH=src python examples_torch/train_small.py --device cpu
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training import (GraphedTrainStep, make_train_step,
                                  train_state_init)
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card; 'cpu' "
                         "for the plain path)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-3b@smoke")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).replace(num_layers=4, d_model=256)
    model = Model(cfg)
    state = train_state_init(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"arch={cfg.name}  params={n_params / 1e6:.1f}M")

    ds = SyntheticLMDataset(cfg, args.batch, args.seq, seed=0)
    step_fn = make_train_step(model, peak_lr=3e-3, warmup=args.warmup,
                              total_steps=args.steps, remat=True)
    if device.type == "cuda":       # one CUDA graph, as jax.jit compiles it
        step_fn = GraphedTrainStep(step_fn, device)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in ds.batch(i).items()}
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        if i % 20 == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {i:4d}  loss={float(metrics['loss']):.3f}  "
                  f"lr={float(metrics['lr']):.2e}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"({dt:.1f}s)")
    f = save_checkpoint(args.ckpt_dir, state.params, step=args.steps)
    print(f"checkpoint: {f}")
    return [float(l) for l in losses]


if __name__ == "__main__":
    main()
