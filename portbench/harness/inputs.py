"""The benchmark's inputs, made from ``--seed``: the float weights of every
layer and a pool of float32 images, drawn on the device by one generator
in two large calls.  Both the program and the reference get these same
values."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    weights: List[torch.Tensor]      # float32, on the device; () for a pool
    images: torch.Tensor             # [pool, H, W, 3] float32, on the device

    def weights_np(self) -> List[np.ndarray]:
        return [w.cpu().numpy() for w in self.weights]


def make(seed: int, shapes: Sequence[Sequence[int]], stds: Sequence[float],
         pool: int, resolution: int, device: torch.device) -> Inputs:
    """Weights normal with the given standard deviations (He's, for the
    reference network), images uniform in [-1, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = [math.prod(s) if len(s) else 0 for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    weights, at = [], 0
    for shape, size, std in zip(shapes, sizes, stds):
        w = flat[at:at + size]
        weights.append(w.reshape(tuple(shape)) * std if size else w)
        at += size
    images = torch.rand((pool, resolution, resolution, 3), generator=gen,
                        device=device) * 2.0 - 1.0
    return Inputs(weights, images)


__all__ = ["Inputs", "make"]
