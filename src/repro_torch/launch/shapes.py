"""The four assigned input shapes and the per-(arch, shape) policy: a copy
of ``src/repro/launch/shapes.py`` on PyTorch.

  train_4k      seq 4,096    global_batch 256   -> train_step
  prefill_32k   seq 32,768   global_batch 32    -> prefill
  decode_32k    seq 32,768   global_batch 128   -> serve_step (1 new token,
                                                   KV cache = 32,768)
  long_500k     seq 524,288  global_batch 1     -> serve_step, sub-quadratic
                                                   attention required

long_500k policy (DESIGN.md §6): SSM/hybrid run natively (O(1)/O(S) state);
dense/MoE/VLM run a sliding-window (8,192) KV-cache variant, whose decode
cache is a ring of 8 192 slots; whisper is skipped (30 s audio ≤ 448
tokens — half-megatoken decode is outside the family's semantics).

The shape stand-ins are tensors on the meta device (the reference's
``jax.ShapeDtypeStruct``): shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_batch_specs

SLIDING_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k" and cfg.arch_type == "audio":
        return False             # enc-dec: skip, per DESIGN.md §6
    return True


def config_for_shape(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Sliding-window variant for attention archs at 500k decode."""
    if shape == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        return cfg.with_sliding_window(SLIDING_WINDOW)
    return cfg


def batch_specs(cfg: ModelConfig,
                shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins of a train / prefill batch."""
    return make_batch_specs(cfg, shape.global_batch, shape.seq_len)


def decode_token_specs(shape: ShapeSpec) -> torch.Tensor:
    """The decode step's tokens [global_batch] int32, on the meta device."""
    return torch.empty((shape.global_batch,), dtype=torch.int32,
                       device="meta")


__all__ = ["SHAPES", "SLIDING_WINDOW", "ShapeSpec", "batch_specs",
           "config_for_shape", "decode_token_specs", "shape_applicable"]
