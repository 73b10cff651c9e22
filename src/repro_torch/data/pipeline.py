"""Deterministic synthetic LM data pipeline.

Generates a learnable Markov-chain token stream (so the e2e training example
actually shows loss going down, not just noise) with per-step deterministic
seeding — every data-parallel host can regenerate its shard independently,
which is how the pipeline scales to the multi-pod mesh without a central
loader.  Also provides the modality-stub inputs (patch/frame embeddings).

A copy of ``src/repro/data/pipeline.py`` (numpy only): the same seed and
step give the same arrays.  ``make_batch_specs`` returns tensors on the
meta device in place of ``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    order: int = 2        # markov order

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.cfg.vocab_size
        # sparse-ish transition table over a reduced state space
        self.n_states = min(V, 997)
        self.trans = rng.integers(0, V, size=(self.n_states, 8))

    def _tokens(self, rng, B, S):
        V = self.cfg.vocab_size
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        choice = rng.integers(0, 8, size=(B, S))
        noise = rng.random((B, S))
        rand_tok = rng.integers(0, V, size=(B, S))
        for t in range(1, S):
            nxt = self.trans[toks[:, t - 1] % self.n_states, choice[:, t]]
            toks[:, t] = np.where(noise[:, t] < 0.1, rand_tok[:, t], nxt)
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        n_text = self.seq_len - (cfg.num_patch_tokens or 0)
        out: Dict[str, np.ndarray] = {
            "tokens": self._tokens(rng, self.batch_size, n_text)}
        if cfg.num_patch_tokens:
            out["patches"] = rng.standard_normal(
                (self.batch_size, cfg.num_patch_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        if cfg.arch_type == "audio":
            out["frames"] = rng.standard_normal(
                (self.batch_size, cfg.encoder_seq, cfg.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, batch_size: int, seq_len: int,
                     dtype="float32") -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins of a batch, for shape-only tracing (no
    allocation)."""
    def spec(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    n_text = seq_len - (cfg.num_patch_tokens or 0)
    specs = {"tokens": spec((batch_size, n_text), torch.int32)}
    if cfg.num_patch_tokens:
        specs["patches"] = spec(
            (batch_size, cfg.num_patch_tokens, cfg.frontend_dim),
            torch.float32)
    if cfg.arch_type == "audio":
        specs["frames"] = spec(
            (batch_size, cfg.encoder_seq, cfg.frontend_dim), torch.float32)
    return specs
