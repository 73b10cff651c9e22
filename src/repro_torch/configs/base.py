"""Model configuration system.  One file per assigned architecture registers
its exact full-size config plus a ``smoke`` reduced variant (≤2 layers,
d_model ≤ 512, ≤4 experts) used by CPU tests.  ``--arch <id>`` in the
launchers resolves through ``get_config``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

_REGISTRY: Dict[str, "ModelConfig"] = {}

ARCH_IDS = [
    "phi3.5-moe-42b-a6.6b", "llama3.2-3b", "internvl2-1b", "qwen2-7b",
    "granite-moe-1b-a400m", "zamba2-2.7b", "phi3-medium-14b",
    "whisper-large-v3", "glm4-9b", "xlstm-350m",
]
_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama3.2-3b": "llama32_3b",
    "internvl2-1b": "internvl2_1b",
    "qwen2-7b": "qwen2_7b",
    "granite-moe-1b-a400m": "granite_moe",
    "zamba2-2.7b": "zamba2_27b",
    "phi3-medium-14b": "phi3_medium",
    "whisper-large-v3": "whisper_large_v3",
    "glm4-9b": "glm4_9b",
    "xlstm-350m": "xlstm_350m",
    # the paper's own CNN models live in repro.graphs (graph IR, not the
    # transformer ModelConfig system)
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # block layout: mixer kind per layer; built by helpers below
    block_pattern: Tuple[str, ...] = ()   # 'attn'|'mamba'|'mlstm'|'slstm'|'shared_attn'

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM / recurrent
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    mlstm_proj_factor: int = 2

    # attention details
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention
    attn_chunk: int = 512
    # decode KV-cache sharding over the model axis:
    #   "auto"     -> "heads" when kv_heads divide the TP size, else "sequence"
    #   "heads"    -> shard KV heads (replicate when not divisible — the
    #                 naive baseline; can exceed HBM at 32k×128)
    #   "sequence" -> shard the cache sequence axis; decode attention runs as
    #                 flash-decoding partial-softmax + merge over 'model'
    kv_mode: str = "auto"
    # full-sequence (train/prefill) activation sharding over the model axis:
    #   "tp" -> Megatron tensor parallelism (heads/ffn sharded, per-layer
    #           activation all-reduce)
    #   "cp" -> context parallelism: sequence sharded over 'model', weights
    #           FSDP-gathered per layer, K/V all-gathered (cheap for small
    #           GQA kv) — §Perf iteration for collective-bound prefill
    act_shard: str = "tp"
    # MoE expert-weight FSDP over 'data': True gathers experts per layer
    # (fwd + remat'd bwd); False stores experts model-sharded only and lets
    # the OPTIMIZER states stay fsdp-sharded (ZeRO-1) — §Perf iteration
    moe_fsdp: bool = True

    # encoder-decoder (audio) / vlm frontend
    encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed frame embeddings (stub)
    num_patch_tokens: int = 0
    frontend_dim: int = 0          # embedding dim delivered by the stub

    dtype: str = "bfloat16"
    norm: str = "rms"              # rms | layer
    tie_embeddings: bool = False
    source: str = ""               # citation (paper / model card)

    # ------------------------------------------------------------ derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/logits tables are padded to a multiple of 128 for TP
        divisibility and lane alignment; padded logits are masked to -inf.
        The LOGICAL vocab (tokens, labels, losses) stays exact."""
        return -(-self.vocab_size // 128) * 128

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.arch_type == "hybrid":     # zamba: mamba backbone + shared
            g = self.num_layers // 6       # attn applied after each group
            return ("mamba",) * self.num_layers + ("shared_attn",) * 0 \
                if g == 0 else ("mamba",) * self.num_layers
        if self.arch_type == "ssm":        # xlstm: groups of 5 mLSTM+1 sLSTM
            g = self.num_layers // 6
            return (("mlstm",) * 5 + ("slstm",)) * g
        return ("attn",) * self.num_layers

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        return self.replace(sliding_window=window)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        n = V * d                      # embedding
        if not self.tie_embeddings:
            n += d * V                 # lm head
        for kind in self.pattern:
            if kind in ("attn", "shared_attn"):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
                if kind == "attn":
                    n += attn
                # shared_attn params counted once (outside the loop)
                if self.is_moe:
                    n += d * self.num_experts \
                        + self.num_experts * 3 * d * ff
                elif ff:
                    n += 3 * d * ff
            elif kind == "mamba":
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * N + H) + di * d + 3 * H
            elif kind in ("mlstm", "slstm"):
                n += 4 * d * d + 2 * d * self.num_heads
        if self.arch_type == "hybrid":     # shared attn block params, once
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
            n += attn + 3 * d * ff
        if self.encoder_layers:
            n += self.encoder_layers * (4 * d * d + 3 * d * ff)
            n += self.num_layers * (4 * d * d)   # cross attention
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_every = self.param_count() - len(self.pattern) \
            * self.num_experts * 3 * d * ff
        return dense_every + len(self.pattern) \
            * self.experts_per_token * 3 * d * ff


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    base, _, variant = name.partition("@")
    if base not in _REGISTRY:
        mod = _MODULES.get(base)
        if mod is None:
            raise KeyError(f"unknown architecture {base!r};"
                           f" known: {sorted(_MODULES)}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    cfg = _REGISTRY[base]
    if variant == "smoke":
        cfg = _REGISTRY[f"{base}@smoke"]
    elif variant:
        raise KeyError(f"unknown variant {variant!r}")
    return cfg


def register_smoke(base: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
    kw = dict(
        name=f"{base.name}@smoke",
        num_layers=2,
        d_model=min(base.d_model, 256),
        num_heads=4,
        num_kv_heads=min(base.num_kv_heads, 2),
        d_ff=min(base.d_ff, 512) if base.d_ff else 0,
        vocab_size=512,
        head_dim=0,
        num_experts=min(base.num_experts, 4),
        experts_per_token=min(base.experts_per_token, 2),
        ssm_state=min(base.ssm_state, 16) if base.ssm_state else 0,
        ssm_head_dim=16 if base.ssm_state else 64,
        encoder_layers=2 if base.encoder_layers else 0,
        encoder_seq=16 if base.encoder_seq else 0,
        num_patch_tokens=8 if base.num_patch_tokens else 0,
        frontend_dim=64 if base.frontend_dim else 0,
        attn_chunk=16,
        dtype="float32",
    )
    kw.update(overrides)
    if base.block_pattern and "block_pattern" not in overrides:
        kw["block_pattern"] = base.block_pattern[:kw["num_layers"]]
    return register(base.replace(**kw))
