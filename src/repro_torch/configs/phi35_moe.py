"""Phi-3.5-MoE-instruct: 42B total / 6.6B active, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2,
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
register_smoke(CFG)
