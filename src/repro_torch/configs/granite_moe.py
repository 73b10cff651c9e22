"""Granite-3.0-1B-A400M: 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_token=8,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
register_smoke(CFG)
