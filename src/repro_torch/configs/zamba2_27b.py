"""Zamba2-2.7B: Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
))
register_smoke(CFG, num_layers=6, d_model=128, num_heads=4, num_kv_heads=4,
               ssm_head_dim=16)
