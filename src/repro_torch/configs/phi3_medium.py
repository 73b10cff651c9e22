"""Phi-3-medium-14B: RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="phi3-medium-14b", arch_type="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352,
    rope_theta=10_000.0,
    source="arXiv:2404.14219",
))
register_smoke(CFG)
