"""Qwen2-7B: GQA with QKV bias. [arXiv:2407.10671]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="qwen2-7b", arch_type="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
))
register_smoke(CFG)
