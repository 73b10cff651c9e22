"""Llama-3.2-3B: small llama3. [hf:meta-llama/Llama-3.2-1B]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="llama3.2-3b", arch_type="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B",
))
register_smoke(CFG)
