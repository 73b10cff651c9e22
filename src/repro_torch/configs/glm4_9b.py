"""GLM-4-9B: RoPE, aggressive GQA (kv=2). [hf:THUDM/glm-4-9b]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="glm4-9b", arch_type="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b",
))
register_smoke(CFG)
