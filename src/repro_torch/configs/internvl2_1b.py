"""InternVL2-1B: InternViT vision encoder (STUB -> patch embeddings) +
Qwen2-0.5B-class language decoder. [arXiv:2404.16821]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="internvl2-1b", arch_type="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    qkv_bias=True, rope_theta=1_000_000.0,
    num_patch_tokens=256, frontend_dim=1024,
    source="arXiv:2404.16821",
))
register_smoke(CFG)
