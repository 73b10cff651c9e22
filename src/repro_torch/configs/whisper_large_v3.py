"""Whisper-large-v3: encoder-decoder; mel+conv frontend is a STUB delivering
frame embeddings [B, 1500, d_model]. [arXiv:2212.04356]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="whisper-large-v3", arch_type="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_seq=1500, frontend_dim=1280,
    rope_theta=10_000.0,
    source="arXiv:2212.04356",
))
register_smoke(CFG, num_kv_heads=4)
