"""xLSTM-350M: mLSTM + sLSTM blocks, no separate FFN (d_ff=0).
[arXiv:2405.04517]"""
from .base import ModelConfig, register, register_smoke

CFG = register(ModelConfig(
    name="xlstm-350m", arch_type="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    source="arXiv:2405.04517",
))
register_smoke(CFG, num_layers=6, d_ff=0)
