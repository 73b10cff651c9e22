from .flash_attention.ops import flash_attention
from .decode_attention.ops import decode_attention
from .conv_pointwise.ops import conv1x1_fused
from .conv_quant.ops import qconv_add_fused, qconv_fused, qdwconv_fused

__all__ = ["flash_attention", "decode_attention", "conv1x1_fused",
           "qconv_fused", "qdwconv_fused", "qconv_add_fused"]
