from .conv_quant.ops import qconv_fused, qdwconv_fused

__all__ = ["qconv_fused", "qdwconv_fused"]
