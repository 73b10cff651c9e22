"""The decode-attention kernel's source (``csrc/decode_attention.cu``) and
the C signature of its launch function; ``kernels/build.py`` builds and
loads it."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import KernelSet

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

DECODE_ATTENTION = KernelSet(Path(__file__).resolve().parent / "csrc", {
    # q, k_cache, v_cache, lengths, out, B, H, K, S, D, q (batch, head)
    # strides, k/v (batch, seq, head) strides in elements, scale, dtype,
    # split (ops.plan_split), the 16-byte path or not, device, stream
    "decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _L, _L, _L, _L, _L, _L, _L, _L,
                         _F, _I, _I, _I, _I, _P],
})

__all__ = ["DECODE_ATTENTION"]
