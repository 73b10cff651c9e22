"""The flash-attention kernel's source (``csrc/flash_attention.cu``) and the
C signature of its launch function; ``kernels/build.py`` builds and loads
it."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import KernelSet

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

FLASH_ATTENTION = KernelSet(Path(__file__).resolve().parent / "csrc", {
    # q, k, v, out, B, H, K, Sq, Skv, D, q/k/v (batch, seq, head) strides
    # in elements, scale, causal, dtype, device, stream
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _L, _L, _L, _L, _L, _L, _L, _L, _L,
                        _F, _I, _I, _I, _P],
})

__all__ = ["FLASH_ATTENTION"]
