"""The float32 pointwise conv kernel's source (``csrc/conv1x1.cu``) and the
C signature of its launch function; ``kernels/build.py`` builds and loads
it."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import KernelSet

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

CONV_POINTWISE = KernelSet(Path(__file__).resolve().parent / "csrc", {
    # x, w, b (or null), out, B, M, Cin, Cout, x_bs, o_bs (elements), relu,
    # the plan's tile rows, split and chunk (ops.plan_split_k), device,
    # stream
    "conv1x1": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _I, _I, _I,
                _P],
})

__all__ = ["CONV_POINTWISE"]
