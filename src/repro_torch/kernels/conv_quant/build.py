"""The int8 conv kernels' sources (``csrc/*.cu``) and the C signatures of
their launch functions; ``kernels/build.py`` builds and loads them."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import KernelSet

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the fused add's (ma, mb, zp_a, zp_b, zp_add) after the conv's arguments
_ADD = [_I, _I, _I, _I, _I]
_QCONV1X1 = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _I, _I]
# K1/K4's split-K plan: split count and chunk (ops.plan_split_k)
_SPLIT_K = [_I, _I]
# K3/K5: lanes, then the window rows, the ring's rows and the window's
# first ring row (ops.qconv's src/n), then the conv; the tile plan
# (ops.plan_qconv: N tile, Cin chunk) comes last, before device and stream
_QCONV = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
          _L, _L, _F, _I, _I]
_QCONV_PLAN = [_I, _I]

CONV_QUANT = KernelSet(Path(__file__).resolve().parent / "csrc", {
    "qconv1x1": _QCONV1X1 + _SPLIT_K + [_I, _P],
    # K2: like K3 without Cout, then the load width (ops.load_width) and
    # its tile (ops.plan_dw_tile)
    "qdwconv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                _L, _L, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "qconv": _QCONV + _QCONV_PLAN + [_I, _P],
    # K4/K5: residual pointer and its batch stride, then the add params
    "qconv1x1_add": _QCONV1X1 + [_P, _L] + _ADD + _SPLIT_K + [_I, _P],
    "qconv_add": _QCONV + [_P, _L] + _ADD + _QCONV_PLAN + [_I, _P],
})

__all__ = ["CONV_QUANT"]
