"""The int8 conv kernels', the residual add's and the channel scale's
sources (``csrc/*.cu``) and the C signatures of their launch functions;
``kernels/build.py`` builds and loads them."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import KernelSet

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the fused add's (ma, mb, zp_a, zp_b, zp_add) after the conv's arguments
_ADD = [_I, _I, _I, _I, _I]
# every conv's int8 clamp pair (lo, hi), right after its zp_out
_CLAMP = [_I, _I]
# K1–K3's activation table after the clamp pair (null: the clamp alone)
_TABLE = [_P]
_QCONV1X1 = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _I, _I] + _CLAMP
# K1/K4's split-K plan: split count and chunk (ops.plan_split_k)
_SPLIT_K = [_I, _I]
# K3/K5: lanes, then the window rows, the ring's rows and the window's
# first ring row (ops.qconv's src/n), then the conv; the tile plan
# (ops.plan_qconv: N tile, Cin chunk) comes last, before device and stream
_QCONV = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
          _L, _L, _F, _I, _I] + _CLAMP
_QCONV_PLAN = [_I, _I]

CONV_QUANT = KernelSet(Path(__file__).resolve().parent / "csrc", {
    "qconv1x1": _QCONV1X1 + _TABLE + _SPLIT_K + [_I, _P],
    # K2: like K3 without Cout, then the load width (ops.load_width) and
    # its tile (ops.plan_dw_tile)
    "qdwconv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                _L, _L, _F, _I, _I] + _CLAMP + _TABLE
               + [_I, _I, _I, _I, _I, _I, _P],
    "qconv": _QCONV + _TABLE + _QCONV_PLAN + [_I, _P],
    # K4/K5: residual pointer and its batch stride, then the add params
    "qconv1x1_add": _QCONV1X1 + [_P, _L] + _ADD + _SPLIT_K + [_I, _P],
    "qconv_add": _QCONV + [_P, _L] + _ADD + _QCONV_PLAN + [_I, _P],
    # K9: legs a, b and out, lanes, elements a lane, the three lane
    # strides, the add's (ma, mb, zp_a, zp_b, zp_out), then the elements a
    # thread takes (ops.load_width)
    "qadd": [_P, _P, _P, _I, _L, _L, _L, _L] + _ADD + [_I, _I, _P],
    # K10: map, gate and out, lanes, elements a lane, channels, the three
    # lane strides, mult, zp_x, zp_g, zp_out, then the elements a thread
    # takes (ops.load_width)
    "qscale": [_P, _P, _P, _I, _L, _I, _L, _L, _L, _F, _I, _I, _I, _I, _I,
               _P],
})

__all__ = ["CONV_QUANT"]
