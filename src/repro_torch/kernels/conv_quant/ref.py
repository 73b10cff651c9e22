"""Plain PyTorch versions of the int8 conv kernels K1–K3.

Each is the q-op written out directly: a **float64** convolution of
``x - zp_in`` with the int8 weights, cast to int32, then the literal
requantize of ``repro``'s ``cnn_ops.requantize``:
``round(f32(acc) * f32(mult)) + zp_out``, clipped to ``[zp_out, 127]``
(the fused ReLU) and cast to int8.

The float64 convolution is exact: every partial sum is an integer of
magnitude at most k²·Cin·255·127 < 2**53, so any summation order gives
the same int32 accumulator.  Padding with 0 *after* the zero-point
subtract is padding the int8 input with ``zp_in``, as the reference does.
cuDNN is switched off around the convolution, so that on the card (where
``chip_smoke.py`` holds the kernels against these) no inexact FFT or
Winograd algorithm can be chosen.

The kernel wrappers in ``ops.py`` call these for tensors on the CPU, and
the tests compare them with the JAX package.  Nothing on the CUDA path
calls them.  Tensors are NHWC with an optional leading batch dimension.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

INT8_MIN, INT8_MAX = -128, 127


def requantize(acc: torch.Tensor, mult: float, zp_out: int,
               lo: int = INT8_MIN) -> torch.Tensor:
    """int32 accumulator -> int8 at the output (scale, zero_point).  ``lo``
    is the lower clamp: ``zp_out`` for fused relu (real 0), -128 otherwise.
    ``mult`` is applied as ``np.float32(mult)`` in a float32 tensor, never
    as a Python float, so the product is the reference's float32 one."""
    m = torch.tensor(np.float32(mult), dtype=torch.float32, device=acc.device)
    y = torch.round(acc.to(torch.float32) * m) + zp_out
    return torch.clamp(y, lo, INT8_MAX).to(torch.int8)


def _conv_acc(x: torch.Tensor, w_oihw: torch.Tensor, stride: int, zp_in: int,
              hpad: Tuple[int, int], wpad: Tuple[int, int],
              groups: int = 1) -> torch.Tensor:
    """Exact int32 accumulator of a (grouped) conv on ``x - zp_in``."""
    squeeze = x.dim() == 3
    x4 = x[None] if squeeze else x
    xi = (x4.to(torch.float64) - zp_in).permute(0, 3, 1, 2)
    xi = F.pad(xi, (wpad[0], wpad[1], hpad[0], hpad[1]))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xi, w_oihw.to(torch.float64), stride=stride,
                       groups=groups)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return acc[0] if squeeze else acc


def qconv1x1_ref(x: torch.Tensor, w: torch.Tensor, *, mult: float,
                 zp_in: int, zp_out: int) -> torch.Tensor:
    """K1's function: x [..., H, W, Cin] int8, w [Cin, Cout] int8 ->
    [..., H, W, Cout] int8."""
    acc = torch.matmul(x.to(torch.float64) - zp_in, w.to(torch.float64))
    return requantize(acc.to(torch.int32), mult, zp_out, lo=zp_out)


def qconv_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
              zp_in: int, zp_out: int, hpad: Tuple[int, int],
              wpad: Tuple[int, int]) -> torch.Tensor:
    """K3's function: x [..., H, W, Cin] int8, w [k, k, Cin, Cout] int8 ->
    [..., OH, OW, Cout] int8 with explicit (before, after) pads."""
    acc = _conv_acc(x, w.permute(3, 2, 0, 1), stride, zp_in, hpad, wpad)
    return requantize(acc, mult, zp_out, lo=zp_out)


def qdwconv_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                mult: float, zp_in: int, zp_out: int, hpad: Tuple[int, int],
                wpad: Tuple[int, int]) -> torch.Tensor:
    """K2's function: x [..., H, W, C] int8, w [k, k, C] int8 (depthwise)
    -> [..., OH, OW, C] int8 with explicit (before, after) pads."""
    acc = _conv_acc(x, w.permute(2, 0, 1)[:, None], stride, zp_in, hpad,
                    wpad, groups=x.shape[-1])
    return requantize(acc, mult, zp_out, lo=zp_out)


__all__ = ["requantize", "qconv1x1_ref", "qconv_ref", "qdwconv_ref",
           "INT8_MIN", "INT8_MAX"]
