"""Plain PyTorch versions of the int8 conv kernels K1–K5.

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

K2, K3 and K5 also read a cascade ring window where it lies: the input is
rows ``(src + j) % ring_rows`` (j < n) of a ring ``[..., ring_rows, W,
C]``.  ``*_ring_ref`` are their plain versions, with the kernels'
arguments (ring, src, n, ...; ring_rows is the ring's row count).

The fused conv -> add kernels K4/K5 are K1/K3 followed by ``qadd``, the
port's fixed-point add (it lives here, and ``graphs/cnn_ops.py`` imports
it, so that the plain K4/K5 and the graph op are one function).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

INT8_MIN, INT8_MAX = -128, 127


@functools.lru_cache(maxsize=None)
def f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    """``np.float32(value)`` as a 0-dim float32 tensor on ``device``, made
    once per value: a CUDA graph capture may not copy from the host, so
    the arena program's first (eager) run makes the scalars it replays.
    Read only."""
    return torch.tensor(np.float32(value), dtype=torch.float32,
                        device=device)


def requantize(acc: torch.Tensor, mult: float, zp_out: int,
               lo: int = INT8_MIN) -> torch.Tensor:
    """int32 accumulator -> int8 at the output (scale, zero_point).  ``lo``
    is the lower clamp: ``zp_out`` for fused relu (real 0), -128 otherwise.
    ``mult`` is applied as ``np.float32(mult)`` in a float32 tensor, never
    as a Python float, so the product is the reference's float32 one."""
    m = f32_scalar(mult, acc.device)
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


def ring_window(ring: torch.Tensor, src: int, n: int) -> torch.Tensor:
    """Rows ``(src + j) % ring_rows``, j < n, of ``ring`` [..., ring_rows,
    W, C], in window order (a new tensor)."""
    rows = ring.shape[-3]
    idx = (src + torch.arange(n, device=ring.device)) % rows
    return ring.index_select(ring.dim() - 3, idx)


def qconv_ring_ref(ring: torch.Tensor, w: torch.Tensor, *, src: int, n: int,
                   **kw) -> torch.Tensor:
    """K3's function on the ring window (src, n) of ``ring``."""
    return qconv_ref(ring_window(ring, src, n), w, **kw)


def qdwconv_ring_ref(ring: torch.Tensor, w: torch.Tensor, *, src: int,
                     n: int, **kw) -> torch.Tensor:
    """K2's function on the ring window (src, n) of ``ring``."""
    return qdwconv_ref(ring_window(ring, src, n), w, **kw)


# qadd runs in fixed point: the two rescale multipliers are quantized to
# QADD_SHIFT fractional bits on the host and the whole op is int32
# arithmetic + an integer round-half-even — integer ops cannot be contracted
# into an FMA, so it is bit-identical in every execution context.
QADD_SHIFT = 16


def qadd_multipliers(mult_a: float, mult_b: float) -> Tuple[int, int]:
    """(ma, mb): the add's multipliers with QADD_SHIFT fractional bits
    (Python's ``round``, half to even, as the reference).  Their sum of
    magnitudes is held to 2**23, as the reference asserts, so that the
    int32 accumulator cannot overflow (|x - zp| <= 255)."""
    ma = int(round(float(mult_a) * (1 << QADD_SHIFT)))
    mb = int(round(float(mult_b) * (1 << QADD_SHIFT)))
    if abs(ma) + abs(mb) > (1 << 23):
        raise ValueError(f"qadd multipliers too large: |{mult_a}| + "
                         f"|{mult_b}| > 128")
    return ma, mb


def _round_half_even_rshift(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """Round-half-even of ``acc / 2**shift`` in pure integer arithmetic
    (``acc`` any signed int tensor; arithmetic right shift floors)."""
    base = acc >> shift
    rem = acc - (base << shift)          # in [0, 2**shift)
    half = 1 << (shift - 1)
    return torch.where(rem > half, base + 1,
                       torch.where(rem < half, base, base + (base & 1)))


def qadd(a: torch.Tensor, b: torch.Tensor, mult_a: float, mult_b: float,
         zp_a: int, zp_b: int, zp_out: int) -> torch.Tensor:
    """int8 + int8 -> int8 at the output params, no ReLU."""
    ma, mb = qadd_multipliers(mult_a, mult_b)
    acc = ((a.to(torch.int32) - zp_a) * ma
           + (b.to(torch.int32) - zp_b) * mb)
    y = _round_half_even_rshift(acc, QADD_SHIFT) + zp_out
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def qconv1x1_add_ref(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, *,
                     mult: float, zp_in: int, zp_out: int,
                     add_params: Tuple[float, float, int, int, int]
                     ) -> torch.Tensor:
    """K4's function: K1's, then ``qadd`` with the residual ``r`` [..., H,
    W, Cout] int8.  ``add_params = (mult_a, mult_b, zp_a, zp_b, zp_out)``,
    leg *a* being the conv's output."""
    y = qconv1x1_ref(x, w, mult=mult, zp_in=zp_in, zp_out=zp_out)
    return qadd(y, r, *add_params)


def qconv_add_ref(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, *,
                  stride: int, mult: float, zp_in: int, zp_out: int,
                  hpad: Tuple[int, int], wpad: Tuple[int, int],
                  add_params: Tuple[float, float, int, int, int]
                  ) -> torch.Tensor:
    """K5's function: K3's, then ``qadd`` with the residual ``r`` [..., OH,
    OW, Cout] int8."""
    y = qconv_ref(x, w, stride=stride, mult=mult, zp_in=zp_in,
                  zp_out=zp_out, hpad=hpad, wpad=wpad)
    return qadd(y, r, *add_params)


def qconv_add_ring_ref(ring: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                       *, src: int, n: int, **kw) -> torch.Tensor:
    """K5's function on the ring window (src, n) of ``ring``."""
    return qconv_add_ref(ring_window(ring, src, n), w, r, **kw)


__all__ = ["f32_scalar", "requantize", "qconv1x1_ref", "qconv_ref",
           "qdwconv_ref", "qadd", "qadd_multipliers", "qconv1x1_add_ref",
           "qconv_add_ref", "QADD_SHIFT", "INT8_MIN", "INT8_MAX",
           "ring_window", "qconv_ring_ref", "qdwconv_ring_ref",
           "qconv_add_ring_ref"]
