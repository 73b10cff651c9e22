"""Host wrappers of the int8 conv kernels K1–K3, and the q-op drop-ins
``qconv_fused``/``qdwconv_fused`` with the reference's routing rule.

The device decides, not a knob (the reference's ``use_pallas`` and
``interpret`` are gone): on a CUDA tensor a wrapper launches its Hopper
kernel or raises; on a CPU tensor it runs the plain version in ``ref.py``.
No path falls back from a failed build or launch to the plain version.

Tensors are NHWC with an optional leading batch dimension; one call over
``B`` lanes is one launch.  The kernels read and write arena views in
place: every lane's [H, W, C] block must be contiguous, and the lanes may
lie any number of bytes apart (the batch stride is passed to the kernel,
so no copy is made).  ``out`` (optional) is the destination view.

Each kernel wrapper counts its launches in ``<wrapper>.launches``, a plain
integer that only a kernel launch increments.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.partition import same_pads

from . import build, ref


def _pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    _, beg, end = same_pads(n, k, stride)
    return beg, end


def _require_int8(name: str, t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int8:
        raise TypeError(f"{name} must be an int8 torch tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")


def _lanes(name: str, t: torch.Tensor) -> Tuple[int, int]:
    """(lanes, batch stride in bytes) of an NHWC int8 tensor whose every
    lane is contiguous; raises on any other layout."""
    if t.dim() not in (3, 4):
        raise ValueError(f"{name} must be [H,W,C] or [B,H,W,C], got "
                         f"shape {tuple(t.shape)}")
    h, w, c = t.shape[-3:]
    if t.stride()[-3:] != (w * c, c, 1):
        raise ValueError(f"{name}: each lane must be contiguous NHWC, got "
                         f"strides {t.stride()}")
    if t.dim() == 3:
        return 1, 0
    return t.shape[0], t.stride(0)


def _destination(out: Optional[torch.Tensor], shape, like: torch.Tensor
                 ) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.int8, device=like.device)
    _require_int8("out", out)
    if tuple(out.shape) != tuple(shape) or out.device != like.device:
        raise ValueError(f"out is {tuple(out.shape)} on {out.device}, "
                         f"expected {tuple(shape)} on {like.device}")
    return out


def _plain(y: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return y
    _destination(out, y.shape, y).copy_(y)
    return out


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
            *args) -> None:
    if not (x.is_cuda and w.is_cuda and out.is_cuda):
        raise ValueError(f"{name}: x, w and out must all be CUDA tensors")
    if not w.is_contiguous():
        raise ValueError(f"{name}: weights must be contiguous")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(build.load(name), f"{name}_launch")
    rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), *args, x.device.index or 0,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _out_hw(h: int, w: int, k: int, stride: int, hpad, wpad):
    oh = (h + hpad[0] + hpad[1] - k) // stride + 1
    ow = (w + wpad[0] + wpad[1] - k) // stride + 1
    return oh, ow


# ------------------------------------------------------------------ kernels
def qconv1x1(x: torch.Tensor, w: torch.Tensor, *, mult: float, zp_in: int,
             zp_out: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: x [..., H, W, Cin] int8, w [Cin, Cout] int8 -> [..., H, W, Cout]
    int8; the stride-1, unpadded 1x1 case of ``qconv2d`` with fused ReLU."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    h, wd, cin = x.shape[-3:]
    if w.dim() != 2 or w.shape[0] != cin:
        raise ValueError(f"w must be [Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    shape = (*x.shape[:-1], w.shape[1])
    if x.device.type == "cpu":
        return _plain(ref.qconv1x1_ref(x, w, mult=mult, zp_in=zp_in,
                                       zp_out=zp_out), out)
    out = _destination(out, shape, x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qconv1x1", x, w, out, lanes, h * wd, cin, w.shape[1],
                x_bs, o_bs, float(np.float32(mult)), zp_in, zp_out)
        qconv1x1.launches += 1
    return out


def qconv(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
          zp_in: int, zp_out: int, hpad: Tuple[int, int],
          wpad: Tuple[int, int],
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: x [..., H, W, Cin] int8, w [k, k, Cin, Cout] int8 ->
    [..., OH, OW, Cout] int8, explicit (before, after) pads, fused ReLU."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    h, wd, cin = x.shape[-3:]
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != cin:
        raise ValueError(f"w must be [k, k, Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    k, cout = w.shape[0], w.shape[3]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    if x.device.type == "cpu":
        return _plain(ref.qconv_ref(x, w, stride=stride, mult=mult,
                                    zp_in=zp_in, zp_out=zp_out, hpad=hpad,
                                    wpad=wpad), out)
    out = _destination(out, (*x.shape[:-3], oh, ow, cout), x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qconv", x, w, out, lanes, h, wd, cin, cout, oh, ow, k,
                stride, hpad[0], wpad[0], x_bs, o_bs,
                float(np.float32(mult)), zp_in, zp_out)
        qconv.launches += 1
    return out


def qdwconv(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
            zp_in: int, zp_out: int, hpad: Tuple[int, int],
            wpad: Tuple[int, int],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: x [..., H, W, C] int8, w [k, k, C] int8 -> [..., OH, OW, C] int8
    (depthwise), explicit (before, after) pads, fused ReLU."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    h, wd, c = x.shape[-3:]
    if w.dim() != 3 or w.shape[0] != w.shape[1] or w.shape[2] != c:
        raise ValueError(f"w must be [k, k, C={c}], got {tuple(w.shape)}")
    k = w.shape[0]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    if x.device.type == "cpu":
        return _plain(ref.qdwconv_ref(x, w, stride=stride, mult=mult,
                                      zp_in=zp_in, zp_out=zp_out, hpad=hpad,
                                      wpad=wpad), out)
    out = _destination(out, (*x.shape[:-3], oh, ow, c), x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qdwconv", x, w, out, lanes, h, wd, c, oh, ow, k, stride,
                hpad[0], wpad[0], x_bs, o_bs, float(np.float32(mult)),
                zp_in, zp_out)
        qdwconv.launches += 1
    return out


qconv1x1.launches = 0
qconv.launches = 0
qdwconv.launches = 0
KERNEL_WRAPPERS = {"qconv1x1": qconv1x1, "qdwconv": qdwconv, "qconv": qconv}


# ------------------------------------------------------ q-op drop-ins
def qconv_fused(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                mult: float, zp_in: int, zp_out: int,
                hpad: Optional[Tuple[int, int]] = None,
                wpad: Optional[Tuple[int, int]] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``qconv2d`` (w in the graph's (k, k, Cin, Cout) layout,
    SAME pads unless ``hpad``/``wpad`` override them), bit-identical.
    k=1, stride=1 and no pads go to K1, everything else to K3."""
    hpad = None if hpad is None else tuple(hpad)
    wpad = None if wpad is None else tuple(wpad)
    k = w.shape[0]
    if (k == 1 and stride == 1 and hpad in (None, (0, 0))
            and wpad in (None, (0, 0))):
        return qconv1x1(x, w.reshape(w.shape[2:]), mult=mult, zp_in=zp_in,
                        zp_out=zp_out, out=out)
    hp = _pads(x.shape[-3], k, stride) if hpad is None else hpad
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else wpad
    return qconv(x, w, stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
                 hpad=hp, wpad=wp, out=out)


def qdwconv_fused(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                  mult: float, zp_in: int, zp_out: int,
                  hpad: Optional[Tuple[int, int]] = None,
                  wpad: Optional[Tuple[int, int]] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``qdwconv2d`` (w in the graph's (k, k, C, 1) layout),
    bit-identical; always K2."""
    k = w.shape[0]
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else \
        tuple(wpad)
    return qdwconv(x, w.reshape(k, w.shape[1], x.shape[-1]), stride=stride,
                   mult=mult, zp_in=zp_in, zp_out=zp_out, hpad=hp, wpad=wp,
                   out=out)


__all__ = ["qconv1x1", "qconv", "qdwconv", "qconv_fused", "qdwconv_fused",
           "KERNEL_WRAPPERS"]
