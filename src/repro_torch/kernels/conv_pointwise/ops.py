"""Host wrapper of the float32 pointwise conv kernel K6, and
``conv1x1_fused``, the reference's name for it.

The device decides, not a knob (the reference's ``block_rows`` and
``interpret`` are gone): on a CUDA tensor the wrapper launches the Hopper
kernel or raises; on a CPU tensor it runs the plain version in ``ref.py``.
No path falls back from a failed build or launch to the plain version.

Tensors are NHWC with an optional leading batch dimension; one call over
``B`` lanes is one launch.  The kernel reads and writes arena views in
place: every lane's [H, W, C] block must be contiguous, and the lanes may
lie any number of elements apart (the batch stride is passed to the
kernel).  ``out`` (optional) is the destination view.  ``conv1x1.launches``
counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.conv_quant.ops import _lanes

from . import ref
from .build import CONV_POINTWISE


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None, *, relu: bool = True,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: x [..., H, W, Cin] float, w [Cin, Cout], b [Cout] or None ->
    [..., H, W, Cout]; the fused pointwise conv + bias + ReLU."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        # an integer input would be silently truncated instead of
        # requantized: int8 convs go through the fused int8 kernels
        raise TypeError(
            f"conv1x1 is the float kernel (got x dtype "
            f"{getattr(x, 'dtype', type(x))}); quantized convs route "
            f"through repro_torch.kernels.qconv_fused, which requantizes "
            f"exactly")
    lanes, x_bs = _lanes("x", x)
    h, wd, cin = x.shape[-3:]
    if w.dim() != 2 or w.shape[0] != cin:
        raise ValueError(f"w must be [Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    cout = w.shape[1]
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"b must be [Cout={cout}], got {tuple(b.shape)}")
    shape = (*x.shape[:-1], cout)
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"out is {tuple(out.shape)}, expected {shape}")
    if x.device.type == "cpu":
        y = ref.conv1x1_ref(x, w, b, relu=relu)
        if out is None:
            return y
        out.copy_(y)
        return out
    for name, t in (("x", x), ("w", w), ("b", b), ("out", out)):
        if t is not None and (t.dtype != torch.float32 or not t.is_cuda):
            raise ValueError(f"conv1x1: {name} must be a float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if not w.is_contiguous() or (b is not None and not b.is_contiguous()):
        raise ValueError("conv1x1: w and b must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    _, o_bs = _lanes("out", out)
    if out.numel():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        CONV_POINTWISE.launch(
            "conv1x1", ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(None if b is None else b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), lanes, h * wd, cin, cout, x_bs,
            o_bs, int(relu), x.device.index or 0, ctypes.c_void_p(stream))
        conv1x1.launches += 1
    return out


conv1x1.launches = 0
# the reference's public name (``repro.kernels.conv1x1_fused``)
conv1x1_fused = conv1x1
KERNEL_WRAPPERS = {"conv1x1": conv1x1}

__all__ = ["KERNEL_WRAPPERS", "conv1x1", "conv1x1_fused"]
