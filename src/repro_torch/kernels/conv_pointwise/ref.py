"""Plain PyTorch version of the float32 pointwise conv kernel K6.

``x.reshape(-1, Cin) @ w``, plus the bias, then the ReLU — the reference's
``conv_pointwise/ref.py:conv1x1_ref`` — with TF32 switched off around the
product, so that on the card (where ``chip_smoke.py`` holds K6 against
this) the plain version is full float32.  The kernel wrapper in ``ops.py``
calls this for tensors on the CPU.  Tensors are NHWC with an optional
leading batch dimension.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """Float32 matrix products in full float32 on the card (TF32 off),
    restoring the caller's setting afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def conv1x1_ref(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                relu: bool = True) -> torch.Tensor:
    """K6's function: x [..., H, W, Cin]; w [Cin, Cout]; b [Cout] or None
    -> [..., H, W, Cout] in x's dtype."""
    cin = x.shape[-1]
    with full_f32_matmul():
        y = x.reshape(-1, cin).to(torch.float32) @ w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)[None, :]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


__all__ = ["conv1x1_ref", "full_f32_matmul"]
