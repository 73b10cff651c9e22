"""The host kernels' sources (``csrc/*.cpp``) and the C signatures of
their entry points; ``kernels/build.py`` builds them with the host's C++
compiler and loads them."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import KernelSet

HOST_QUANT = KernelSet(Path(__file__).resolve().parent / "csrc", {
    # x (float32), q (int8), elements, scale, zero point
    "quantize_int8": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_int],
})

__all__ = ["HOST_QUANT"]
