"""The float32 -> int8 input quantize of an int8 deployment's client edge
(``QParams.quantize``, reached once a request through
``Deployment.quantize_inputs``), as one pass of a host kernel
(``csrc/quantize_int8.cpp``) in place of numpy's five: divide, round half
to even, add the zero point, clamp, cast.

The kernel reads the input as ``np.asarray(x, np.float32)`` gives it, made
contiguous, so a float64 or strided input is rounded to float32 first, as
numpy's expression rounds it; its output is bit-identical to that
expression's (the tests hold it so).  It is built at first use with the
host's C++ compiler (``kernels/build.py``); there is no numpy fallback.

``quantize_int8.calls`` and ``quantize_int8.elements`` count the calls and
the elements quantized, plain integers that only a call increments: read
them, as the kernel wrappers' ``launches``, as differences between two
reads.  The kernel runs on the host, so it is not among
``cuda_graphs.kernel_wrappers()``, whose launches are the card's.
"""
from __future__ import annotations

import numpy as np

from .build import HOST_QUANT


def quantize_int8(x, scale: float, zero_point: int) -> np.ndarray:
    """``clip(round(float32(x) / float32(scale)) + zero_point, -128, 127)``
    as int8, in ``x``'s shape."""
    x = np.asarray(x, np.float32)
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    q = np.empty(x.shape, np.int8)
    fn = HOST_QUANT.load("quantize_int8")
    fn(x.ctypes.data, q.ctypes.data, x.size, float(scale), int(zero_point))
    quantize_int8.calls += 1
    quantize_int8.elements += x.size
    return q


quantize_int8.calls = 0
quantize_int8.elements = 0

__all__ = ["quantize_int8"]
