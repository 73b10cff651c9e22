"""The numpy expression that the client edge's host quantize
(``repro_torch.kernels.host_quant``) replaced: the oracle that
``test_torch_host_quantize.py`` holds the kernel to, and what
``tools/host_quant_times.py`` times it against.  It imports numpy alone,
so it runs on a host without the JAX package."""
import numpy as np


def numpy_quantize(x, scale, zero_point):
    """``clip(round(float32(x) / float32(scale)) + zero_point)`` as int8,
    in five numpy passes."""
    q = np.round(np.asarray(x, np.float32) / np.float32(scale))
    return np.clip(q + zero_point, -128, 127).astype(np.int8)
