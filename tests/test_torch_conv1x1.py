"""The plain version of the float32 pointwise conv kernel K6
(``repro_torch.kernels.conv_pointwise``) and its wrapper, against the JAX
package's ``conv1x1_fused`` in interpret mode and its pure-jnp
``conv1x1_ref``, at the tolerance of ``tests/test_kernels.py`` (the two
sum in other orders; float32, no TF32).  The CUDA kernel itself runs only
on the card: ``chip_smoke.py`` holds it against this plain version
there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv1x1_fused as jax_conv1x1_fused
from repro.kernels.conv_pointwise.ref import conv1x1_ref as jax_conv1x1_ref

import repro_torch.kernels as kernels
from repro_torch.kernels.conv_pointwise import ops, ref

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

_TOL = dict(rtol=2e-5, atol=1e-6)

_SHAPES = [
    (12, 12, 64, 128),      # MCU-shaped
    (7, 9, 3, 8),           # ragged: M = 63
    (5, 6, 10, 2),          # Cout = 2, as SwiftNet's thinnest branch
]


def _inputs(h, w, cin, cout, bias, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32) if bias else None
    return x, wt, b


@pytest.mark.parametrize("h,w,cin,cout", _SHAPES)
@pytest.mark.parametrize("bias,relu", [(True, True), (False, False)])
def test_plain_matches_the_reference(h, w, cin, cout, bias, relu):
    x, wt, b = _inputs(h, w, cin, cout, bias)
    got = ref.conv1x1_ref(torch.as_tensor(x), torch.as_tensor(wt),
                          None if b is None else torch.as_tensor(b),
                          relu=relu).numpy()
    jb = None if b is None else jnp.asarray(b)
    kernel = np.asarray(jax_conv1x1_fused(jnp.asarray(x), jnp.asarray(wt), jb,
                                          relu=relu, interpret=True))
    plain = np.asarray(jax_conv1x1_ref(jnp.asarray(x), jnp.asarray(wt), jb,
                                       relu=relu))
    assert got.dtype == np.float32 and got.shape == (h, w, cout)
    np.testing.assert_allclose(got, kernel, **_TOL)
    np.testing.assert_allclose(got, plain, **_TOL)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_rejects_integer_input(dtype):
    """An integer input would be truncated, not requantized: refused, with
    the int8 kernels named, as the reference does."""
    x = torch.zeros((4, 4, 8), dtype=dtype)
    w = torch.zeros((8, 8), dtype=torch.float32)
    with pytest.raises(TypeError, match="qconv_fused"):
        ops.conv1x1(x, w)
    with pytest.raises(TypeError, match="qconv_fused"):
        kernels.conv1x1_fused(x, w)


def test_wrapper_writes_strided_lanes_in_place():
    """Two lanes in an arena-like buffer whose lane pitch is a multiple of
    4 bytes but not of 16: the wrapper writes each lane's result into the
    ``out`` view, and each lane equals its own one-lane call."""
    h, w, cin, cout = 7, 9, 3, 8
    rng = np.random.default_rng(11)
    n_in, n_out = h * w * cin, h * w * cout
    buf = torch.as_tensor(rng.standard_normal((2, n_in + n_out + 5))
                          .astype(np.float32))
    x = buf[:, 1:1 + n_in].view(2, h, w, cin)
    out = buf[:, 1 + n_in:1 + n_in + n_out].view(2, h, w, cout)
    assert buf.stride(0) * 4 % 16 != 0
    wt = torch.as_tensor((rng.standard_normal((cin, cout)) * 0.1)
                         .astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((cout,)).astype(np.float32))
    before = buf.clone()
    got = kernels.conv1x1_fused(x, wt, b, relu=True, out=out)
    assert got is out
    for lane in range(2):
        want = ref.conv1x1_ref(x[lane].clone(), wt, b, relu=True)
        np.testing.assert_array_equal(out[lane].numpy(), want.numpy())
    # nothing outside the two output views moved
    mask = torch.ones_like(buf, dtype=torch.bool)
    mask[:, 1 + n_in:1 + n_in + n_out] = False
    assert torch.equal(buf[mask], before[mask])


def test_wrapper_checks_shapes():
    x = torch.zeros((4, 4, 8))
    with pytest.raises(ValueError, match="Cin=8"):
        ops.conv1x1(x, torch.zeros((7, 2)))
    with pytest.raises(ValueError, match="Cout=2"):
        ops.conv1x1(x, torch.zeros((8, 2)), torch.zeros((3,)))
    assert ops.conv1x1_fused is ops.conv1x1
    assert ops.KERNEL_WRAPPERS == {"conv1x1": ops.conv1x1}
