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


# ------------------------------------------------ K6's split-K arithmetic
H100_SMS = 132
# chip_smoke.py's per-element bound on K6: |got - want| <= F32_BOUND *
# (Cin + 2) * (sum_k |x_k w_k| + |b|), twice the worst-case error of a
# float32 dot product of Cin terms plus the bias add, in any order
F32_BOUND = 2 * 2.0 ** -24


def splitk_emulation(x, w, b, relu, sms):
    """K6's float32 arithmetic on the card (``csrc/conv1x1.cu``), in plain
    torch: for each chunk of Cin that ``ops.plan_split_k`` gives, the
    partial product in float32; the partials added in chunk order; then
    the bias and the ReLU."""
    h, wd, cin = x.shape[-3:]
    cout = w.shape[1]
    xl = x.reshape(-1, h * wd, cin)
    _, split, chunk = ops.plan_split_k(xl.shape[0], h * wd, cin, cout, sms)
    acc = torch.zeros((xl.shape[0], h * wd, cout), dtype=torch.float32)
    for s in range(split):
        acc = acc + torch.matmul(xl[..., s * chunk:(s + 1) * chunk],
                                 w[s * chunk:(s + 1) * chunk])
    if b is not None:
        acc = acc + b
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.reshape(*x.shape[:-1], cout), split


# (H, W, Cin, Cout, lanes): Cin 1, 3 and 1 030 (65 K-steps: a ragged last
# chunk), M 1 and M 36 with Cout 1 024, Cout 5 and 65, lanes at a pitch that
# is no multiple of 16 bytes
SPLITK_SHAPES = [(1, 1, 1, 5, 1), (7, 9, 3, 65, 3), (1, 1, 1030, 65, 1),
                 (6, 6, 1024, 1024, 1), (6, 6, 1030, 5, 3),
                 (3, 5, 1030, 65, 3), (12, 12, 512, 512, 1)]


@pytest.mark.parametrize("bias,relu", [(True, True), (False, False)])
@pytest.mark.parametrize("H,W,Cin,Cout,lanes", SPLITK_SHAPES)
def test_k6_split_k_sum_is_within_the_f32_bound(H, W, Cin, Cout, lanes,
                                                bias, relu):
    """Partials over the planner's chunks, added in chunk order, stay
    within chip_smoke.py's float32 bound of the plain version, with the
    plan of a 132-SM card and of one SM (split 1); at M 36 and Cin >= 1 024
    the 132-SM plan does split."""
    rng = np.random.default_rng(Cin * 7 + Cout + lanes)
    n = H * W * Cin
    buf = torch.as_tensor(rng.standard_normal((lanes, n + 3))
                          .astype(np.float32))
    x = buf[:, 1:1 + n].view(lanes, H, W, Cin)
    w = torch.as_tensor((rng.standard_normal((Cin, Cout)) * 0.1)
                        .astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((Cout,)).astype(np.float32)) \
        if bias else None
    want = ref.conv1x1_ref(x, w, b, relu=relu).double()
    mag = x.abs().double() @ w.abs().double()
    if b is not None:
        mag = mag + b.abs().double()
    bound = F32_BOUND * (Cin + 2) * mag
    for sms in (H100_SMS, 1):
        got, split = splitk_emulation(x, w, b, relu, sms)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(((got.double() - want).abs() <= bound).all()), sms
        if sms == 1:
            assert split == 1
    if H * W == 36 and Cin >= 1024:
        assert splitk_emulation(x, w, b, relu, H100_SMS)[1] > 1


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_k6_plan_covers_cin_once(lanes, sms):
    """The tile is one of TILE_ROWS; every chunk is a whole number of
    K-steps, the chunks cover [0, Cin) exactly once with none empty, the
    split is in [1, MAX_SPLIT].  The 64-row tile is taken, unsplit, when
    its tiles alone reach BIG_TILE_BLOCKS per SM; the 16-row tile is not
    split where its tiles reach SPLIT_BELOW_BLOCKS per SM or Cin spans
    under MIN_SPLIT_STEPS K-steps; a split keeps MIN_CHUNK_STEPS K-steps
    in every chunk but the last and stays within a factor 2 of what reaches
    SPLIT_TARGET_BLOCKS per SM (capped by MAX_SPLIT and the K-steps)."""
    step = ops.K_STEP
    for m in (1, 36, 144, 576, 2304, 9216):
        for cin in (1, 3, 15, 16, 17, 63, 64, 65, 512, 1024, 1030, 4096):
            for cout in (1, 5, 65, 1024):
                bm, split, chunk = ops.plan_split_k(lanes, m, cin, cout, sms)
                assert bm in ops.TILE_ROWS
                assert 1 <= split <= ops.MAX_SPLIT
                assert chunk > 0 and chunk % step == 0
                cover = np.zeros(cin, dtype=int)
                for s in range(split):
                    lo, hi = s * chunk, min(cin, (s + 1) * chunk)
                    assert lo < hi, (m, cin, cout, split, chunk)
                    cover[lo:hi] += 1
                assert (cover == 1).all()
                cols = -(-cout // ops.TILE_COLS)
                if lanes * -(-m // 64) * cols >= ops.BIG_TILE_BLOCKS * sms:
                    assert (bm, split) == (64, 1)
                    continue
                assert bm == 16
                steps = -(-cin // step)
                blocks = lanes * -(-m // bm) * cols
                if steps < ops.MIN_SPLIT_STEPS or \
                        blocks >= ops.SPLIT_BELOW_BLOCKS * sms:
                    assert split == 1
                    continue
                assert chunk >= step * ops.MIN_CHUNK_STEPS
                want = min(ops.MAX_SPLIT, steps // ops.MIN_CHUNK_STEPS,
                           -(-ops.SPLIT_TARGET_BLOCKS * sms // blocks))
                assert split <= want <= 2 * split
