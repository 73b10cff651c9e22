"""The plain versions of the fused conv -> add kernels K4/K5
(``repro_torch.kernels.conv_quant.ref.qconv1x1_add_ref``/``qconv_add_ref``)
and their wrappers, bit-exact against the JAX package: K4 against
``qconv1x1_add_pallas`` in interpret mode, K5 against the q-op chain
``qconv2d -> qadd`` (its Pallas body needs ``pl.load``, which jax 0.9 no
longer has — ROADMAP R1).  Odd H/W, stride 2, asymmetric pads, add params
that saturate both rails, negative accumulators, several lanes, and
``qconv_add_fused``'s routing.  The CUDA kernels run only on the card:
``chip_smoke.py`` holds them against these there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.cnn_ops import qadd as jax_qadd
from repro.graphs.cnn_ops import qconv2d as jax_qconv2d
from repro.kernels.conv_quant.kernel import qconv1x1_add_pallas

import repro_torch.kernels as kernels
from repro_torch.kernels.conv_quant import ops, ref

from test_torch_qconv import SPLITK_SHAPES, splitk_emulation, strided_lanes

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

_QP = dict(mult=0.0123, zp_in=3, zp_out=-5)
# (mult_a, mult_b, zp_a, zp_b, zp_out) in qadd order; leg a is the conv
ADD_PARAMS = {
    "plain": (0.71, 0.39, -5, 2, -7),
    # |sum| far beyond int8 both ways: both rails saturate
    "saturating": (23.5, 17.25, 60, 0, 100),
    # a negative multiplier: most accumulators are negative, with ties
    "negative": (0.5, -0.75, 9, -3, 1),
}


def qrand(rng, shape):
    return rng.integers(-128, 128, size=shape, dtype=np.int8)


@pytest.mark.parametrize("h,w,cin,cout", [(12, 12, 8, 16), (7, 9, 5, 3),
                                          (1, 3, 4, 1)])
@pytest.mark.parametrize("addp", sorted(ADD_PARAMS))
def test_k4_plain_matches_the_pallas_kernel(h, w, cin, cout, addp):
    rng = np.random.default_rng(7)
    x, wt = qrand(rng, (h, w, cin)), qrand(rng, (cin, cout))
    r = qrand(rng, (h, w, cout))
    p = ADD_PARAMS[addp]
    want = np.asarray(qconv1x1_add_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(r), add_params=p,
        block_rows=16, interpret=True, **_QP))
    got = ref.qconv1x1_add_ref(torch.as_tensor(x), torch.as_tensor(wt),
                               torch.as_tensor(r), add_params=p, **_QP)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if addp == "saturating":
        assert {-128, 127} <= set(np.unique(want).tolist())


_CONV_GRID = [
    # H, W, Cin, Cout, k, stride, hpad, wpad
    (11, 9, 4, 6, 3, 2, None, None),        # odd shape, stride 2
    (10, 8, 3, 7, 3, 1, (0, 2), None),      # Pex mid-slice pads
    (9, 7, 5, 1, 3, 2, (2, 0), None),       # 1-lane Cout, top halo
    (10, 9, 3, 6, 3, 1, (1, 1), (0, 2)),    # 2-D tile: width pads too
    (6, 7, 5, 4, 1, 1, (0, 0), (1, 0)),     # padded 1x1: K5, not K4
]


@pytest.mark.parametrize("h,w,cin,cout,k,stride,hpad,wpad", _CONV_GRID)
@pytest.mark.parametrize("addp", sorted(ADD_PARAMS))
def test_k5_plain_matches_the_qop_chain(h, w, cin, cout, k, stride, hpad,
                                        wpad, addp):
    rng = np.random.default_rng(8)
    x, wt = qrand(rng, (h, w, cin)), qrand(rng, (k, k, cin, cout))
    conv = np.asarray(jax_qconv2d(jnp.asarray(x), jnp.asarray(wt), stride,
                                  hpad=hpad, wpad=wpad, **_QP))
    r = qrand(rng, conv.shape)
    p = ADD_PARAMS[addp]
    want = np.asarray(jax_qadd(jnp.asarray(conv), jnp.asarray(r), *p))
    got = kernels.qconv_add_fused(torch.as_tensor(x), torch.as_tensor(wt),
                                  torch.as_tensor(r), stride=stride,
                                  hpad=hpad, wpad=wpad, add_params=p, **_QP)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_routing_and_lanes(monkeypatch):
    """1x1 / stride 1 / no pads goes to K4, everything else to K5 — and a
    three-lane call equals three one-lane calls, written into strided
    ``out`` views."""
    calls = []
    for name in ("qconv1x1_add", "qconv_add"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    rng = np.random.default_rng(9)
    p = ADD_PARAMS["plain"]
    x = torch.as_tensor(qrand(rng, (3, 8, 6, 4)))
    w1 = torch.as_tensor(qrand(rng, (1, 1, 4, 5)))
    w3 = torch.as_tensor(qrand(rng, (3, 3, 4, 5)))
    for wt, stride, hpad, want in ((w1, 1, None, "qconv1x1_add"),
                                   (w1, 1, (0, 0), "qconv1x1_add"),
                                   (w1, 2, None, "qconv_add"),
                                   (w3, 1, None, "qconv_add")):
        oh, ow = -(-8 // stride), -(-6 // stride)
        r = torch.as_tensor(qrand(rng, (3, oh, ow, 5)))
        buf = torch.zeros((3, oh * ow * 5 + 3), dtype=torch.int8)
        out = buf[:, 3:].view(3, oh, ow, 5)
        calls.clear()
        got = ops.qconv_add_fused(x, wt, r, stride=stride, hpad=hpad,
                                  add_params=p, out=out, **_QP)
        assert calls == [want] and got is out
        for lane in range(3):
            one = ops.qconv_add_fused(x[lane], wt, r[lane], stride=stride,
                                      hpad=hpad, add_params=p, **_QP)
            assert torch.equal(out[lane], one)


def test_wrappers_check_inputs():
    x = torch.zeros((4, 4, 8), dtype=torch.int8)
    w = torch.zeros((1, 1, 8, 2), dtype=torch.int8)
    r = torch.zeros((4, 4, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="expected"):
        kernels.qconv_add_fused(x, w, r[:3], stride=1,
                                add_params=ADD_PARAMS["plain"], **_QP)
    with pytest.raises(TypeError, match="r must be an int8"):
        kernels.qconv_add_fused(x, w, r.float(), stride=1,
                                add_params=ADD_PARAMS["plain"], **_QP)
    with pytest.raises(ValueError, match="too large"):
        kernels.qconv_add_fused(x, w, r, stride=1,
                                add_params=(100.0, 100.0, 0, 0, 0), **_QP)
    assert set(ops.KERNEL_WRAPPERS) == {"qconv1x1", "qdwconv", "qconv",
                                        "qconv1x1_add", "qconv_add", "qadd",
                                        "qscale"}


@pytest.mark.parametrize("zp_in", [-128, 0, 127])
@pytest.mark.parametrize("H,W,Cin,Cout,lanes", SPLITK_SHAPES)
def test_k4_split_k_arithmetic_is_bit_exact(H, W, Cin, Cout, lanes, zp_in):
    """K4 shares K1's split-K body: the chunked int32 product minus
    zp_in · Σw, then the requantize and fixed-point add epilogue, equals
    ``qconv1x1_add_ref`` bit for bit (132-SM and 1-SM plans)."""
    rng = np.random.default_rng(Cin * 5 + Cout + lanes + zp_in + 128)
    x = strided_lanes(rng, lanes, (H, W, Cin))
    w = torch.as_tensor(qrand(rng, (Cin, Cout)))
    r = strided_lanes(rng, lanes, (H, W, Cout))
    qp = dict(mult=0.003 / np.sqrt(Cin), zp_in=zp_in, zp_out=-3)
    addp = ADD_PARAMS[("plain", "saturating", "negative")[(zp_in + 128) % 3]]
    want = ref.qconv1x1_add_ref(x, w, r, add_params=addp, **qp)
    assert torch.equal(ops.qconv1x1_add(x, w, r, add_params=addp, **qp),
                       want)
    for sms in (132, 1):
        got = ref.qadd(splitk_emulation(x, w, sms=sms, **qp), r, *addp)
        assert torch.equal(got, want)
