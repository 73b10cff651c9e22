"""The plain versions of the int8 conv kernels K1–K3 (``repro_torch.
kernels.conv_quant.ref``) and their wrappers, against the JAX package's
q-op semantics ``cnn_ops.qconv2d``/``qdwconv2d`` — bit-exact on every
shape of ``tests/test_qkernels.py``'s grids plus explicit width pads, a
batch of three lanes and multipliers that land on exact .5 ties.  K1 is
also held against ``qconv1x1_pallas`` in interpret mode.  (The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds them
against these same plain versions there.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.cnn_ops import qconv2d as jax_qconv2d
from repro.graphs.cnn_ops import qdwconv2d as jax_qdwconv2d
from repro.kernels.conv_quant.kernel import qconv1x1_pallas

from repro_torch.kernels.conv_quant import ops, ref
from repro_torch.kernels.conv_quant.ops import qconv_fused, qdwconv_fused

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)


def qrand(rng, shape):
    return rng.integers(-128, 128, size=shape, dtype=np.int8)


_QP = dict(mult=0.0123, zp_in=3, zp_out=-5)
# mult 0.5: every odd accumulator lands on an exact .5 before rounding
_TIE = dict(mult=0.5, zp_in=-2, zp_out=4)

# test_qkernels.py's grids (every case, the slow-tier ones included — they
# are tiny) plus explicit width pads as 2-D tile clones carry them
_CONV_GRID = [
    # H, W, Cin, Cout, k, stride, hpad, wpad
    (12, 12, 8, 16, 1, 1, None, None),
    (11, 9, 4, 6, 3, 2, None, None),
    (7, 9, 1, 5, 3, 1, None, None),
    (10, 8, 3, 7, 3, 1, (0, 2), None),
    (9, 7, 5, 1, 3, 2, (2, 0), None),
    (8, 8, 3, 4, 5, 2, None, None),
    (10, 9, 3, 6, 3, 1, (1, 1), (0, 2)),
    (9, 10, 4, 3, 3, 2, (0, 1), (2, 0)),
    (6, 7, 5, 4, 1, 1, (0, 0), (1, 0)),    # padded 1x1: goes to K3
]

_DW_GRID = [
    # H, W, C, k, stride, hpad, wpad
    (11, 9, 8, 3, 1, None, None),
    (12, 10, 6, 3, 2, None, None),
    (9, 7, 1, 3, 1, None, None),
    (10, 8, 5, 3, 1, (2, 0), None),
    (9, 9, 4, 3, 2, (0, 2), None),
    (10, 9, 6, 3, 1, (1, 1), (2, 0)),
    (8, 11, 3, 3, 2, (0, 1), (0, 2)),
]


def _jax(fn, x, w, stride, qp, hpad, wpad):
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(w), stride, qp["mult"],
                         qp["zp_in"], qp["zp_out"], hpad=hpad, wpad=wpad))


@pytest.mark.parametrize("qp", [_QP, _TIE], ids=["frac", "ties"])
@pytest.mark.parametrize("H,W,Cin,Cout,k,stride,hpad,wpad", _CONV_GRID)
def test_qconv_plain_bit_identical(H, W, Cin, Cout, k, stride, hpad, wpad,
                                   qp):
    rng = np.random.default_rng(11)
    x = qrand(rng, (H, W, Cin))
    w = qrand(rng, (k, k, Cin, Cout))
    want = _jax(jax_qconv2d, x, w, stride, qp, hpad, wpad)
    got = qconv_fused(torch.as_tensor(x), torch.as_tensor(w), stride=stride,
                      hpad=hpad, wpad=wpad, **qp)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("qp", [_QP, _TIE], ids=["frac", "ties"])
@pytest.mark.parametrize("H,W,C,k,stride,hpad,wpad", _DW_GRID)
def test_qdwconv_plain_bit_identical(H, W, C, k, stride, hpad, wpad, qp):
    rng = np.random.default_rng(13)
    x = qrand(rng, (H, W, C))
    w = qrand(rng, (k, k, C, 1))
    want = _jax(jax_qdwconv2d, x, w, stride, qp, hpad, wpad)
    got = qdwconv_fused(torch.as_tensor(x), torch.as_tensor(w),
                        stride=stride, hpad=hpad, wpad=wpad, **qp)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_of_three_lanes_equals_three_calls():
    """A leading batch dimension is B independent lanes: each lane equals
    the reference on that lane alone (one launch per op on the card)."""
    rng = np.random.default_rng(5)
    xs = qrand(rng, (3, 10, 9, 4))
    w3 = qrand(rng, (3, 3, 4, 6))
    w1 = qrand(rng, (1, 1, 4, 6))
    wd = qrand(rng, (3, 3, 4, 1))
    got3 = qconv_fused(torch.as_tensor(xs), torch.as_tensor(w3), stride=2,
                       **_QP).numpy()
    got1 = qconv_fused(torch.as_tensor(xs), torch.as_tensor(w1), stride=1,
                       **_QP).numpy()
    gotd = qdwconv_fused(torch.as_tensor(xs), torch.as_tensor(wd), stride=1,
                         hpad=(0, 2), **_QP).numpy()
    for b in range(3):
        np.testing.assert_array_equal(
            got3[b], _jax(jax_qconv2d, xs[b], w3, 2, _QP, None, None))
        np.testing.assert_array_equal(
            got1[b], _jax(jax_qconv2d, xs[b], w1, 1, _QP, None, None))
        np.testing.assert_array_equal(
            gotd[b], _jax(jax_qdwconv2d, xs[b], wd, 1, _QP, (0, 2), None))


@pytest.mark.parametrize("M_h,M_w,Cin,Cout", [(12, 12, 8, 16), (5, 7, 3, 1),
                                               (4, 4, 1, 3)])
def test_k1_plain_matches_pallas_interpret(M_h, M_w, Cin, Cout):
    """K1's plain version against the Pallas kernel itself (interpret
    mode; the 1x1 kernel still runs on this jax)."""
    rng = np.random.default_rng(3)
    x = qrand(rng, (M_h, M_w, Cin))
    w = qrand(rng, (Cin, Cout))
    for qp in (_QP, _TIE):
        want = np.asarray(qconv1x1_pallas(
            jnp.asarray(x), jnp.asarray(w), block_rows=40, interpret=True,
            **qp))
        got = ref.qconv1x1_ref(torch.as_tensor(x), torch.as_tensor(w), **qp)
        np.testing.assert_array_equal(got.numpy(), want)


def test_requant_saturates_both_rails():
    """Extreme multiplier: outputs pin to [zp_out, 127], never wrap."""
    rng = np.random.default_rng(17)
    x = qrand(rng, (6, 6, 4))
    w = qrand(rng, (3, 3, 4, 8))
    qp = dict(mult=1.0, zp_in=0, zp_out=-5)
    got = qconv_fused(torch.as_tensor(x), torch.as_tensor(w), stride=1,
                      **qp).numpy()
    np.testing.assert_array_equal(got, _jax(jax_qconv2d, x, w, 1, qp, None,
                                            None))
    assert (got == -5).any() and (got == 127).any()


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    before = {n: f.launches for n, f in ops.KERNEL_WRAPPERS.items()}
    rng = np.random.default_rng(1)
    x = torch.as_tensor(qrand(rng, (2, 6, 6, 4)))
    out = torch.empty((2, 6, 6, 5), dtype=torch.int8)
    got = ops.qconv1x1(x, torch.as_tensor(qrand(rng, (4, 5))), out=out,
                       **_QP)
    assert got is out            # written in place into the given view
    ops.qconv(x, torch.as_tensor(qrand(rng, (3, 3, 4, 5))), stride=1,
              hpad=(1, 1), wpad=(1, 1), **_QP)
    ops.qdwconv(x, torch.as_tensor(qrand(rng, (3, 3, 4))), stride=2,
                hpad=(0, 1), wpad=(0, 1), **_QP)
    assert {n: f.launches for n, f in ops.KERNEL_WRAPPERS.items()} == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(qrand(rng, (6, 6, 4)))
    with pytest.raises(TypeError, match="int8"):
        ops.qconv1x1(x.float(), torch.as_tensor(qrand(rng, (4, 5))), **_QP)
    with pytest.raises(ValueError, match="Cin"):
        ops.qconv1x1(x, torch.as_tensor(qrand(rng, (3, 5))), **_QP)
    with pytest.raises(ValueError, match="contiguous"):
        ops.qdwconv(x.transpose(0, 1), torch.as_tensor(qrand(rng, (3, 3, 4))),
                    stride=1, hpad=(1, 1), wpad=(1, 1), **_QP)
    # a tensor on neither the CPU nor a card is refused, never computed
    before = ops.qconv.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.qconv(x.to("meta"), torch.as_tensor(qrand(rng, (3, 3, 4, 2))),
                  stride=1, hpad=(1, 1), wpad=(1, 1), **_QP)
    assert ops.qconv.launches == before
