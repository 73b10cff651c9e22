"""The activation's int8 clamp pair ``[lo, hi]`` in the plain versions of
K1–K5, the residual add K9's plain version, and the graphs that leave
``act`` out.

K1–K5 are held against the JAX package for a ReLU (``lo = zp_out``) and a
linear conv (``lo = -128``): K1 and K4 against ``qconv1x1_pallas`` /
``qconv1x1_add_pallas`` in interpret mode, K2, K3 and K5 against the q-ops
``qdwconv2d`` / ``qconv2d`` (then ``qadd``) with their requantize's lower
clamp at ``lo``, as the TPU kernels' ``_requant`` takes it (their windowed
Pallas bodies need ``pl.load``, which jax 0.9 no longer has).  The TPU
kernels carry no ceiling, so a ReLU6 whose range is set wider than 6 (its
ceiling binds inside the grid) is held to the JAX ReLU output clipped at
``hi``.  K9's plain version is ``ref.qadd`` over lanes that lie apart,
written in place.  (The CUDA kernels run only on the card:
``chip_smoke.py`` holds them against these plain versions there.)"""
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.cnn_ops as jax_ops
from repro.kernels.conv_quant.kernel import (qconv1x1_add_pallas,
                                             qconv1x1_pallas)

from repro_torch.core.heuristics import schedule
from repro_torch.graphs import (figure1_executable_graph, mobilenet_v1_graph,
                                swiftnet_cell_graph)
from repro_torch.graphs import cnn_ops
from repro_torch.graphs.quantize import (QParams, activation_qparams,
                                         int8_clamp, int8_scheduling_graph,
                                         quantize_graph)
from repro_torch.kernels.conv_quant import ops, ref
from repro_torch.kernels.conv_quant.ops import (RingWindow, qconv_add_fused,
                                                qconv_fused, qdwconv_fused)

torch.set_num_threads(1)

ZP_OUT, MULT, ZP_IN = -20, 0.0173, 5
# ReLU6 at a scale of 6 / 40: its ceiling is zp_out + 40, well inside the
# grid, so the clamp binds where a ReLU's would not
CLAMPS = {"relu": int8_clamp("relu", QParams(0.05, ZP_OUT)),
          "relu6": int8_clamp("relu6", QParams(6.0 / 40, ZP_OUT)),
          "none": int8_clamp("none", QParams(0.05, ZP_OUT))}
ADD = (0.7, 1.3, ZP_OUT, 9, -3)       # mult_a, mult_b, zp_a, zp_b, zp_out


def _q(gen, shape):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)


def test_clamp_pairs_are_tflites():
    assert CLAMPS == {"relu": (ZP_OUT, 127), "relu6": (ZP_OUT, ZP_OUT + 40),
                      "none": (-128, 127)}
    # a ReLU6 whose range reached 6.0 exactly: the ceiling is the grid's
    assert int8_clamp("relu6", QParams(6.0 / 255, -128)) == (-128, 127)
    # a ReLU6 tensor calibrated all zero: scale 1.0, the ceiling is real 6
    assert int8_clamp("relu6", activation_qparams(0.0, 0.0)) == (-128, -122)
    with pytest.raises(ValueError):
        int8_clamp("gelu", QParams(1.0, 0))
    with pytest.raises(ValueError):
        ref.clamp_pair(0, 5, 4)


def _jax_q(fn, x, w, stride, mult, lo, hi):
    """The JAX q-op ``fn`` lane by lane with its requantize's lower clamp
    at ``lo``, clipped at ``hi``."""
    base = jax_ops.requantize

    def requantize(acc, mult, zp_out, lo=None, _lo=lo):
        return base(acc, mult, zp_out, lo=_lo)
    with mock.patch.object(jax_ops, "requantize", requantize):
        out = [np.asarray(fn(jnp.asarray(xi.numpy()), jnp.asarray(w.numpy()),
                             stride, mult, ZP_IN, ZP_OUT)) for xi in x]
    return torch.from_numpy(np.stack(out)).clamp(max=hi)


def _jax_add(y, r):
    return torch.from_numpy(np.stack([np.asarray(jax_ops.qadd(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), *ADD))
        for a, b in zip(y, r)]))


# H, W, Cin, Cout, k, stride: 1x1 stride 1 (K1/K4) and 3x3 stride 2 (K3/K5)
CONVS = [(6, 5, 16, 24, 1, 1), (9, 7, 8, 12, 3, 2)]


@pytest.mark.parametrize("act", list(CLAMPS))
@pytest.mark.parametrize("shape", CONVS)
def test_conv_plain_paths_clamp_to_the_pair(act, shape):
    """K1/K3 (``qconv_fused``) against the JAX package: the 1x1 also
    against ``qconv1x1_pallas``; a ReLU6 is the linear output clipped to
    ``[lo, hi]``."""
    h, w, cin, cout, k, stride = shape
    gen = torch.Generator().manual_seed(h * 7 + k)
    x, wq = _q(gen, (2, h, w, cin)), _q(gen, (k, k, cin, cout))
    lo, hi = CLAMPS[act]
    got = qconv_fused(x, wq, stride=stride, mult=MULT, zp_in=ZP_IN,
                      zp_out=ZP_OUT, lo=lo, hi=hi)
    want = _jax_q(jax_ops.qconv2d, x, wq, stride, MULT, lo, hi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    linear = _jax_q(jax_ops.qconv2d, x, wq, stride, MULT, -128, 127)
    torch.testing.assert_close(got, linear.clamp(lo, hi), rtol=0, atol=0)
    if k == 1 and act != "relu6":
        pallas = np.stack([np.asarray(qconv1x1_pallas(
            jnp.asarray(xi.numpy()), jnp.asarray(wq[0, 0].numpy()),
            mult=MULT, zp_in=ZP_IN, zp_out=ZP_OUT, lo=lo, block_rows=16,
            interpret=True)) for xi in x])
        np.testing.assert_array_equal(got.numpy(), pallas)
    if act == "relu6":
        assert (got == hi).any() and (linear > hi).any()
    if act == "none":
        assert (got < ZP_OUT).any()


@pytest.mark.parametrize("act", list(CLAMPS))
def test_depthwise_plain_path_clamps_to_the_pair(act):
    """K2, whole against the JAX package's ``qdwconv2d``, and on a ring
    window against itself gathered."""
    gen = torch.Generator().manual_seed(3)
    x, wq = _q(gen, (2, 10, 9, 16)), _q(gen, (3, 3, 16, 1))
    lo, hi = CLAMPS[act]
    got = qdwconv_fused(x, wq, stride=1, mult=0.05, zp_in=ZP_IN,
                        zp_out=ZP_OUT, lo=lo, hi=hi)
    want = _jax_q(jax_ops.qdwconv2d, x, wq, 1, 0.05, lo, hi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    linear = _jax_q(jax_ops.qdwconv2d, x, wq, 1, 0.05, -128, 127)
    torch.testing.assert_close(got, linear.clamp(lo, hi), rtol=0, atol=0)
    if act == "relu6":
        assert (got == hi).any() and (linear > hi).any()
    # a ring window of 4 rows from ring row 8 of 10, in place and gathered
    win = RingWindow(x, 8, 4)
    kw = dict(stride=1, mult=0.05, zp_in=ZP_IN, zp_out=ZP_OUT,
              hpad=(1, 1), wpad=(1, 1), lo=lo, hi=hi)
    torch.testing.assert_close(
        ops.qdwconv(x, wq.reshape(3, 3, 16), src=8, n=4, **kw),
        ops.qdwconv(win.gather(), wq.reshape(3, 3, 16), **kw),
        rtol=0, atol=0)


@pytest.mark.parametrize("act", list(CLAMPS))
@pytest.mark.parametrize("shape", CONVS)
def test_fused_add_plain_paths_clamp_the_conv_leg(act, shape):
    """K4/K5: the conv leg clamped to ``[lo, hi]`` before the add, as the
    JAX package's ``qconv2d`` then ``qadd``; K4 also against
    ``qconv1x1_add_pallas``."""
    h, w, cin, cout, k, stride = shape
    gen = torch.Generator().manual_seed(h + k)
    x, wq = _q(gen, (3, h, w, cin)), _q(gen, (k, k, cin, cout))
    oh, ow = -(-h // stride), -(-w // stride)
    r = _q(gen, (3, oh, ow, cout))
    lo, hi = CLAMPS[act]
    got = qconv_add_fused(x, wq, r, stride=stride, mult=MULT, zp_in=ZP_IN,
                          zp_out=ZP_OUT, add_params=ADD, lo=lo, hi=hi)
    y = _jax_q(jax_ops.qconv2d, x, wq, stride, MULT, lo, hi)
    torch.testing.assert_close(got, _jax_add(y, r), rtol=0, atol=0)
    if k == 1 and act != "relu6":
        pallas = np.stack([np.asarray(qconv1x1_add_pallas(
            jnp.asarray(xi.numpy()), jnp.asarray(wq[0, 0].numpy()),
            jnp.asarray(ri.numpy()), mult=MULT, zp_in=ZP_IN, zp_out=ZP_OUT,
            add_params=ADD, lo=lo, block_rows=16, interpret=True))
            for xi, ri in zip(x, r)])
        np.testing.assert_array_equal(got.numpy(), pallas)


def _arena_views(gen, lanes, shape, pitch):
    """``lanes`` int8 blocks of ``shape``, each contiguous, ``pitch``
    bytes apart in one byte buffer (as arena views lie)."""
    n = int(np.prod(shape))
    buf = _q(gen, (lanes, pitch))
    return buf, buf[:, :n].view(lanes, *shape)


@pytest.mark.parametrize("shape", [(4, 5, 24), (3, 3, 7), (1, 1, 160)])
def test_k9_plain_path_is_qadd_over_lanes_apart(shape):
    """K9's wrapper on the CPU: ``ref.qadd`` over lanes that lie ``pitch``
    bytes apart, written into ``out`` where it lies; a leg may be the
    output's own bytes."""
    gen = torch.Generator().manual_seed(sum(shape))
    n = int(np.prod(shape))
    _, a = _arena_views(gen, 3, shape, n + 40)
    _, b = _arena_views(gen, 3, shape, n + 8)
    buf, out = _arena_views(gen, 3, shape, n + 24)
    tail = buf[:, n:].clone()
    want = ref.qadd(a, b, *ADD)
    got = ops.qadd(a, b, mult_a=ADD[0], mult_b=ADD[1], zp_a=ADD[2],
                   zp_b=ADD[3], zp_out=ADD[4], out=out)
    assert got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(buf[:, n:], tail, rtol=0, atol=0)
    again = ops.qadd(out, b, mult_a=ADD[0], mult_b=ADD[1], zp_a=ADD[2],
                     zp_b=ADD[3], zp_out=ADD[4], out=out)
    torch.testing.assert_close(again, ref.qadd(want, b, *ADD), rtol=0,
                               atol=0)
    assert ops.qadd.launches == 0        # the plain version launches nothing


def test_k9_refuses_what_it_cannot_add():
    a = torch.zeros((2, 3, 4, 8), dtype=torch.int8)
    kw = dict(mult_a=0.5, mult_b=0.5, zp_a=0, zp_b=0, zp_out=0)
    with pytest.raises(ValueError, match="expected"):
        ops.qadd(a, a[:, :2], **kw)
    with pytest.raises(TypeError, match="b must be an int8"):
        ops.qadd(a, a.float(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.qadd(a[:, :, ::2], a[:, :, ::2], **kw)
    with pytest.raises(ValueError, match="too large"):
        ops.qadd(a, a, **{**kw, "mult_a": 100.0, "mult_b": 100.0})
    assert ops.KERNEL_WRAPPERS["qadd"] is ops.qadd


def test_the_add_lowering_gathers_a_ring_window_leg():
    """A cascade that handed the add a ring window: the lowering gathers it
    and adds the window's rows."""
    gen = torch.Generator().manual_seed(5)
    ring, other = _q(gen, (2, 6, 4, 8)), _q(gen, (2, 3, 4, 8))
    op = types.SimpleNamespace(attrs=dict(
        mult_a=ADD[0], mult_b=ADD[1], zp_a=ADD[2], zp_b=ADD[3],
        zp_out=ADD[4]))
    win = RingWindow(ring, 5, 3)
    got = cnn_ops._lower_qadd(None, op, win, other, out=None)
    torch.testing.assert_close(got, ref.qadd(win.gather(), other, *ADD),
                               rtol=0, atol=0)


def _without_act(g):
    """``g`` as ``CNNBuilder`` made it before activations were named: no
    ``act`` attribute, every op's semantics rebuilt from what is left."""
    for op in g.operators:
        if "act" in op.attrs:
            del op.attrs["act"]
            op.fn = cnn_ops.op_semantics(op.kind, op.attrs)
    return g


@pytest.mark.parametrize("make", [
    lambda: mobilenet_v1_graph(0.25, 96), swiftnet_cell_graph,
    figure1_executable_graph])
def test_graphs_that_leave_act_out_are_unchanged(make):
    """Every conv of the existing graphs is a ReLU; their schedules and
    arenas (reorder only, and under a budget that needs slices) are those
    of the same graph without the attribute, and their int8 rewrite
    clamps at ``[zp_out, 127]`` with the same answers."""
    g, bare = make(), _without_act(make())
    convs = [op for op in g.operators if op.kind in ("conv", "dwconv")]
    assert all(op.attrs["act"] == "relu" for op in convs)
    s8, b8 = int8_scheduling_graph(g), int8_scheduling_graph(bare)
    whole = schedule(s8)
    for budget in (None, int(whole.peak * 0.8)):
        a, b = schedule(s8, arena_budget=budget), \
            schedule(b8, arena_budget=budget)
        assert (a.peak, a.method) == (b.peak, b.method)
        assert [op.name for op in a.schedule] == \
            [op.name for op in b.schedule]
    if not convs or g.tensors["input"].dtype != "float32":
        return
    from repro_torch.graphs import random_input
    x = random_input(g)
    qg, qb = quantize_graph(g, x, device="cpu"), \
        quantize_graph(bare, x, device="cpu")
    for op in qg.graph.operators:
        if op.kind in ("qconv", "qdwconv"):
            assert (op.attrs["lo"], op.attrs["hi"]) == \
                (op.attrs["zp_out"], 127)
    xq = {k: torch.as_tensor(v) for k, v in qg.quantize_inputs(x).items()}
    for qm in (qg, qb):
        vals = dict(xq)
        for op in qm.graph.default_schedule():
            vals[op.output] = op.fn(*[vals[i] for i in op.inputs])
        qm.answer = vals[qm.graph.outputs[0]]
    torch.testing.assert_close(qg.answer, qb.answer, rtol=0, atol=0)


def test_mobilenet_v1_takes_the_heads_width():
    assert mobilenet_v1_graph(0.25, 96).tensors[
        mobilenet_v1_graph(0.25, 96).outputs[0]].shape == (1, 1, 2)
    g = mobilenet_v1_graph(0.25, 96, num_classes=1000)
    assert tuple(g.tensors[g.outputs[0]].shape) == (1, 1, 1000)
