"""MobileNetV2 on the port against its plain reference
(the benchmark's ``portbench/reference/mobilenet_v2.py``: whole tensors
in plain torch, nothing of the port), on the CPU at a small size (1.0 at 32x32, 10 classes; the 1-D
row-ring cascade at 0.35 at 128x128), on seeded He-normal weights and
images uniform in [-1, 1).

Covered: the graph is the reference's network layer for layer (Table 2 at
1.0@224: 17 blocks, 10 residual adds, 300.8 M multiply-accumulates); the
float outputs; the int8 parameters; the int8 answers bit for bit with no
budget, under a Pex budget, under the 2-D cascade and under the 1-D
cascade, with each rung's arena; and a fault the comparison must catch:
ReLU projections instead of linear ones.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import deploy
from repro_torch.graphs import mobilenet_v2_graph
from repro_torch.params import apply_params

REFERENCE = (Path(__file__).resolve().parents[1] / "portbench" / "reference"
             / "mobilenet_v2.py")
_spec = importlib.util.spec_from_file_location("plain_mobilenet_v2",
                                               REFERENCE)
plain = sys.modules["plain_mobilenet_v2"] = \
    importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

CLASSES = 10
KINDS = {"conv": ("conv", "pw"), "dwconv": ("dw",), "add": ("add",),
         "avgpool": ("avgpool",), "fc": ("fc",)}


def _made(net, seed, pool, res):
    """Weights (He-normal) and images from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    weights = [torch.randn(layer.weight_shape, generator=gen)
               * plain.he_std(layer) if layer.weight_shape
               else torch.empty(0) for layer in net]
    images = torch.rand((pool, res, res, 3), generator=gen) * 2.0 - 1.0
    return weights, images


def _port_graph(alpha, res, weights, net):
    g = mobilenet_v2_graph(alpha, res, CLASSES)
    apply_params(g, {op.name: {"weight": w.numpy()} for op, w in
                     zip(g.default_schedule(), weights) if w.numel()})
    return g


def _tensor_names(g):
    return ["input"] + [op.output for op in g.default_schedule()]


def test_graph_is_the_reference_network_at_table_2_size():
    """1.0@224, 1 000 classes: the port's graph and the reference's layers
    agree op for op (kind, activation, weight shape, output shape and
    which tensors each reads); 35 convs, 17 depthwise convs, 10 adds."""
    g = mobilenet_v2_graph(1.0, 224, 1000)
    net = plain.layers(1.0, 224, 1000)
    ops = g.default_schedule()
    assert len(ops) == len(net) == 64
    index = {name: i for i, name in enumerate(_tensor_names(g))}
    for op, layer in zip(ops, net):
        assert layer.kind in KINDS[op.kind], (op.name, layer)
        assert op.attrs.get("act", "") == layer.act, op.name
        w = op.attrs.get("weight")
        assert (() if w is None else w.shape) == layer.weight_shape
        assert tuple(g.tensors[op.output].shape) == \
            (layer.h_out, layer.w_out, layer.cout)
        assert tuple(index[i] for i in op.inputs) == layer.inputs, op.name
    kinds = [op.kind for op in ops]
    assert (kinds.count("conv"), kinds.count("dwconv"),
            kinds.count("add")) == (35, 17, 10)
    # the projections are the linear convs, one a block
    assert sum(op.attrs.get("act") == "none" for op in ops) == 17
    # Table 2's 300 M multiply-accumulates: 299 494 272 in the convs and
    # 1 280 000 in the head
    assert plain.model_macs(net) == 300_774_272
    assert sum(layer.macs for layer in net if layer.kind != "fc") == \
        299_494_272


def test_float_outputs_match_the_reference():
    """The f32 arena program against the reference's float pass, within
    1e-5 of the largest output.  The gap is float32 summation order: the
    program's 1x1 convs are K6's plain version (a matmul), the
    reference's are conv2d, so sums of up to 960 products differ in their
    last bits and 60 layers carry that on (widest gap 1.7e-6 of the
    largest output over three seeds)."""
    net = plain.layers(1.0, 32, CLASSES)
    weights, images = _made(net, 11, 2, 32)
    g = _port_graph(1.0, 32, weights, net)
    dep = deploy.build(g, device="cpu")
    want = plain.float_forward(images, net, weights)[-1].reshape(2, -1)
    got = np.stack([dep.run({"input": images[i].numpy()})[g.outputs[0]]
                    .reshape(-1) for i in range(2)])
    scale = float(want.abs().max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=1e-5 * scale)


def _int8(alpha, res, budget, seed, rungs=None, relu_projections=False):
    net = plain.layers(alpha, res, CLASSES)
    weights, images = _made(net, seed, 6, res)
    g = _port_graph(alpha, res, weights, net)
    if relu_projections:
        apply_params(g, {op.name: {"act": "relu"}
                         for op in g.operators if op.attrs.get("act")
                         == "none"})
    calib = [{"input": images[i].numpy()} for i in range(4)]
    opts = {} if rungs is None else {"rungs": rungs}
    dep = deploy.build(g, arena_budget=budget, quantize=True,
                       calibration=calib, device="cpu", **opts)
    ranges = plain.calibrate(images[:4], net, weights)
    qn = plain.quantize(net, weights, ranges, bits=8)
    return dep, qn, images


# (alpha, resolution, budget, rungs, arena bytes, rung the scheduler took)
BUDGETS = {
    "none": (1.0, 32, None, None, 30_720, "greedy"),
    "pex": (1.0, 32, 20_000, None, 11_008, "default+pex"),
    "cascade2d": (1.0, 32, 10_000, None, 9_984, "default+cascade2d+pex"),
    "cascade": (0.35, 128, 80_000, ("reorder", "pex", "cascade", "solver"),
                73_216, "default+cascade+pex"),
}


@pytest.mark.parametrize("which", list(BUDGETS))
def test_int8_answers_are_the_references(which):
    """Same weights and calibration images: the port's qparams are the
    reference's, and every int8 answer equals the reference's, whole and
    under each budget (Pex slices, 2-D tiles, row rings); the adds run
    inside the slices."""
    alpha, res, budget, rungs, arena, rung = BUDGETS[which]
    dep, qn, images = _int8(alpha, res, budget, 5, rungs)
    assert (dep.arena_bytes, dep.schedule_result.method) == (arena, rung)
    for name, q in zip(_tensor_names(dep.graph), qn.act):
        assert dep.qmodel.qparams[name].scale == q.scale, name
        assert dep.qmodel.qparams[name].zero_point == q.zero_point, name
    kinds = [op.kind for op in dep.schedule]
    assert kinds.count("qadd") >= 10
    if which.startswith("cascade"):
        assert "pex_ring_push" in kinds and "pex_ring_read" in kinds
    want = plain.outputs(images, qn).numpy()
    out = dep.graph.outputs[0]
    got = np.stack([dep.run(dep.quantize_inputs(
        {"input": images[i].numpy()}))[out].reshape(-1)
        for i in range(images.shape[0])])
    np.testing.assert_array_equal(got, want)


def test_relu6_binds_and_the_clamp_pairs_follow_it():
    """ReLU6 binds in the float pass: ranges of ReLU6 tensors end at
    exactly 6.0 (at this size most do), none above.  Each int8 conv
    carries its activation's clamp pair: ReLU6 ``[zp, min(127, zp +
    round(6 / s))]``, linear projections the whole grid."""
    net = plain.layers(1.0, 32, CLASSES)
    weights, images = _made(net, 5, 6, 32)
    ranges = plain.calibrate(images[:4], net, weights)
    relu6 = [ranges[i + 1][1] for i, layer in enumerate(net)
             if layer.act == "relu6"]
    assert max(relu6) == 6.0 and sum(hi == 6.0 for hi in relu6) >= 10
    dep, qn, _ = _int8(1.0, 32, None, 5)
    for op in dep.graph.operators:
        act, a = op.attrs.get("act"), op.attrs
        if act == "relu6":
            s_out = dep.qmodel.qparams[op.output].scale
            assert (a["lo"], a["hi"]) == (
                a["zp_out"], min(127, a["zp_out"] + round(6.0 / s_out)))
        elif act == "none":
            assert (a["lo"], a["hi"]) == (-128, 127)


def test_relu_projections_are_not_the_reference():
    """The fault: projections with a ReLU (no linear bottleneck) give
    other answers than the reference's network."""
    dep, qn, images = _int8(1.0, 32, None, 5, relu_projections=True)
    want = plain.outputs(images, qn).numpy()
    out = dep.graph.outputs[0]
    got = np.stack([dep.run(dep.quantize_inputs(
        {"input": images[i].numpy()}))[out].reshape(-1)
        for i in range(images.shape[0])])
    assert np.abs(got.astype(np.int64) - want).max() > 0


def test_the_reference_stands_apart_and_is_the_benchmarks():
    """The benchmark's reference, which these tests load by path, imports
    neither JAX nor the JAX package nor the port nor the benchmark."""
    import ast
    names = set()
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "portbench"}, names
    assert plain.__file__ == str(REFERENCE)
