"""The frozen reference against the port's plain CPU path."""
import numpy as np
import pytest
import torch

from portbench_tiny import TINY
from portbench.harness import inputs, spec

ref = spec.load_module("reference", "mobilenet_v1")
graphs = spec.load_module("graphs", "mobilenet_v1")
CLASSES = 1000                    # the published head, as the cells serve


def _made(seed, net, pool=16):
    return inputs.make(seed, [layer.weight_shape for layer in net],
                       [ref.he_std(layer) for layer in net], pool,
                       TINY["resolution"], torch.device("cpu"))


def _port(made, budget):
    from repro_torch import deploy
    from repro_torch.params import apply_params
    g = graphs.build(TINY["alpha"], TINY["resolution"], CLASSES)
    weights = made.weights_np()
    apply_params(g, {op.name: {"weight": w}
                     for op, w in zip(g.default_schedule(), weights)
                     if w.size})
    images = made.images.numpy()
    return deploy.build(g, arena_budget=budget, quantize=True,
                        calibration=[{"input": images[i]} for i in range(8)],
                        device="cpu"), images


def _ops(g):
    return [(op.name, op.kind, tuple(op.inputs), op.output,
             tuple(g.tensors[op.output].shape),
             tuple(getattr(op.attrs.get("weight"), "shape", ())))
            for op in g.default_schedule()]


def test_layers_are_the_ports_graph():
    """The benchmark's graph is the port's ``mobilenet_v1_graph`` operator
    for operator, but for the head's width; the reference's layers are
    the graph's at the published 1 000 classes."""
    from repro_torch.graphs import mobilenet_v1_graph
    for alpha, res in ((1.0, 192), (TINY["alpha"], TINY["resolution"])):
        assert _ops(graphs.build(alpha, res, 2)) == \
            _ops(mobilenet_v1_graph(alpha, res))
    g = graphs.build(1.0, 192, CLASSES)
    net = ref.layers(1.0, 192, CLASSES)
    ops = g.default_schedule()
    assert len(net) == len(ops) == 29
    assert tuple(g.tensors[g.outputs[0]].shape) == (1, 1, CLASSES)
    for op, layer in zip(ops, net):
        w = op.attrs.get("weight")
        assert (() if w is None else w.shape) == layer.weight_shape
        assert (layer.h_out, layer.w_out) == \
            tuple(g.tensors[op.output].shape[:2])


@pytest.mark.parametrize("budget", [None, 46000])
def test_reference_equals_the_ports_plain_path(budget):
    """Same weights and calibration images: the reference's qparams are
    the port's, and every int8 answer is the port's, with the whole
    network (budget None) and with Pex slices and rings (46 000 B)."""
    net = ref.layers(TINY["alpha"], TINY["resolution"], CLASSES)
    made = _made(3, net)
    dep, images = _port(made, budget)
    ranges = ref.calibrate(made.images[:8], net, made.weights)
    qn = ref.quantize(net, made.weights, ranges, bits=8)
    names = ["input"] + [op.output for op in dep.graph.default_schedule()]
    for name, q in zip(names, qn.act):
        assert dep.qmodel.qparams[name].scale == q.scale, name
        assert dep.qmodel.qparams[name].zero_point == q.zero_point, name
    want = ref.outputs(made.images, qn).numpy()
    out = dep.graph.outputs[0]
    for i in range(images.shape[0]):
        got = dep.run(dep.quantize_inputs({"input": images[i]}))[out]
        np.testing.assert_array_equal(got.reshape(-1), want[i])


def test_int_path_is_exact_with_the_ports_qparams():
    """Handed the port's own parameters, the reference's integer path
    gives the port's answers bit for bit: the ops and the requantization
    are the same arithmetic."""
    net = ref.layers(TINY["alpha"], TINY["resolution"], CLASSES)
    made = _made(4, net)
    dep, images = _port(made, None)
    names = ["input"] + [op.output for op in dep.graph.default_schedule()]
    qn = ref.quantize(net, made.weights,
                      ref.calibrate(made.images[:8], net, made.weights))
    qn.act = [ref.QParams(dep.qmodel.qparams[n].scale,
                          dep.qmodel.qparams[n].zero_point, 8)
              for n in names]
    want = ref.outputs(made.images, qn).numpy()
    out = dep.graph.outputs[0]
    got = np.stack([dep.run(dep.quantize_inputs({"input": x}))[out]
                    .reshape(-1) for x in images])
    np.testing.assert_array_equal(got, want)


def test_qparams_rules():
    qp = ref.activation_qparams(0.5, 2.55, 8)      # widened to 0
    assert (qp.scale, qp.zero_point) == (2.55 / 255, -128)
    qp = ref.activation_qparams(-1.0, 1.0, 4)
    assert qp.scale == 2.0 / 15 and qp.zero_point == 0
    q, s = ref.weight_quantize(torch.tensor([0.5, -1.0, 0.25]), 8)
    assert s == 1.0 / 127
    assert q.tolist() == [64.0, -127.0, 32.0]
