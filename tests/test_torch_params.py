"""Weights and qparams carried from the JAX package into the port
(``repro_torch.params``), plus the shared helpers of the ``test_torch_*``
files: the exporting side walks a JAX graph into plain numpy/Python values
(the port imports nothing of ``repro``, so that side lives here)."""
import numpy as np
import pytest
import torch

from repro.graphs import quantize_graph as jax_quantize_graph
from repro.graphs.cnn_ops import CNNBuilder as JaxBuilder
from repro.core.graph import Graph as JaxGraph

from repro_torch.core.graph import Graph
from repro_torch.graphs import random_input
from repro_torch.graphs.cnn_ops import CNNBuilder
from repro_torch.params import apply_params, quantized_model_from_qparams

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

PARAM_KEYS = ("weight", "weight_q", "mult", "zp_in", "zp_out", "mult_a",
              "mult_b", "zp_a", "zp_b", "mults", "zps", "scale", "zp")


def export_params(graph):
    """{op_name: {attr: numpy array or Python scalar}} of a JAX graph."""
    out = {}
    for op in graph.operators:
        vals = {}
        for key in PARAM_KEYS:
            if key in op.attrs:
                v = op.attrs[key]
                vals[key] = (np.asarray(v) if key in ("weight", "weight_q")
                             else v)
        if vals:
            out[op.name] = vals
    return out


def export_qparams(qmodel):
    """{tensor: (scale, zero_point)} of a JAX ``QuantizedModel``."""
    return {n: (q.scale, q.zero_point) for n, q in qmodel.qparams.items()}


def tiny_cnn(graph_cls, builder_cls):
    """The small branchy CNN of ``tests/test_executor_diff.py`` (every
    builder kind), on either package's Graph/CNNBuilder."""
    g = graph_cls()
    b = builder_cls(g)
    x = b.input("input", 16, 16, 3)
    x = b.conv(x, 8, k=3)
    a = b.conv(x, 8, k=1)
    a = b.dwconv(a, k=3)
    bb = b.maxpool(x, k=2, stride=2)
    bb = b.conv(bb, 8, k=1)
    a = b.maxpool(a, k=2, stride=2)
    y = b.add(a, bb)
    y = b.concat([y, bb])
    y = b.avgpool(y)
    y = b.fc(y, 4)
    g.set_outputs([y])
    return g


def twin(jax_graph, port_graph):
    """The port graph with the JAX graph's parameters carried across."""
    return apply_params(port_graph, export_params(jax_graph))


def int8_twins(jax_float, port_float, calibration):
    """(JAX QuantizedModel, port QuantizedModel) of one float network, the
    port's built from the reference's weights and qparams."""
    jq = jax_quantize_graph(jax_float, calibration)
    pq = quantized_model_from_qparams(twin(jax_float, port_float),
                                      export_qparams(jq))
    return jq, pq


# ------------------------------------------------------------------ tests
def test_apply_params_carries_weights_and_rebuilds_semantics():
    jg = tiny_cnn(JaxGraph, JaxBuilder)
    pg = tiny_cnn(Graph, CNNBuilder)
    params = export_params(jg)
    apply_params(pg, params)
    for op in pg.operators:
        if "weight" in op.attrs:
            np.testing.assert_array_equal(op.attrs["weight"],
                                          params[op.name]["weight"])
            assert op.attrs["weight_bytes"] == op.attrs["weight"].nbytes
        assert op.fn is not None
    # the rebuilt fn computes with the new weights
    x = torch.as_tensor(random_input(pg)["input"])
    conv = pg.op_by_name("conv1")
    ref = np.asarray(jg.op_by_name("conv1").fn(random_input(jg)["input"]))
    np.testing.assert_allclose(conv.fn(x).numpy(), ref, rtol=2e-5,
                               atol=1e-6)


def test_apply_params_rejects_a_reshaped_weight():
    pg = tiny_cnn(Graph, CNNBuilder)
    with pytest.raises(ValueError, match="shape"):
        apply_params(pg, {"conv1": {"weight": np.zeros((1, 1, 3, 8),
                                                       np.float32)}})
