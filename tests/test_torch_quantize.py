"""The port's post-training int8 pass against the JAX package's.

Calibration runs the float32 semantics, whose sums XLA and torch order
differently, so observed ranges — and the scales derived from them — may
differ in the last bits: scales are held at ``rtol=1e-5`` and zero points
exactly.  Given the reference's qparams, the port's rewrite is the
reference's int8 graph exactly (same ``weight_q``, bit-equal ``mult``
floats, equal zero points)."""
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as JaxGraph
from repro.graphs import mobilenet_v1_graph as jax_mobilenet
from repro.graphs import quantize_graph as jax_quantize_graph
from repro.graphs.cnn_ops import CNNBuilder as JaxBuilder

from repro_torch.core.graph import Graph
from repro_torch.graphs import (int8_scheduling_graph, mobilenet_v1_graph,
                                quantize_graph, random_input)
from repro_torch.graphs.cnn_ops import CNNBuilder

from test_torch_params import PARAM_KEYS, int8_twins, tiny_cnn, twin

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)


def _pairs():
    return [("tiny_cnn", tiny_cnn(JaxGraph, JaxBuilder),
             tiny_cnn(Graph, CNNBuilder)),
            ("mobilenet_025_96", jax_mobilenet(0.25, 96),
             mobilenet_v1_graph(0.25, 96))]


@pytest.mark.parametrize("idx", [0, 1], ids=["tiny_cnn", "mobilenet_025_96"])
def test_calibrated_qparams_match_reference(idx):
    _, jf, pf = _pairs()[idx]
    pf = twin(jf, pf)
    x = random_input(pf)
    jq = jax_quantize_graph(jf, x)
    pq = quantize_graph(pf, x, device="cpu")
    assert set(pq.qparams) == set(jq.qparams)
    for name, want in jq.qparams.items():
        got = pq.qparams[name]
        np.testing.assert_allclose(got.scale, want.scale, rtol=1e-5,
                                   err_msg=name)
        assert got.zero_point == want.zero_point, name
    for jo, po in zip(jq.graph.operators, pq.graph.operators):
        assert (po.name, po.kind) == (jo.name, jo.kind)
        if "weight_q" in jo.attrs:
            np.testing.assert_array_equal(po.attrs["weight_q"],
                                          np.asarray(jo.attrs["weight_q"]))


def test_quantized_model_from_qparams_is_the_reference_rewrite():
    """Same topology, same ``weight_q``, bit-equal ``mult`` floats and
    equal zero points as the reference's int8 graph."""
    for _, jf, pf in _pairs():
        jq, pq = int8_twins(jf, pf, random_input(pf))
        assert [o.name for o in jq.graph.operators] == \
            [o.name for o in pq.graph.operators]
        for jo, po in zip(jq.graph.operators, pq.graph.operators):
            assert (jo.kind, jo.inputs, jo.output) == \
                (po.kind, po.inputs, po.output)
            for key in PARAM_KEYS + ("k", "stride", "weight_bytes"):
                if key in jo.attrs:
                    np.testing.assert_array_equal(np.asarray(po.attrs[key]),
                                                  np.asarray(jo.attrs[key]))
        for name, t in jq.graph.tensors.items():
            p = pq.graph.tensors[name]
            assert (p.size, p.shape, p.dtype) == (t.size, t.shape, t.dtype)
        assert {n: (q.scale, q.zero_point) for n, q in pq.qparams.items()} \
            == {n: (q.scale, q.zero_point) for n, q in jq.qparams.items()}


def test_int8_scheduling_graph_matches_reference_sizes():
    from repro.graphs import int8_scheduling_graph as jax_sched_graph
    jq = jax_sched_graph(jax_mobilenet(0.25, 96))
    pq = int8_scheduling_graph(mobilenet_v1_graph(0.25, 96))
    assert {n: t.size for n, t in pq.tensors.items()} == \
        {n: t.size for n, t in jq.tensors.items()}
    assert [o.attrs.get("weight_bytes") for o in pq.operators] == \
        [o.attrs.get("weight_bytes") for o in jq.operators]
