"""The paper's graphs in the port (``repro_torch.graphs.figure1`` and
``swiftnet``) against the JAX package's: the same tensors (names, byte
sizes, shapes, dtypes) and operators (names, kinds, inputs, outputs), the
Figure-1 peaks of 5 216 / 4 960 B, the same schedule method and peak on
the f32 and int8 SwiftNet cell, the Figure-1 semantics op by op, and the
SwiftNet weights and qparams carried across."""
import numpy as np
import pytest
import torch

from repro.core import schedule as jax_schedule
from repro.graphs import figure1_executable_graph as jax_fig1_exec
from repro.graphs import figure1_graph as jax_fig1
from repro.graphs import figure1_int8_graph as jax_fig1_int8
from repro.graphs import int8_scheduling_graph as jax_int8_sched
from repro.graphs import swiftnet_cell_graph as jax_swiftnet

from repro_torch.core import schedule
from repro_torch.graphs import (figure1_executable_graph, figure1_graph,
                                figure1_int8_graph, int8_scheduling_graph,
                                random_input, swiftnet_cell_graph)
from repro_torch.graphs.figure1 import DEFAULT_PEAK, OPTIMAL_PEAK, SIZES

from test_torch_params import int8_twins

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

PAIRS = {
    "figure1": (jax_fig1, figure1_graph),
    "figure1_executable": (jax_fig1_exec, figure1_executable_graph),
    "figure1_int8": (jax_fig1_int8, figure1_int8_graph),
    "swiftnet_cell": (jax_swiftnet, swiftnet_cell_graph),
}


def _structure(g):
    tensors = {n: (t.size, tuple(t.shape), t.dtype)
               for n, t in g.tensors.items()}
    ops = [(op.name, op.kind, tuple(op.inputs), op.output)
           for op in g.operators]
    return tensors, ops, list(g.outputs)


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_graph_equals_the_reference(which):
    jf, pf = PAIRS[which]
    assert _structure(pf()) == _structure(jf())


def test_figure1_peaks():
    g = figure1_graph()
    assert {n: t.size for n, t in g.tensors.items()} == SIZES
    assert g.peak_usage(g.default_schedule()) == DEFAULT_PEAK == 5216
    order = [g.op_by_name(n) for n in
             ["op1", "op4", "op6", "op2", "op3", "op5", "op7"]]
    assert g.peak_usage(order) == OPTIMAL_PEAK == 4960
    res = schedule(g)
    assert res.peak == OPTIMAL_PEAK


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_swiftnet_schedule_equals_the_reference(dtype):
    jg, pg = jax_swiftnet(), swiftnet_cell_graph()
    if dtype == "int8":
        jg, pg = jax_int8_sched(jg), int8_scheduling_graph(pg)
    jr, pr = jax_schedule(jg), schedule(pg)
    assert pr.method == jr.method
    assert pr.peak == jr.peak
    assert [op.name for op in pr.schedule] == [op.name for op in jr.schedule]
    assert pg.peak_usage(pg.default_schedule()) == \
        jg.peak_usage(jg.default_schedule())
    # the Table 1 numbers: reordering saves 54 KB of int8 SRAM
    want = {"float32": (1253376, 1474560), "int8": (313344, 368640)}[dtype]
    assert (pr.peak, pg.peak_usage(pg.default_schedule())) == want


@pytest.mark.parametrize("which", ["figure1_executable", "figure1_int8"])
def test_figure1_semantics_op_by_op(which):
    """Every op's fn on the same input: int8 bit-exact, f32 within the
    float tolerance of ``tests/test_kernels.py``."""
    jf, pf = PAIRS[which]
    jg, pg = jf(), pf()
    rng = np.random.default_rng(3)
    for jop, pop in zip(jg.operators, pg.operators):
        args = []
        for name in pop.inputs:
            t = pg.tensors[name]
            if t.dtype == "int8":
                args.append(rng.integers(-128, 128, t.shape).astype(np.int8))
            else:
                args.append(rng.standard_normal(t.shape).astype(np.float32))
        want = np.asarray(jop.fn(*args))
        got = pop.fn(*[torch.as_tensor(a) for a in args]).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if which == "figure1_int8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_swiftnet_weights_and_qparams_carried_across():
    jf, pf = jax_swiftnet(), swiftnet_cell_graph()
    jq, pq = int8_twins(jf, pf, random_input(pf))
    assert _structure(pq.graph) == _structure(jq.graph)
    assert pq.qparams.keys() == jq.qparams.keys()
    for name, qp in jq.qparams.items():
        assert (pq.qparams[name].scale, pq.qparams[name].zero_point) == \
            (qp.scale, qp.zero_point)
    for jop, pop in zip(jq.graph.operators, pq.graph.operators):
        for key in ("weight_q", "mult", "zp_in", "zp_out", "mults", "zps"):
            if key in jop.attrs:
                np.testing.assert_array_equal(np.asarray(pop.attrs[key]),
                                              np.asarray(jop.attrs[key]))
