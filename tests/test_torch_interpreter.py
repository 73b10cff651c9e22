"""The port's micro-interpreter (``repro_torch.mcu.MicroInterpreter`` on
the CPU) against the reference ``repro.mcu.MicroInterpreter``: reports
(``peak_sram``, ``bytes_moved``, ``defrag_passes``, ``steps``, ``fits``)
equal to the byte, int8 outputs bit-exact, on Figure 1, the tiny CNN under
default / optimal / Pex schedules in dynamic and planned mode, and the
SwiftNet cell of the paper's Table 1 — which fits 512 KB of SRAM less
200 KB of framework only in the reordered order.  The interpreter's
outputs also equal the port's compiled executor's on the same schedule
and plan."""
import numpy as np
import pytest
import torch

from repro.core import ArenaPlanner as JaxPlanner
from repro.core import partition_graph as jax_partition
from repro.core import schedule as jax_schedule
from repro.graphs import figure1_executable_graph as jax_fig1_exec
from repro.graphs import figure1_graph as jax_fig1
from repro.graphs import figure1_int8_graph as jax_fig1_int8
from repro.graphs import swiftnet_cell_graph as jax_swiftnet
from repro.mcu import MicroInterpreter as JaxInterpreter

from repro_torch.core import ArenaPlanner, partition_graph, schedule
from repro_torch.graphs import (figure1_executable_graph, figure1_graph,
                                figure1_int8_graph, mobilenet_v1_graph,
                                quantize_graph, random_input,
                                swiftnet_cell_graph)
from repro_torch.mcu import MicroInterpreter, compile_schedule

from test_torch_executor import _int8_pair
from test_torch_params import int8_twins

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

KB = 1024
CAPACITY = 512 * KB - 200 * KB     # NUCLEO-F767ZI SRAM less the framework
OPTIMAL = ["op1", "op4", "op6", "op2", "op3", "op5", "op7"]


def _report(rep):
    return (rep.peak_sram, rep.bytes_moved, rep.defrag_passes, rep.steps,
            rep.fits)


def _by_name(g, sched):
    return [g.op_by_name(op.name) for op in sched]


def test_figure1_trivial_semantics_peaks():
    """tests/test_mcu.py's Figure-1 run: zero-filled outputs of each
    tensor's size; the interpreter reproduces the paper's peaks."""
    def attach(g, zeros, cat):
        for op in g.operators:
            if op.kind == "concat":
                op.fn = cat
            else:
                op.fn = (lambda s: lambda *xs: zeros(s))(g.size(op.output))
        return g
    pg = attach(figure1_graph(), lambda s: torch.zeros(s, dtype=torch.int8),
                lambda *xs: torch.cat([x.reshape(-1) for x in xs]))
    jg = attach(jax_fig1(), lambda s: np.zeros(s, np.int8),
                lambda *xs: np.concatenate([x.ravel() for x in xs]))
    x = {"t0": np.zeros(1568, np.int8)}
    for order, peak in ((None, 5216), (OPTIMAL, 4960)):
        ps = None if order is None else [pg.op_by_name(n) for n in order]
        js = None if order is None else [jg.op_by_name(n) for n in order]
        got = MicroInterpreter(pg, device="cpu").run(x, schedule=ps)
        want = JaxInterpreter(jg).run(x, schedule=js)
        assert got.peak_sram == peak
        assert _report(got) == _report(want)


@pytest.mark.parametrize("which", ["float32", "int8"])
@pytest.mark.parametrize("order", ["default", "optimal"])
def test_figure1_executable_matches_the_reference(which, order):
    jg, pg = ((jax_fig1_exec(), figure1_executable_graph())
              if which == "float32" else
              (jax_fig1_int8(), figure1_int8_graph()))
    names = OPTIMAL if order == "optimal" else [o.name for o in
                                                pg.operators]
    x = random_input(pg, seed=2)
    got = MicroInterpreter(pg, device="cpu").run(
        x, schedule=[pg.op_by_name(n) for n in names])
    want = JaxInterpreter(jg).run(x, schedule=[jg.op_by_name(n)
                                               for n in names])
    assert _report(got) == _report(want)
    assert got.peak_sram == (4960 if order == "optimal" else 5216)
    if which == "int8":
        np.testing.assert_array_equal(got.outputs["t7"], want.outputs["t7"])
    else:
        np.testing.assert_allclose(got.outputs["t7"], want.outputs["t7"],
                                   rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_int8():
    return _int8_pair("tiny_cnn")


@pytest.mark.parametrize("sched", ["default", "optimal", "pex"])
@pytest.mark.parametrize("mode", ["dynamic", "plan"])
def test_tiny_cnn_int8_matches_the_reference(tiny_int8, sched, mode):
    jg, pg = tiny_int8
    if sched == "pex":
        jp, pp = jax_partition(jg, budget=2 * KB), partition_graph(
            pg, budget=2 * KB)
        assert pp.segments
        jg, pg = jp.graph, pp.graph
        js, ps = jg.default_schedule(), pg.default_schedule()
    elif sched == "optimal":
        js, ps = jax_schedule(jg).schedule, schedule(pg).schedule
    else:
        js, ps = jg.default_schedule(), pg.default_schedule()
    assert [o.name for o in ps] == [o.name for o in js]
    pplan = ArenaPlanner.plan(pg, ps) if mode == "plan" else None
    jplan = JaxPlanner.plan(jg, js) if mode == "plan" else None
    x = random_input(pg, seed=6)
    got = MicroInterpreter(pg, device="cpu").run(x, schedule=ps, plan=pplan)
    want = JaxInterpreter(jg).run(x, schedule=js, plan=jplan)
    assert _report(got) == _report(want)
    if mode == "plan":
        assert got.peak_sram == pplan.arena_size
    for o in pg.outputs:
        np.testing.assert_array_equal(got.outputs[o], want.outputs[o])
    # the interpreter and the compiled executor agree bit for bit
    compiled = compile_schedule(pg, ps, pplan, device="cpu").run(x)
    for o in pg.outputs:
        np.testing.assert_array_equal(got.outputs[o], compiled[o])


@pytest.fixture(scope="module")
def swiftnet_int8():
    """(reference int8 graph, port int8 graph, quantized input, one
    reference interpreter run of the reordered order — ~20 s on a CPU)."""
    pf = swiftnet_cell_graph()
    jq, pq = int8_twins(jax_swiftnet(), pf, random_input(pf))
    x = jq.quantize_inputs(random_input(pf, seed=1))
    jg = jq.graph
    want = JaxInterpreter(jg).run(x, schedule=jax_schedule(jg).schedule)
    return jg, pq.graph, x, want


def test_swiftnet_table1_fits_only_when_reordered(swiftnet_int8):
    """Paper Table 1: at 512 KB − 200 KB = 319 488 B the default order
    overflows and the reordered one fits, with the reference's report."""
    jg, pg, x, want = swiftnet_int8
    interp = MicroInterpreter(pg, capacity=CAPACITY, device="cpu")
    with pytest.raises(MemoryError):
        interp.run(x, schedule=pg.default_schedule())
    order = schedule(pg).schedule
    assert [o.name for o in order] == \
        [o.name for o in jax_schedule(jg).schedule]
    got = interp.run(x, schedule=order)
    assert got.fits and got.peak_sram <= CAPACITY
    assert (got.peak_sram, got.bytes_moved, got.defrag_passes, got.steps) \
        == (313344, 1550978, 36, 36)
    assert _report(got)[:4] == _report(want)[:4]
    for o in pg.outputs:
        np.testing.assert_array_equal(got.outputs[o], want.outputs[o])
    # unconstrained, the default order needs 54 KB more SRAM (the
    # reference's numbers, from the same allocator)
    d = MicroInterpreter(pg, device="cpu").run(x)
    assert (d.peak_sram, d.bytes_moved, d.defrag_passes, d.steps) == \
        (368640, 1371266, 36, 36)
    # reordering does not change the outputs; nor does the executor
    compiled = compile_schedule(pg, order, device="cpu").run(x)
    for o in pg.outputs:
        np.testing.assert_array_equal(d.outputs[o], got.outputs[o])
        np.testing.assert_array_equal(compiled[o], got.outputs[o])


def test_mobilenet_dynamic_allocation_peak():
    """Table 1, MobileNet column (tests/test_mcu.py): dynamic allocation
    runs the int8 MobileNet-0.25@96 chain in 55 296 B."""
    g = mobilenet_v1_graph(0.25, 96)
    qm = quantize_graph(g, device="cpu")
    x = qm.quantize_inputs(random_input(g))
    rep = MicroInterpreter(qm.graph, device="cpu").run(x)
    assert rep.peak_sram == 55296
    assert rep.steps == len(qm.graph.operators)


def test_rejects_wrong_dtype_and_bad_schedules():
    pg = figure1_int8_graph()
    interp = MicroInterpreter(pg, device="cpu")
    with pytest.raises(ValueError, match="declares int8"):
        interp.run({"t0": np.zeros(1568, np.float32)})
    with pytest.raises(ValueError, match="invalid schedule"):
        interp.run(random_input(pg), schedule=pg.operators[::-1])
