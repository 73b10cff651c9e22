"""The port's arena executor (``repro_torch.mcu.compile``, plain path on
the CPU) against the reference ``repro.mcu.compile_schedule`` on the same
network, weights and schedule: int8 outputs bit-exact, the arena exactly
``plan.arena_size`` bytes and equal to the reference plan's, and the
program structure (``steps``, ``rolled_loops``, ``rolled_ops``,
``zero_copy_reads``) equal.  Float32 graphs agree at the tolerance of
``tests/test_executor_diff.py``.  The ring-cascade schedules are in
``test_torch_cascade.py``."""
import numpy as np
import pytest
import torch

from repro.core import ArenaPlanner as JaxPlanner
from repro.core import greedy_schedule as jax_greedy
from repro.core import partition_graph as jax_partition
from repro.core import schedule as jax_schedule
from repro.core.graph import Graph as JaxGraph
from repro.graphs import figure1_executable_graph as jax_fig1_exec
from repro.graphs import figure1_int8_graph as jax_fig1_int8
from repro.graphs import mobilenet_v1_graph as jax_mobilenet
from repro.graphs.cnn_ops import CNNBuilder as JaxBuilder
from repro.graphs.cnn_ops import conv2d as jax_conv2d
from repro.graphs.cnn_ops import dequantize_array as jax_dequant
from repro.graphs.cnn_ops import quantize_array as jax_quant
from repro.mcu import compile_schedule as jax_compile

from repro_torch.core import (ArenaPlanner, greedy_schedule,
                              partition_graph, schedule)
from repro_torch.core.graph import Graph
from repro_torch.errors import GuardViolation
from repro_torch.graphs import (figure1_executable_graph, figure1_int8_graph,
                                mobilenet_v1_graph, random_input)
from repro_torch.graphs.cnn_ops import CNNBuilder
from repro_torch.mcu.compile import CANARY_BYTE, compile_schedule

from test_torch_params import int8_twins, tiny_cnn, twin

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

KB = 1024
_F32 = dict(rtol=2e-5, atol=1e-6)


def check_twin_executors(jg, jsched, pg, psched, x, exact=True):
    """Compile both sides on their own schedule of the same graph and hold
    the port to the reference; returns the port's executor."""
    assert [o.name for o in psched] == [o.name for o in jsched]
    jplan = JaxPlanner.plan(jg, jsched)
    pplan = ArenaPlanner.plan(pg, psched)
    ArenaPlanner.validate(pplan, pg)
    assert pplan.arena_size == jplan.arena_size
    assert {p.tensor: (p.offset, p.size) for p in pplan.placements} == \
        {p.tensor: (p.offset, p.size) for p in jplan.placements}
    jex = jax_compile(jg, jsched, jplan)
    pex = compile_schedule(pg, psched, pplan, device="cpu")
    assert pex.arena_size == pplan.arena_size == jex.arena_size
    for attr in ("steps", "rolled_loops", "rolled_ops", "zero_copy_reads"):
        assert getattr(pex, attr) == getattr(jex, attr), attr
    want, got = jex.run(x), pex.run(x)
    for o in jg.outputs:
        if exact:
            assert got[o].dtype == want[o].dtype
            np.testing.assert_array_equal(got[o], want[o])
        else:
            np.testing.assert_allclose(got[o], want[o], **_F32)
    return pex


def _int8_pair(which):
    if which == "tiny_cnn":
        jf, pf = tiny_cnn(JaxGraph, JaxBuilder), tiny_cnn(Graph, CNNBuilder)
    else:
        jf, pf = jax_mobilenet(0.25, 96), mobilenet_v1_graph(0.25, 96)
    jq, pq = int8_twins(jf, pf, random_input(pf))
    return jq.graph, pq.graph


@pytest.mark.parametrize("which", ["tiny_cnn", "mobilenet_025_96"])
def test_int8_schedules_bit_identical(which):
    jg, pg = _int8_pair(which)
    x = random_input(pg, seed=4)
    cases = [(jg.default_schedule(), pg.default_schedule()),
             (jax_greedy(jg).schedule, greedy_schedule(pg).schedule),
             (jax_schedule(jg).schedule, schedule(pg).schedule)]
    for jsched, psched in cases:
        check_twin_executors(jg, jsched, pg, psched, x)


def test_int8_partition_rolls_like_the_reference():
    """Pex slices under a 48 KB budget roll into loops; the port groups
    them exactly as the reference does and stays bit-identical."""
    jg, pg = _int8_pair("mobilenet_025_96")
    jp, pp = jax_partition(jg, budget=48 * KB), partition_graph(
        pg, budget=48 * KB)
    assert pp.segments and len(pp.segments) == len(jp.segments)
    ex = check_twin_executors(jp.graph, jp.graph.default_schedule(),
                              pp.graph, pp.graph.default_schedule(),
                              random_input(pg, seed=5))
    assert ex.rolled_loops > 0 and ex.rolled_ops > 0


def test_f32_tiny_cnn_within_tolerance():
    jg = tiny_cnn(JaxGraph, JaxBuilder)
    pg = twin(jg, tiny_cnn(Graph, CNNBuilder))
    check_twin_executors(jg, jax_schedule(jg).schedule, pg,
                         schedule(pg).schedule, random_input(pg),
                         exact=False)


def _mixed(graph_cls, conv2d, quant, dequant, w):
    """int8 -> dequant -> f32 conv -> quant -> int8: both element widths
    in one arena, with an odd-sized int8 tensor."""
    g = graph_cls()
    g.add_tensor("x", 9 * 9 * 3, (9, 9, 3), dtype="int8")
    g.add_tensor("xf", 4 * 9 * 9 * 3, (9, 9, 3), dtype="float32")
    g.add_tensor("yf", 4 * 9 * 9 * 5, (9, 9, 5), dtype="float32")
    g.add_tensor("y", 9 * 9 * 5, (9, 9, 5), dtype="int8")
    g.add_operator("deq", ["x"], "xf", kind="dequant",
                   fn=lambda q: dequant(q, 0.05, 3), scale=0.05, zp=3)
    g.add_operator("conv", ["xf"], "yf", kind="conv",
                   fn=lambda a: conv2d(a, w, 1), weight=w, k=3, stride=1)
    g.add_operator("q", ["yf"], "y", kind="quant",
                   fn=lambda v: quant(v, 0.1, -5), scale=0.1, zp=-5)
    g.set_outputs(["y"])
    return g


def test_mixed_dtype_arena_and_lanes():
    """f32 and int8 views share the byte arena; with several lanes the
    lane pitch keeps every f32 view aligned, and each lane equals its
    one-shot run."""
    from repro_torch.graphs.cnn_ops import (conv2d, dequantize_array,
                                            quantize_array)
    w = (np.random.default_rng(9).standard_normal((3, 3, 3, 5)) * 0.1
         ).astype(np.float32)
    jg = _mixed(JaxGraph, jax_conv2d, jax_quant, jax_dequant, w)
    pg = _mixed(Graph, conv2d, quantize_array, dequantize_array, w)
    rng = np.random.default_rng(10)
    xs = [{"x": rng.integers(-128, 128, (9, 9, 3)).astype(np.int8)}
          for _ in range(3)]
    ex = check_twin_executors(jg, jg.default_schedule(), pg,
                              pg.default_schedule(), xs[0], exact=False)
    assert ex.pitch % 4 == 0 and ex.pitch >= ex.arena_size
    arena = ex.new_arena(3)
    for lane, x in enumerate(xs):
        ex.write_inputs(arena, lane, x)
    ex.execute(arena)
    for lane, x in enumerate(xs):
        np.testing.assert_array_equal(ex.outputs_from(arena, lane)["y"],
                                      ex.run(x)["y"])


def test_guard_canaries_catch_a_stomped_byte():
    _, pg = _int8_pair("tiny_cnn")
    sched = pg.default_schedule()
    plan = ArenaPlanner.plan(pg, sched, guard_bytes=16)
    ex = compile_schedule(pg, sched, plan, device="cpu")
    assert ex.guard_regions
    x = random_input(pg)
    ex.run(x)                               # clean run: no false positive
    arena = ex.execute(ex.make_arena(x))
    off, _ = ex.guard_regions[0]
    assert int(arena[0, off]) == CANARY_BYTE
    arena[0, off] ^= 0xFF
    with pytest.raises(GuardViolation, match=f"arena byte {off}"):
        ex.verify_guards(arena)


@pytest.mark.parametrize("which", ["float32", "int8"])
def test_op_fn_fallback_runs_figure1(which):
    """Figure 1's kinds (``conv2d``, ``concat``) have no lowering rule: the
    executor runs their ``op.fn`` lane by lane, as the reference traces
    it.  int8 bit-exact and f32 within tolerance of the reference
    executor, 4 960 B of arena under the optimal order, and each of three
    lanes equal to its one-shot run."""
    jg, pg = ((jax_fig1_exec(), figure1_executable_graph())
              if which == "float32" else
              (jax_fig1_int8(), figure1_int8_graph()))
    order = ["op1", "op4", "op6", "op2", "op3", "op5", "op7"]
    ex = check_twin_executors(jg, [jg.op_by_name(n) for n in order], pg,
                              [pg.op_by_name(n) for n in order],
                              random_input(pg), exact=which == "int8")
    assert ex.arena_size == 4960
    xs = [random_input(pg, seed=s) for s in range(3)]
    arena = ex.new_arena(3)
    for lane, x in enumerate(xs):
        ex.write_inputs(arena, lane, x)
    ex.execute(arena)
    for lane, x in enumerate(xs):
        np.testing.assert_array_equal(ex.outputs_from(arena, lane)["t7"],
                                      ex.run(x)["t7"])


def test_compile_rejects_misaligned_plan_and_unknown_kinds():
    g = Graph()
    g.add_tensor("a", 1001, (1001,), dtype="int8")
    g.add_tensor("b", 900, (225,), dtype="float32")
    g.add_operator("op", ["a"], "b")
    g.set_outputs(["b"])
    sched = g.default_schedule()
    plan = ArenaPlanner.plan(g, sched, alignment=1)
    assert plan.offset_of("b") % 4 != 0
    with pytest.raises(ValueError, match="misaligned"):
        compile_schedule(g, sched, plan, device="cpu")
    # aligned, but kind "op" has neither a lowering rule nor an op.fn to
    # fall back to: refused when the program is compiled
    with pytest.raises(ValueError, match="neither a lowering rule"):
        compile_schedule(g, sched, device="cpu")


def test_compiled_rejects_wrong_dtype_and_missing_inputs():
    _, pg = _int8_pair("tiny_cnn")
    ex = compile_schedule(pg, device="cpu")
    with pytest.raises(ValueError, match="declares int8"):
        ex.run({"input": np.zeros((16, 16, 3), np.float32)})
    with pytest.raises(ValueError, match="missing graph inputs"):
        ex.run({})
    with pytest.raises(ValueError, match="arena must be uint8"):
        ex.execute(torch.zeros((1, ex.pitch + 1), dtype=torch.uint8))
