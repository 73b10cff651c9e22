"""The f32 deploy path: every k=1, stride-1 float32 conv of a schedule goes
through the K6 wrapper (``conv1x1_fused``), as the reference's
``use_pallas`` branch sends it to ``conv1x1_pallas``.  The port's
``compile_schedule(..., device="cpu")`` on MobileNet-0.25@96 and the
SwiftNet cell, reorder-only and sliced by Pex, is held to the reference:
the same arena bytes; outputs within ``rtol=1e-4, atol=1e-5·max|ref|`` of
``compile_schedule(..., use_pallas=True, interpret=True)`` and of the
reference interpreter (the two sum in other orders, and the reference's
own f32 executors differ by ~4e-9 on jax 0.9 — ROADMAP R2); and one K6
call per k=1/stride-1 conv of the schedule."""
import numpy as np
import pytest
import torch

from repro.core import ArenaPlanner as JaxPlanner
from repro.core import partition_graph as jax_partition
from repro.core import schedule as jax_schedule
from repro.graphs import mobilenet_v1_graph as jax_mobilenet
from repro.graphs import swiftnet_cell_graph as jax_swiftnet
from repro.mcu import MicroInterpreter as JaxInterpreter
from repro.mcu import compile_schedule as jax_compile

import repro_torch.deploy as deploy
from repro_torch.core import ArenaPlanner, partition_graph, schedule
from repro_torch.errors import InputValidationError
from repro_torch.graphs import cnn_ops, mobilenet_v1_graph, random_input
from repro_torch.graphs import swiftnet_cell_graph
from repro_torch.mcu import compile_schedule

from test_torch_params import twin

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

KB = 1024
GRAPHS = {"mobilenet_025_96": (lambda: jax_mobilenet(0.25, 96),
                               lambda: mobilenet_v1_graph(0.25, 96)),
          "swiftnet_cell": (jax_swiftnet, swiftnet_cell_graph)}
# (graph, budget, arena bytes, method).  MobileNet-0.25@96 is Pex-sliced by
# the scheduler under 200 KB; on the SwiftNet cell the scheduler keeps the
# greedy order under any budget (slicing costs more than it saves), so its
# Pex case is the partition rewrite's own default order.
CASES = [("mobilenet_025_96", None, 221184, "greedy"),
         ("mobilenet_025_96", 200 * KB, 184320, "greedy+pex"),
         ("swiftnet_cell", None, 1253376, "greedy"),
         ("swiftnet_cell", 512 * KB, 1486080, "partition")]


def close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


def _pointwise(sched):
    return sum(1 for op in sched if op.kind == "conv"
               and op.attrs.get("k", 1) == 1 and op.attrs["stride"] == 1)


@pytest.mark.parametrize("which,budget,arena,method", CASES)
def test_f32_schedule_matches_the_reference(monkeypatch, which, budget,
                                            arena, method):
    jf_make, pf_make = GRAPHS[which]
    jf = jf_make()
    pf = twin(jf, pf_make())
    if method == "partition":
        jp, pp = jax_partition(jf, budget=budget), partition_graph(
            pf, budget=budget)
        assert pp.segments and len(pp.segments) == len(jp.segments)
        jg, pg = jp.graph, pp.graph
        js, ps = jg.default_schedule(), pg.default_schedule()
    else:
        jr = jax_schedule(jf, arena_budget=budget)
        pr = schedule(pf, arena_budget=budget)
        assert pr.method == jr.method == method
        jg = jr.graph if jr.graph is not None else jf
        pg = pr.graph if pr.graph is not None else pf
        js, ps = jr.schedule, pr.schedule
    assert [o.name for o in ps] == [o.name for o in js]
    jplan, pplan = JaxPlanner.plan(jg, js), ArenaPlanner.plan(pg, ps)
    assert pplan.arena_size == jplan.arena_size == arena

    calls = []
    real = cnn_ops.conv1x1_fused
    monkeypatch.setattr(cnn_ops, "conv1x1_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = random_input(pf, seed=3)
    got = compile_schedule(pg, ps, pplan, device="cpu").run(x)
    assert len(calls) == _pointwise(ps) > 0
    want = jax_compile(jg, js, jplan, use_pallas=True, interpret=True).run(x)
    for o in pg.outputs:
        assert got[o].dtype == np.float32
        close(got[o], want[o])
    if budget is None:      # the reference interpreter, on the whole graph
        interp = JaxInterpreter(jg).run(x, schedule=js)
        for o in pg.outputs:
            close(got[o], np.asarray(interp.outputs[o]))


def test_f32_deployment_validates_runs_and_serves():
    """``deploy.build`` on a float graph reaches the K6 lowering: inputs
    are validated as f32, and a served micro-batch equals one-shot runs."""
    d = deploy.build(mobilenet_v1_graph(0.25, 96), device="cpu")
    assert d.arena_bytes == 221184 and d.qmodel is None
    x = random_input(d.graph, seed=1)
    with pytest.raises(InputValidationError, match="float64"):
        d.run({"input": x["input"].astype(np.float64)})
    reqs = [random_input(d.graph, seed=s) for s in range(3)]
    served = d.serve(reqs, micro_batch=2)
    (name,) = d.graph.outputs
    for r, o in zip(reqs, served):
        np.testing.assert_array_equal(o[name], d.run(r)[name])
