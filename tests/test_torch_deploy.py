"""The slice as a whole: ``repro_torch.deploy`` (quantize → schedule →
plan → validate → compile → run / serve) against ``repro.deploy`` on
MobileNet-0.25@96 int8 under a budget that forces Pex, with the port's
weights and qparams carried from the reference; the typed input
rejections; and the 884 736 B / 322 560 B MobileNet-1.0@192 goldens
through the port's own copy of the scheduler and planner."""
import numpy as np
import pytest
import torch

import repro.deploy as jax_deploy
from repro.graphs import mobilenet_v1_graph as jax_mobilenet

import repro_torch.deploy as deploy
from repro_torch.core import ArenaPlanner, schedule
from repro_torch.core.graph import Graph
from repro_torch.errors import (BudgetUnreachableError, GuardViolation,
                                InputValidationError, ReproError)
from repro_torch.graphs import (int8_scheduling_graph, mobilenet_v1_graph,
                                random_input)
from repro_torch.graphs.cnn_ops import CNNBuilder
from repro_torch.params import quantized_model_from_qparams
from repro_torch.serving import FaultPlan

from test_torch_params import export_qparams, twin

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

KB = 1024
_BUDGET = 48 * KB            # reorder-only needs 55 296 B: Pex must fire


@pytest.fixture(scope="module")
def pair():
    """(reference deployment, port deployment on the reference's int8
    graph, port float twin, calibration input)."""
    jf = jax_mobilenet(0.25, 96)
    pf = twin(jf, mobilenet_v1_graph(0.25, 96))
    x = random_input(pf)
    jd = jax_deploy.build(jf, quantize=True, calibration=x,
                          arena_budget=_BUDGET)
    pq = quantized_model_from_qparams(pf, export_qparams(jd.qmodel))
    pd = deploy.build(pq.graph, arena_budget=_BUDGET, device="cpu")
    pd.qmodel = pq
    return jd, pd, pf, x


def test_build_matches_reference_schedule_and_arena(pair):
    jd, pd, pf, x = pair
    assert "pex" in jd.schedule_result.method
    for d in (pd, deploy.build(pf, quantize=True, calibration=x,
                               arena_budget=_BUDGET, device="cpu")):
        assert d.schedule_result.method == jd.schedule_result.method
        assert d.schedule_result.peak == jd.schedule_result.peak
        assert d.arena_bytes == jd.arena_bytes == d.executor.arena_size
        assert d.degraded == []
        assert d.stats.as_json() == jd.stats.as_json()


def test_run_bit_identical(pair):
    jd, pd, _, x = pair
    xq = jd.quantize_inputs(x)
    np.testing.assert_array_equal(pd.quantize_inputs(x)["input"],
                                  xq["input"])
    want, got = jd.run(xq), pd.run(xq)
    for o in jd.exec_graph.outputs:
        assert got[o].dtype == np.int8
        np.testing.assert_array_equal(got[o], want[o])
    for o in want:
        np.testing.assert_array_equal(pd.dequantize_outputs(got)[o],
                                      jd.dequantize_outputs(want)[o])


def test_serve_micro_batches_and_pad_lanes(pair):
    jd, pd, _, _ = pair
    rng = np.random.default_rng(3)
    reqs = [{"input": rng.integers(-128, 128, (96, 96, 3)).astype(np.int8)}
            for _ in range(5)]
    eng = pd.engine(micro_batch=2)
    outs = eng.serve(reqs)
    assert len(outs) == 5
    assert eng.stats.dispatches == 3
    assert eng.stats.padded_lanes == 1      # 5 requests over 3 x 2 lanes
    assert eng.stats.requests == 5
    for r, o in zip(reqs, outs):
        one = pd.run(r)
        want = jd.run(r)
        for name in o:
            np.testing.assert_array_equal(o[name], one[name])
            np.testing.assert_array_equal(o[name], want[name])
    assert [list(o) for o in pd.serve(reqs, micro_batch=2)] == \
        [list(o) for o in outs]


# ------------------------------------------------------- typed rejections
def _float_cnn() -> Graph:
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", 8, 8, 3)
    x = b.conv(x, 4, k=3)
    y = b.fc(x, 4)
    g.set_outputs([y])
    return g


@pytest.fixture(scope="module")
def d_float():
    return deploy.build(_float_cnn(), device="cpu")


def _good(d, seed=0):
    return random_input(d.exec_graph, seed=seed)


def _bad_inputs(d, case):
    x = _good(d)
    name, val = next(iter(x.items()))
    if case == "non_dict":
        return [1, 2, 3]
    if case == "missing":
        return {}
    if case == "unknown":
        x["not_a_tensor"] = np.zeros(1, np.float32)
    elif case == "produced":
        x[d.exec_graph.outputs[0]] = np.zeros(1, np.float32)
    elif case == "float64":
        x[name] = np.asarray(val, np.float64)
    elif case == "int32":
        x[name] = np.zeros(val.shape, np.int32)
    elif case == "flatten":
        x[name] = np.ascontiguousarray(val.reshape(-1))
    elif case == "count":
        x[name] = np.zeros(3, np.float32)
    elif case == "nan":
        val = np.array(val)
        val.flat[0] = np.nan
        x[name] = val
    return x


@pytest.mark.parametrize("case,match", [
    ("non_dict", "must be a dict"),
    ("missing", "missing graph inputs"),
    ("unknown", "unknown input tensor 'not_a_tensor'"),
    ("produced", "is produced by"),
    ("float64", "float64.*declares float32"),
    ("int32", "int32"),
    ("flatten", "refusing the silent flatten"),
    ("count", "elements"),
    ("nan", "non-finite"),
])
def test_validate_inputs_rejections(d_float, case, match):
    bad = _bad_inputs(d_float, case)
    with pytest.raises(InputValidationError, match=match):
        d_float.validate_inputs(bad)
    with pytest.raises(ReproError):
        d_float.run(bad)


def test_float_input_on_int8_graph_names_quantize_hint(pair):
    _, pd, _, x = pair
    with pytest.raises(InputValidationError, match="quantize_inputs"):
        pd.run({"input": x["input"]})


def test_strictness_and_fault_hooks():
    g = _float_cnn()
    with pytest.raises(BudgetUnreachableError, match="budget missed"):
        deploy.build(g, arena_budget=1, device="cpu")
    d = deploy.build(g, arena_budget=1, strict=False, guard_bytes=8,
                     device="cpu")
    assert any("arena budget missed" in n for n in d.degraded)
    x = _good(d, seed=2)
    clean = d.run(x)
    # a transient device error is retried and the answer is unchanged
    out = d.run(x, faults=FaultPlan(seed=1, device_error_rate=0.5))
    np.testing.assert_array_equal(out[g.outputs[0]], clean[g.outputs[0]])
    # arena corruption lands in a guard region and is caught, not served
    with pytest.raises(GuardViolation):
        d.run(x, faults=FaultPlan(seed=0, corrupt_rate=1.0))


# --------------------------------------------------------------- goldens
def test_mobilenet_100_192_goldens_through_the_ported_core():
    q = int8_scheduling_graph(mobilenet_v1_graph(1.0, 192))
    assert schedule(q).peak == 884736
    res = schedule(q, arena_budget=512 * KB)
    gp = res.graph if res.graph is not None else q
    plan = ArenaPlanner.plan(gp, res.schedule)
    ArenaPlanner.validate(plan, gp)
    assert res.method == "default+pex"
    assert res.peak == plan.arena_size == 322560
