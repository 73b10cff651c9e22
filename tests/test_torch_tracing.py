"""The port's own spans and counters (``repro_torch.tracing``): no span
while tracing is off, the serving and build spans nested as documented
while it is on, the executors' and the engine's running counters, the
build's phase times, ``EngineStats`` taken from the counters, and the
client edge's host quantize counted beside its work."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.deploy as deploy
from repro_torch import cuda_graphs, tracing
from repro_torch.core.graph import Graph
from repro_torch.graphs import random_input
from repro_torch.graphs.cnn_ops import CNNBuilder
from repro_torch.kernels.host_quant import quantize_int8
from repro_torch.serving import ShardedServingEngine
from repro_torch.serving.sharded import ENGINE_COUNTERS

from test_torch_capture import _fake_cuda

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

LANES, REQUESTS = 4, 6
# the plain schedule needs 13 824 B: Pex fires, the cascades do not
BUDGET = 8000
BUILD = dict(quantize=True, arena_budget=BUDGET, solver_nodes=500,
             device="cpu")


def _float_cnn() -> Graph:
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", 24, 24, 3)
    x = b.conv(x, 8, k=3)
    x = b.dwconv(x)
    x = b.conv(x, 16)
    x = b.dwconv(x, stride=2)
    x = b.conv(x, 16)
    y = b.fc(b.avgpool(x), 10)
    g.set_outputs([y])
    return g


@pytest.fixture(scope="module")
def dep():
    return deploy.build(_float_cnn(), **BUILD)


@pytest.fixture
def traced():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


def _images(n, seed0=0):
    g = _float_cnn()
    return [random_input(g, seed=seed0 + i) for i in range(n)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("rt.")]


def _serve(d, images):
    eng = ShardedServingEngine(d, replicas=1, lanes=LANES)
    before = eng.counters
    outs = eng.serve([d.quantize_inputs(x) for x in images])
    after = eng.counters
    return eng, outs, {k: after[k] - before.get(k, 0) for k in after}


def _parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("rt."):
        p = p.cpu_parent
    return p.name if p is not None else None


def test_no_span_while_tracing_is_off(dep):
    assert tracing.span("a") is tracing.span("b")     # one shared no-op
    _, spans = _profiled(lambda: _serve(dep, _images(REQUESTS)))
    assert spans == []
    _, spans = _profiled(lambda: deploy.build(_float_cnn(), **BUILD))
    assert spans == []


def test_serving_spans_nest_under_each_dispatch(dep, traced):
    (_, outs, _), spans = _profiled(lambda: _serve(dep, _images(REQUESTS)))
    assert len(outs) == REQUESTS
    names = [e.name for e in spans]
    assert names.count("rt.quantize_inputs") == REQUESTS
    dispatches = [e for e in spans if e.name == "rt.dispatch"]
    assert len(dispatches) == 2
    children = ("rt.admit", "rt.write_inputs", "rt.run", "rt.read_outputs")
    for d in dispatches:
        kids = [e.name for e in spans if e.cpu_parent is d]
        assert sorted(kids) == sorted(children)
    for e in spans:
        if e.name in children:
            assert _parent(e) == "rt.dispatch"
    # no card: nothing to wait for, nothing captured
    assert "rt.wait" not in names and "rt.capture" not in names


def test_counters_count_where_the_work_happens(dep):
    images = _images(REQUESTS, seed0=10)
    eng, outs, moved = _serve(dep, images)
    in_bytes = dep.quantize_inputs(images[0])["input"].nbytes
    out_bytes = sum(v.nbytes for v in outs[0].values())
    assert in_bytes == 24 * 24 * 3
    # one upload and one download a dispatch (the staged rows); their
    # bytes are the admitted requests' inputs and outputs
    assert moved == {"dispatches": 2, "admitted": 6, "completed": 6,
                     "pad_lanes": 2, "lanes_written": 6, "uploads": 2,
                     "upload_bytes": 6 * in_bytes, "downloads": 2,
                     "download_bytes": 6 * out_bytes, "replays": 0,
                     "captures": 0, "retried": 0, "failed": 0,
                     "watchdog_trips": 0, "run_ahead": 0}
    # the counters only grow; drain's stats are their differences
    st = eng.stats
    assert (st.dispatches, st.padded_lanes, st.admitted, st.requests) == \
        (2, 2, 6, 6)
    eng.serve([dep.quantize_inputs(x) for x in images[:3]])
    st = eng.stats
    assert (st.dispatches, st.padded_lanes, st.admitted, st.requests) == \
        (1, 1, 3, 3)
    assert eng.counters["dispatches"] == 3
    assert eng.counters["pad_lanes"] == 3


class _Event:
    """A card's event, stood in for on the CPU: each record and wait is
    logged as ("record" | "wait", staging pair)."""

    def __init__(self, log, pair):
        self.log, self.pair = log, pair

    def record(self, stream=None):
        self.log.append(("record", self.pair))

    def synchronize(self):
        self.log.append(("wait", self.pair))


def test_run_ahead_is_counted_and_waits_under_each_dispatch(
        dep, traced, monkeypatch):
    """``run_ahead`` is an engine counter, read through ``counters``.
    With events on the program's two staging pairs, a step launches the
    next full batch into the other pair, then waits in ``rt.wait``, under
    ``rt.dispatch``, on the older dispatch's event alone."""
    assert "run_ahead" in ENGINE_COUNTERS
    eng = ShardedServingEngine(dep, replicas=1, lanes=LANES)
    prog, log = eng._fn.programs[0], []
    monkeypatch.setattr(prog, "_done", [_Event(log, 0), _Event(log, 1)])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    a = prog._launched % 2            # the pair the next dispatch takes
    b = 1 - a
    before = eng.counters
    for x in _images(3 * LANES, seed0=40):
        eng.submit(dep.quantize_inputs(x))

    def steps():
        logs = []
        while eng.pending:
            eng.step()
            logs.append(log[:])
            del log[:]
        return logs
    logs, spans = _profiled(steps)
    w, r = "wait", "record"
    # each launch waits for its pair's last transfers, then records; each
    # finish waits on the finished dispatch's pair
    assert logs == [[(w, a), (r, a), (w, b), (r, b), (w, a)],
                    [(w, a), (r, a), (w, b)],
                    [(w, a)]]
    after = eng.counters
    assert (after["run_ahead"] - before["run_ahead"],
            after["dispatches"] - before["dispatches"]) == (2, 3)
    waits = [e for e in spans if e.name == "rt.wait"]
    assert len(waits) == 3
    assert all(_parent(e) == "rt.dispatch" for e in waits)
    assert len([e for e in spans if e.name == "rt.dispatch"]) == 3


def _host_quant_counts():
    return quantize_int8.calls, quantize_int8.elements


def test_host_quantize_counts_each_quantized_request(dep):
    """The client edge's host kernel counts one call and the image's
    elements a request that ``quantize_inputs`` quantizes."""
    images = _images(REQUESTS, seed0=20)
    calls, elements = _host_quant_counts()
    _serve(dep, images)
    assert _host_quant_counts() == (calls + REQUESTS,
                                    elements + REQUESTS * 24 * 24 * 3)


def test_host_quantize_counts_nothing_for_a_float32_deployment():
    d = deploy.build(_float_cnn(), device="cpu")
    assert d.qmodel is None
    images = _images(REQUESTS, seed0=30)
    before = _host_quant_counts()
    eng, outs, _ = _serve(d, images)
    assert len(outs) == REQUESTS
    assert _host_quant_counts() == before


def test_host_quantize_is_not_a_kernel_wrapper():
    """The launch guard sums the card's launches over
    ``kernel_wrappers()``: a host call counted there would blank it."""
    wrappers = cuda_graphs.kernel_wrappers()
    assert quantize_int8 not in wrappers.values()
    assert not any("quantize" in name for name in wrappers)


def test_build_phases_and_rungs(traced):
    d, spans = _profiled(lambda: deploy.build(_float_cnn(), **BUILD))
    assert "pex" in d.schedule_result.method
    ps = d.phase_s
    rungs = {k for k in ps if k.startswith("rung.")}
    assert {"calibrate", "schedule", "plan", "compile"} <= set(ps)
    assert set(ps) == rungs | {"calibrate", "schedule", "plan", "compile"}
    assert {"rung.reorder", "rung.pex"} <= rungs
    assert "rung.cascade" not in rungs        # Pex met the budget
    assert sum(ps[k] for k in rungs) <= ps["schedule"]
    assert all(v >= 0 for v in ps.values())
    # one span per rung that ran, under rt.schedule, under rt.build
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(e)
    assert {n[3:] for n in by_name if n.startswith("rt.rung.")} == rungs
    for n in rungs:
        assert [_parent(e) for e in by_name["rt." + n]] == ["rt.schedule"]
    for n in ("calibrate", "schedule", "plan", "compile"):
        assert [_parent(e) for e in by_name["rt." + n]] == ["rt.build"]
    assert [_parent(e) for e in by_name["rt.build"]] == [None]


def test_every_rung_of_the_ladder_is_timed():
    # a budget nothing meets: the ladder climbs every rung
    d = deploy.build(_float_cnn(), quantize=True, arena_budget=64,
                     strict=False, solver_nodes=50, device="cpu")
    assert any("arena budget missed" in n for n in d.degraded)
    ps = d.phase_s
    assert {k for k in ps if k.startswith("rung.")} == {
        "rung.reorder", "rung.pex", "rung.cascade", "rung.cascade2d",
        "rung.solver"}
    assert sum(v for k, v in ps.items() if k.startswith("rung.")) \
        <= ps["schedule"]


def test_capture_is_counted_once_and_exposed(monkeypatch, traced):
    _fake_cuda(monkeypatch)
    d = deploy.build(_float_cnn(), **BUILD)
    eng = ShardedServingEngine(d, replicas=1, lanes=LANES)
    assert eng.capture_s == 0.0
    prog = d.executor.batched_fn(LANES)
    _, spans = _profiled(lambda: (prog.capture(), prog.capture()))
    assert [e.name for e in spans] == ["rt.capture"]
    assert eng.counters["captures"] == 1
    g = prog.graph
    assert eng.capture_s == pytest.approx(
        (g.capture_ms + g.warmup_ms) / 1e3)
