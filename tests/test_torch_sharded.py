"""The port's sharded continuous-batching engine
(``repro_torch.serving.ShardedServingEngine``) against the reference's,
on the CPU: twins of ``tests/test_serving_engine.py``'s admission-order
invariance tests and of the chaos suite ``tests/test_chaos.py``, on the
same graphs (weights and qparams carried from the reference) with the
same seeds.

* Whatever the arrival interleaving, every output is bit-identical to a
  one-shot ``Deployment.run`` of that request, and the int8 outputs are
  bit-identical to the reference ``ShardedServingEngine``'s (float ones
  within the executors' tolerance).
* ``force_host_devices(3)`` gives three host replicas: capacity 6, every
  replica with its own arena, outputs bit-identical to the reference's
  3-replica run (a subprocess with a forced 3-device host mesh).
* The chaos invariant: every request ends as a result or a typed
  ``RequestError``, counters exact; the seeded sweep's codes, counters and
  fault ledger equal the reference engine's on the same seed.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.deploy as jax_deploy
from repro.core.graph import Graph as JaxGraph
from repro.graphs import figure1_int8_graph as jax_fig1_int8
from repro.graphs.cnn_ops import CNNBuilder as JaxBuilder
from repro.serving import FaultInjector as JaxFaultInjector
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import RequestError as JaxRequestError
from repro.serving import ShardedServingEngine as JaxSharded

import repro_torch.deploy as deploy
from repro_torch.core.graph import Graph
from repro_torch.errors import (BudgetUnreachableError, DeviceInitError,
                                DispatchFailedError, GuardViolation,
                                NaNActivationError)
from repro_torch.graphs import figure1_int8_graph, random_input
from repro_torch.graphs.cnn_ops import CNNBuilder
from repro_torch.mcu.compile import CANARY_BYTE
from repro_torch.serving import (FaultInjector, FaultPlan, GraphServingEngine,
                                 RequestError, ShardedServingEngine,
                                 force_host_devices)

from test_torch_params import int8_twins, twin

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

_F32 = dict(rtol=2e-5, atol=1e-6)


def _serving_cnn(graph_cls, builder_cls):
    """``tests/test_serving_engine.py``'s tiny CNN."""
    g = graph_cls()
    b = builder_cls(g)
    x = b.input("input", 12, 12, 3)
    x = b.conv(x, 6, k=3)
    y = b.maxpool(x, k=2, stride=2)
    y = b.conv(y, 6, k=1)
    y = b.avgpool(y)
    y = b.fc(y, 4)
    g.set_outputs([y])
    return g


def _chaos_cnn(graph_cls, builder_cls):
    """``tests/test_chaos.py``'s tiny CNN."""
    g = graph_cls()
    b = builder_cls(g)
    x = b.input("input", 12, 12, 3)
    x = b.conv(x, 6, k=3)
    y = b.maxpool(x, k=2, stride=2)
    y = b.fc(y, 4)
    g.set_outputs([y])
    return g


def _pair(which):
    """(reference graph, port graph with its weights and qparams)."""
    if which == "figure1_int8":
        return jax_fig1_int8(), figure1_int8_graph()
    jf = _serving_cnn(JaxGraph, JaxBuilder)
    pf = _serving_cnn(Graph, CNNBuilder)
    if which == "tiny_cnn_int8":
        jq, pq = int8_twins(jf, pf, random_input(pf))
        return jq.graph, pq.graph
    return jf, twin(jf, pf)


_GRID = ("figure1_int8", "tiny_cnn_int8", "tiny_cnn_f32")


def _requests(g, n, seed0=0):
    return [random_input(g, seed=seed0 + i) for i in range(n)]


def _same(got, want, exact):
    for name in want:
        if exact:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
        else:
            np.testing.assert_allclose(got[name], want[name], **_F32)


@pytest.fixture
def host_devices():
    """``force_host_devices`` for one test, set back to 1 after it."""
    yield force_host_devices
    force_host_devices(1)


# ---------------------------------------------- admission-order invariance
@pytest.mark.parametrize("name", _GRID)
def test_sharded_outputs_invariant_under_interleaving(name):
    """Per-request outputs are bit-identical to one-shot Deployment.run
    under every interleaving, and equal to the reference engine's."""
    jg, g = _pair(name)
    exact = name.endswith("int8")
    d = deploy.build(g, device="cpu")
    reqs = _requests(g, 7, seed0=11)
    refs = [d.run(r) for r in reqs]
    jouts = JaxSharded(jax_deploy.build(jg), replicas=1, lanes=2).serve(reqs)

    eng = ShardedServingEngine(d, lanes=2)
    assert eng.replicas == 1 and eng.capacity == 2

    # interleaving A: everything up front (one-shot serve, ragged tail)
    outs = eng.serve(reqs)
    for ref, o, jo in zip(refs, outs, jouts):
        _same(o, ref, exact=True)
        _same(o, {t: np.asarray(v) for t, v in jo.items()}, exact)
    assert (eng.stats.dispatches, eng.stats.padded_lanes) == (4, 1)

    # interleaving B: late arrivals join later dispatch boundaries
    rids = [eng.submit(reqs[0]), eng.submit(reqs[1])]
    eng.step()                               # boundary: 0,1 complete
    rids += [eng.submit(r) for r in reqs[2:5]]
    eng.step()                               # boundary: 2,3 (lanes=2) ...
    rids += [eng.submit(r) for r in reqs[5:]]
    done = eng.drain()
    assert sorted(done) == sorted(rids)
    for ref, rid in zip(refs, rids):
        _same(done[rid], ref, exact=True)
    st = eng.stats
    assert st.requests == 7 and st.dispatches >= 3

    # interleaving C: mixed priorities, admitted by (priority, arrival)
    prio = [0, 3, 1, 3, 0, 2, 1]
    rids = [eng.submit(r, priority=p) for r, p in zip(reqs, prio)]
    first = eng.step()
    assert first == 2 and set(eng._results) == {rids[1], rids[3]}
    done = eng.drain()
    for ref, rid in zip(refs, rids):
        _same(done[rid], ref, exact=True)


def test_sharded_admission_is_fifo_at_boundaries():
    g = figure1_int8_graph()
    d = deploy.build(g, device="cpu")
    eng = ShardedServingEngine(d, lanes=2)
    a = eng.submit(random_input(g, seed=1))
    b = eng.submit(random_input(g, seed=2))
    c = eng.submit(random_input(g, seed=3))
    done_now = eng.step()                    # capacity 2: admits a, b only
    assert done_now == 2
    assert eng.pending == 1
    out_a = eng.take(a)
    out_b = eng.take(b)
    out_c = eng.drain()[c]                  # drain returns what's left
    for out, seed in ((out_a, 1), (out_b, 2), (out_c, 3)):
        _same(out, d.run(random_input(g, seed=seed)), exact=True)


def test_sharded_rejects_build_opts_on_deployment():
    d = deploy.build(figure1_int8_graph(), device="cpu")
    with pytest.raises(ValueError, match="already a Deployment"):
        ShardedServingEngine(d, arena_budget=1024)


def test_engine_facade_picks_the_engine(host_devices):
    d = deploy.build(figure1_int8_graph(), device="cpu")
    assert isinstance(d.engine(micro_batch=2), GraphServingEngine)
    host_devices(2)
    every = d.engine(micro_batch=3, replicas=0)
    assert isinstance(every, ShardedServingEngine)
    assert (every.replicas, every.lanes, every.capacity) == (2, 3, 6)
    assert d.engine(micro_batch=2, replicas=1).replicas == 1


_REFERENCE_3_REPLICAS = """
import sys
from repro.serving import force_host_devices
force_host_devices(3)
import jax
assert jax.local_device_count() == 3, jax.devices()
import numpy as np
import repro.deploy as deploy
from repro.graphs import figure1_int8_graph, random_input
from repro.serving import ShardedServingEngine

g = figure1_int8_graph()
reqs = [random_input(g, seed=20 + i) for i in range(8)]
eng = ShardedServingEngine(deploy.build(g), replicas=3, lanes=2)
outs = eng.serve(reqs)
st = eng.stats
assert (st.dispatches, st.padded_lanes, st.requests) == (2, 4, 8)
np.savez(sys.argv[1], *[np.asarray(o["t7"]) for o in outs])
"""


def test_three_host_replicas_equal_the_reference_mesh(host_devices,
                                                     tmp_path, monkeypatch):
    """``force_host_devices(3)``: three replicas, each its own arena, and
    every output bit-identical to the reference's 3-device host mesh."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    npz = tmp_path / "reference.npz"
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_3_REPLICAS,
                             str(npz)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    g = figure1_int8_graph()
    d = deploy.build(g, device="cpu")
    reqs = _requests(g, 8, seed0=20)
    refs = [d.run(r) for r in reqs]
    host_devices(3)
    eng = ShardedServingEngine(d, lanes=2)          # replicas=None: all 3
    assert eng.replicas == 3 and eng.capacity == 6
    assert ShardedServingEngine(d, replicas=5, lanes=2).replicas == 3
    prog = eng._fn
    assert len({id(p.arena) for p in prog.programs}) == 3
    # each replica's lanes as its program starts
    started = {r: [] for r in range(3)}
    for r, p in enumerate(prog.programs):
        run = p.executor.execute
        monkeypatch.setattr(p.executor, "execute", lambda a, r=r, run=run: (
            started[r].append(a.clone()), run(a))[1])
    outs = eng.serve(reqs)                  # 8 over capacity 6: ragged 2nd
    for ref, o in zip(refs, outs):
        _same(o, ref, exact=True)
    st = eng.stats
    assert (st.dispatches, st.padded_lanes, st.requests) == (2, 4, 8)
    # the last dispatch wrote requests 6, 7 into replica 0: replicas 1 and
    # 2 ran pad lanes only, each all zero as it started
    pad = d.executor.pad_arena()
    assert not pad.any() and pad.shape == (d.executor.pitch,)
    assert all(len(v) == 2 for v in started.values())
    for r in (1, 2):
        assert all(torch.equal(lane, pad) for lane in started[r][1])
    assert all(lane.any() for lane in started[0][1])

    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    with np.load(npz) as ref3:
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o["t7"], ref3[f"arr_{i}"])


def test_more_replicas_than_devices_is_refused(host_devices):
    ex = deploy.build(figure1_int8_graph(), device="cpu").executor
    with pytest.raises(DeviceInitError, match="force_host_devices"):
        ex.replicated_fn(2, 2)
    host_devices(2)
    assert ex.replicated_fn(2, 2).capacity == 4
    with pytest.raises(ValueError, match="at least one host device"):
        force_host_devices(0)


# ------------------------------------------------------------- the chaos suite
class FakeClock:
    """Injectable clock: time moves only when the test says so."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def d_int8():
    return deploy.build(figure1_int8_graph(), device="cpu")


@pytest.fixture(scope="module")
def chaos_pair():
    jf = _chaos_cnn(JaxGraph, JaxBuilder)
    return jf, twin(jf, _chaos_cnn(Graph, CNNBuilder))


@pytest.fixture(scope="module")
def d_float(chaos_pair):
    return deploy.build(chaos_pair[1], device="cpu")


@pytest.fixture(scope="module")
def d_float_guarded(chaos_pair):
    return deploy.build(chaos_pair[1], guard_bytes=32, device="cpu")


def _reqs(g, n, seed0=0):
    return [random_input(g, seed=seed0 + i) for i in range(n)]


def _assert_ok_lanes_bit_identical(d, reqs, results):
    """Every non-error result must equal the fault-free reference exactly
    — the 'no silent wrong answer' half of the chaos invariant."""
    for r, out in zip(reqs, results):
        if isinstance(out, RequestError):
            continue
        _same(out, d.run(r), exact=True)


def test_no_fault_config_is_byte_identical_and_counts_zero(d_int8):
    g = d_int8.exec_graph
    reqs = _reqs(g, 5, seed0=31)
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2)
    outs = eng.serve(reqs)
    _assert_ok_lanes_bit_identical(d_int8, reqs, outs)
    s = eng.stats
    assert s.admitted == 5
    assert (s.expired, s.shed, s.retried, s.failed,
            s.watchdog_trips) == (0, 0, 0, 0, 0)
    assert s.degraded is None
    j = s.as_json()
    for k in ("expired", "shed", "retried", "failed"):
        assert j[k] == 0


def test_chaos_sweep_every_fault_accounted(chaos_pair):
    """The headline invariant on the reference's seed, and the port's
    codes, counters and fault ledger equal to the reference engine's."""
    jf, pf = chaos_pair
    d = deploy.build(pf, guard_bytes=32, device="cpu")
    g = d.exec_graph
    plan = dict(seed=42, device_error_rate=0.15, corrupt_rate=0.25,
                nan_rate=0.25)
    inj = FaultInjector(FaultPlan(**plan))
    eng = ShardedServingEngine(d, replicas=1, lanes=2, max_retries=2,
                               faults=inj)
    reqs = _reqs(g, 12, seed0=7)
    rids = [eng.submit(r) for r in reqs]
    done = eng.drain()
    results = [done[rid] for rid in rids]
    s = eng.stats

    assert len(results) == 12
    codes = [r.code if isinstance(r, RequestError) else "ok"
             for r in results]
    assert set(codes) <= {"ok", "corrupted", "nan_output",
                          "dispatch_failed"}
    _assert_ok_lanes_bit_identical(d, reqs, results)
    led = inj.injected
    assert led["device_error"] > 0 and led["corrupt"] > 0 \
        and led["nan"] > 0
    poison_failed = sum(1 for c in codes if c in ("corrupted",
                                                  "nan_output"))
    assert codes.count("dispatch_failed") == 0
    assert s.retried == led["device_error"] + \
        (led["corrupt"] + led["nan"] - poison_failed)
    assert s.failed == poison_failed

    jinj = JaxFaultInjector(JaxFaultPlan(**plan))
    jeng = JaxSharded(jax_deploy.build(jf, guard_bytes=32), replicas=1,
                      lanes=2, max_retries=2, faults=jinj)
    jdone = jeng.serve(reqs)
    assert [r.code if isinstance(r, JaxRequestError) else "ok"
            for r in jdone] == codes
    assert jinj.injected == led
    assert jeng.stats.as_json()["retried"] == s.retried
    assert jeng.stats.failed == s.failed
    for jo, o in zip(jdone, results):
        if not isinstance(o, RequestError):
            _same(o, {t: np.asarray(v) for t, v in jo.items()}, exact=False)


def test_guard_build_bit_identical_and_regions_planned(d_float,
                                                       d_float_guarded):
    g = d_float.exec_graph
    assert d_float.executor.guard_regions == ()
    assert d_float.guard_bytes == 0
    regions = d_float_guarded.executor.guard_regions
    assert regions and d_float_guarded.guard_bytes == 32
    assert d_float_guarded.arena_bytes >= d_float.arena_bytes
    for seed in range(3):
        x = random_input(g, seed=seed)
        _same(d_float_guarded.run(x), d_float.run(x), exact=True)


def test_guard_regions_are_complement_of_placements(d_float_guarded):
    plan = d_float_guarded.plan
    spans = sorted((p.offset, p.offset + p.size) for p in plan.placements)
    for off, size in plan.guard_regions():
        for lo, hi in spans:
            assert off + size <= lo or off >= hi, \
                f"guard [{off},{off + size}) overlaps placement [{lo},{hi})"


def test_guard_canary_detects_stomp(d_float_guarded):
    ex = d_float_guarded.executor
    x = random_input(d_float_guarded.exec_graph, seed=3)
    arena = ex.fn([x])[0].to("cpu", copy=True).numpy()
    ex.verify_guards(arena)                     # clean run passes
    off, size = ex.guard_regions[0]
    assert int(arena[off]) == CANARY_BYTE
    arena[off] ^= 0xFF
    with pytest.raises(GuardViolation, match=str(off)):
        ex.verify_guards(arena)


def test_guarded_golden_graph_serving(d_int8):
    dg = deploy.build(figure1_int8_graph(), guard_bytes=16, device="cpu")
    assert dg.executor.guard_regions
    reqs = _reqs(dg.exec_graph, 4, seed0=50)
    outs = ShardedServingEngine(dg, replicas=1, lanes=2).serve(reqs)
    _assert_ok_lanes_bit_identical(d_int8, reqs, outs)


def test_guard_corruption_detected_by_genuine_canary_check(chaos_pair):
    d = deploy.build(chaos_pair[1], guard_bytes=32, device="cpu")
    eng = ShardedServingEngine(
        d, replicas=1, lanes=2, max_retries=0,
        faults=FaultPlan(seed=9, corrupt_rate=1.0))
    outs = eng.serve(_reqs(d.exec_graph, 2, seed0=70))
    assert all(isinstance(o, RequestError) and o.code == "corrupted"
               for o in outs)
    assert eng.stats.failed == 2 and eng.stats.retried == 0


def test_guardless_corruption_surfaces_as_ecc_signal(d_int8):
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2, max_retries=0,
                               faults=FaultPlan(seed=4, corrupt_rate=1.0))
    outs = eng.serve(_reqs(d_int8.exec_graph, 2, seed0=80))
    assert all(isinstance(o, RequestError) and o.code == "corrupted"
               for o in outs)


def test_fault_path_leaves_the_static_arena_alone(d_float):
    """Poison goes into host copies: the replica's arena still holds the
    clean outputs after a dispatch whose every lane was poisoned."""
    eng = ShardedServingEngine(d_float, replicas=1, lanes=2, max_retries=0,
                               faults=FaultPlan(seed=2, nan_rate=1.0))
    reqs = _reqs(d_float.exec_graph, 2, seed0=90)
    eng.serve(reqs)
    arena = eng._fn.programs[0].arena
    for lane, r in enumerate(reqs):
        _same(d_float.executor.outputs_from(arena, lane), d_float.run(r),
              exact=True)


def test_nan_poison_detected_by_output_scan(d_float):
    eng = ShardedServingEngine(d_float, replicas=1, lanes=2, max_retries=0,
                               faults=FaultPlan(seed=2, nan_rate=1.0))
    outs = eng.serve(_reqs(d_float.exec_graph, 2, seed0=90))
    assert all(isinstance(o, RequestError) and o.code == "nan_output"
               for o in outs)


def test_transient_device_errors_retried_to_success(d_int8):
    eng = ShardedServingEngine(
        d_int8, replicas=1, lanes=2, max_retries=3,
        faults=FaultPlan(seed=11, device_error_rate=0.3))
    reqs = _reqs(d_int8.exec_graph, 8, seed0=100)
    outs = eng.serve(reqs)
    _assert_ok_lanes_bit_identical(d_int8, reqs, outs)
    assert not any(isinstance(o, RequestError) for o in outs)
    s = eng.stats
    assert s.retried > 0 and s.failed == 0


def test_persistent_device_error_becomes_typed_failure(d_int8):
    eng = ShardedServingEngine(
        d_int8, replicas=1, lanes=2, max_retries=1,
        faults=FaultPlan(seed=5, device_error_rate=1.0))
    outs = eng.serve(_reqs(d_int8.exec_graph, 2, seed0=110))
    assert all(isinstance(o, RequestError) and o.code == "dispatch_failed"
               for o in outs)
    s = eng.stats
    assert s.failed == 2 and s.retried == 2


def test_watchdog_converts_slow_device_to_typed_failure(d_int8):
    eng = ShardedServingEngine(
        d_int8, replicas=1, lanes=2, max_retries=1, dispatch_timeout=0.005,
        faults=FaultPlan(seed=6, slow_rate=1.0, slow_s=0.03))
    outs = eng.serve(_reqs(d_int8.exec_graph, 2, seed0=120))
    assert all(isinstance(o, RequestError) and o.code == "dispatch_failed"
               for o in outs)
    s = eng.stats
    assert s.watchdog_trips == 2 and s.failed == 2


def test_deadline_expiry_fake_clock_never_executes(d_int8):
    clk = FakeClock(0.0)
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2, clock=clk)
    g = d_int8.exec_graph
    stale = [eng.submit(random_input(g, seed=i), deadline=1.0)
             for i in range(2)]
    fresh = eng.submit(random_input(g, seed=9), deadline=100.0)
    clk.t = 5.0
    eng.step()
    for rid in stale:
        err = eng.take(rid)
        assert isinstance(err, RequestError) and err.code == "expired"
        assert "deadline" in err.detail
    done = eng.drain()
    assert not isinstance(done[fresh], RequestError)
    s = eng.stats
    assert s.expired == 2 and s.admitted == 1 and s.dispatches == 1


def test_all_expired_step_dispatches_nothing(d_int8):
    clk = FakeClock(0.0)
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2, clock=clk)
    rid = eng.submit(random_input(d_int8.exec_graph, seed=1), deadline=0.5)
    clk.t = 2.0
    assert eng.step() == 0
    assert isinstance(eng.take(rid), RequestError)
    eng.drain()
    assert eng.stats.dispatches == 0 and eng.stats.expired == 1


def test_shedding_beyond_max_pending_exact(d_int8):
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2, max_pending=2)
    g = d_int8.exec_graph
    reqs = _reqs(g, 4, seed0=130)
    rids = [eng.submit(r) for r in reqs]
    shed = [eng.take(rid) for rid in rids[2:]]
    assert all(isinstance(e, RequestError) and e.code == "shed"
               for e in shed)
    done = eng.drain()
    _assert_ok_lanes_bit_identical(d_int8, reqs[:2],
                                   [done[r] for r in rids[:2]])
    s = eng.stats
    assert s.shed == 2 and s.admitted == 2 and s.failed == 0


def test_priority_orders_admission_within_capacity(d_int8):
    clk = FakeClock(0.0)
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2, clock=clk)
    g = d_int8.exec_graph
    low = [eng.submit(random_input(g, seed=1)),
           eng.submit(random_input(g, seed=2))]
    high = [eng.submit(random_input(g, seed=3), priority=5),
            eng.submit(random_input(g, seed=4), priority=5)]
    eng.step()
    for rid in high:
        assert rid in eng._results and not isinstance(
            eng._results[rid], RequestError)
    for rid in low:
        assert rid not in eng._results
    eng.drain()


def test_engine_init_failure_degrades_to_single_device(d_int8):
    eng = ShardedServingEngine(d_int8, replicas=1, lanes=2,
                               faults=FaultPlan(fail_engine_init=True))
    reqs = _reqs(d_int8.exec_graph, 3, seed0=140)
    outs = eng.serve(reqs)
    _assert_ok_lanes_bit_identical(d_int8, reqs, outs)
    s = eng.stats
    assert s.degraded and any("falling back to single-device" in n
                              for n in s.degraded)
    assert (eng.replicas, s.dispatches, s.padded_lanes) == (1, 2, 1)


def test_engine_init_failure_strict_raises(d_int8):
    with pytest.raises(DeviceInitError):
        ShardedServingEngine(d_int8, replicas=1, lanes=2,
                             fallback_single_device=False,
                             faults=FaultPlan(fail_engine_init=True))


def test_build_nonstrict_budget_miss_degrades():
    g = figure1_int8_graph()
    with pytest.raises(BudgetUnreachableError, match="strict=False"):
        deploy.build(g, arena_budget=1, device="cpu")
    d = deploy.build(g, arena_budget=1, strict=False, device="cpu")
    assert d.degraded and any("arena budget missed" in n
                              for n in d.degraded)
    eng = ShardedServingEngine(d, replicas=1, lanes=2)
    eng.serve(_reqs(d.exec_graph, 1, seed0=150))
    assert any("arena budget missed" in n for n in eng.stats.degraded)


def test_deployment_run_guard_violation(chaos_pair):
    d = deploy.build(chaos_pair[1], guard_bytes=32, device="cpu")
    x = random_input(d.exec_graph, seed=1)
    with pytest.raises(GuardViolation, match="arena byte"):
        d.run(x, faults=FaultPlan(seed=1, corrupt_rate=1.0))
    d.run(x)


def test_deployment_run_nan_detection(d_float):
    x = random_input(d_float.exec_graph, seed=2)
    with pytest.raises(NaNActivationError, match="NaN"):
        d_float.run(x, faults=FaultPlan(seed=2, nan_rate=1.0))


def test_deployment_run_retries_then_fails_typed(d_int8):
    x = random_input(d_int8.exec_graph, seed=3)
    ref = d_int8.run(x)
    out = d_int8.run(x, faults=FaultPlan(seed=8, device_error_rate=0.3))
    _same(out, ref, exact=True)
    with pytest.raises(DispatchFailedError):
        d_int8.run(x, faults=FaultPlan(seed=8, device_error_rate=1.0))


def test_graph_engine_retries_and_guards(d_int8):
    g = d_int8.exec_graph
    reqs = _reqs(g, 6, seed0=160)
    eng = GraphServingEngine(
        deployment=d_int8, micro_batch=2,
        faults=FaultPlan(seed=3, device_error_rate=0.5), max_retries=4)
    outs = eng.serve(reqs)
    _assert_ok_lanes_bit_identical(d_int8, reqs, outs)
    assert eng.stats.retried > 0 and eng.stats.admitted == 6

    dg = deploy.build(figure1_int8_graph(), guard_bytes=16, device="cpu")
    outs2 = GraphServingEngine(deployment=dg, micro_batch=2).serve(reqs)
    _assert_ok_lanes_bit_identical(d_int8, reqs, outs2)
