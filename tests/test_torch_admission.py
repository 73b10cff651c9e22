"""Twins of ``tests/test_admission.py`` for the port's copy of the
admission queue (``repro_torch.serving.admission``), plus the same event
streams through the port's and the reference's queues side by side.

Property tests for the admission queue against a
reference model: priority order within deadlines, expired requests never
admitted, shed counts exact under random interleavings, FIFO at equal
priority (so the default queue is bit-for-bit the old FIFO), and requeue
fairness.  Hypothesis drives the random interleavings when installed; the
fixed-seed fallback tests below cover the same invariants either way.
"""
import random

import pytest

from hypothesis_compat import given, settings, st
from repro.serving import AdmissionQueue as JaxAdmissionQueue
from repro.serving import QueuedRequest as JaxQueuedRequest

from repro_torch.serving import AdmissionQueue, QueuedRequest, RequestError


def _req(rid, priority=0, deadline=None, t=0.0):
    return QueuedRequest(rid, {"x": rid}, t, priority=priority,
                         deadline=deadline)


# ------------------------------------------------------------ plain tests
def test_default_queue_is_exact_fifo():
    """priority=0 everywhere → admission order is submission order, the
    pre-failure-layer deque contract."""
    q = AdmissionQueue()
    for i in range(10):
        assert q.push(_req(i))
    admitted, expired = q.pop_ready(10, now=0.0)
    assert [r.rid for r in admitted] == list(range(10))
    assert expired == [] and q.expired == 0 and q.shed == 0


def test_priority_admits_larger_first_ties_fifo():
    q = AdmissionQueue()
    q.push(_req(0, priority=0))
    q.push(_req(1, priority=5))
    q.push(_req(2, priority=5))
    q.push(_req(3, priority=1))
    admitted, _ = q.pop_ready(4, now=0.0)
    assert [r.rid for r in admitted] == [1, 2, 3, 0]


def test_pop_ready_respects_k_and_leaves_rest_queued():
    q = AdmissionQueue()
    for i in range(5):
        q.push(_req(i))
    admitted, _ = q.pop_ready(2, now=0.0)
    assert [r.rid for r in admitted] == [0, 1]
    assert len(q) == 3
    admitted, _ = q.pop_ready(99, now=0.0)
    assert [r.rid for r in admitted] == [2, 3, 4]
    assert len(q) == 0


def test_expired_never_admitted_and_never_counted_toward_k():
    """A past-deadline request is diverted to the expired side; it must
    not consume an admission slot (the request behind it is admitted)."""
    q = AdmissionQueue()
    q.push(_req(0, deadline=1.0))
    q.push(_req(1))                      # no deadline: never expires
    q.push(_req(2, deadline=99.0))
    admitted, expired = q.pop_ready(2, now=5.0)
    assert [r.rid for r in admitted] == [1, 2]     # k=2 still filled
    assert [r.rid for r in expired] == [0]
    assert q.expired == 1


def test_deadline_boundary_is_inclusive():
    """now == deadline expires: 'by the deadline' means strictly before."""
    q = AdmissionQueue()
    q.push(_req(0, deadline=2.0))
    q.push(_req(1, deadline=2.0 + 1e-9))
    admitted, expired = q.pop_ready(2, now=2.0)
    assert [r.rid for r in admitted] == [1]
    assert [r.rid for r in expired] == [0]


def test_shed_exact_at_max_pending():
    q = AdmissionQueue(max_pending=3)
    assert all(q.push(_req(i)) for i in range(3))
    assert not q.push(_req(3))
    assert not q.push(_req(4))
    assert q.shed == 2 and len(q) == 3
    # draining frees capacity again
    q.pop_ready(2, now=0.0)
    assert q.push(_req(5))
    assert q.shed == 2


def test_max_pending_validated():
    with pytest.raises(ValueError, match="max_pending"):
        AdmissionQueue(max_pending=0)


def test_requeue_bypasses_bound_but_not_fifo_fairness():
    """A retried request re-enters even at max_pending (it was already
    admitted once), but behind same-priority peers — a retry loop must not
    starve fresh requests."""
    q = AdmissionQueue(max_pending=2)
    q.push(_req(0))
    q.push(_req(1))
    retry = _req(9)
    q.requeue(retry)                      # over the bound: still enters
    assert len(q) == 3 and q.shed == 0
    admitted, _ = q.pop_ready(3, now=0.0)
    assert [r.rid for r in admitted] == [0, 1, 9]


def test_request_error_codes_are_machine_checkable():
    e = RequestError(7, "shed", "queue at max_pending=2")
    assert e.rid == 7 and e.code == "shed"
    assert "max_pending" in e.detail


# ------------------------------------------------- fixed-seed model check
def _model_check(events, k, max_pending, now):
    """Run the same event stream through AdmissionQueue and a brute-force
    reference model; compare admitted order, expired set, shed count."""
    q = AdmissionQueue(max_pending=max_pending)
    model = []                            # list of (priority, seq, req)
    model_shed = 0
    seq = 0
    for rid, (priority, deadline) in enumerate(events):
        req = _req(rid, priority=priority, deadline=deadline)
        if max_pending is not None and len(model) >= max_pending:
            model_shed += 1
            assert not q.push(req)
        else:
            model.append((-priority, seq, req))
            seq += 1
            assert q.push(req)
    admitted, expired = q.pop_ready(k, now)
    # reference: sort by (priority desc, arrival), then walk, diverting
    # expired without consuming admission slots; popping stops entirely
    # once k are admitted (deeper expired entries stay queued for the
    # next pop_ready — matching the engine's per-step semantics)
    model.sort()
    want_admitted, want_expired = [], []
    for _, _, req in model:
        if len(want_admitted) >= k:
            break
        if req.deadline is not None and now >= req.deadline:
            want_expired.append(req.rid)
        else:
            want_admitted.append(req.rid)
    assert [r.rid for r in admitted] == want_admitted
    assert [r.rid for r in expired] == want_expired
    assert q.shed == model_shed
    assert q.expired == len(want_expired)


def test_model_check_fixed_seeds():
    """Deterministic sweep of random interleavings — runs even without
    hypothesis installed."""
    for seed in range(20):
        rng = random.Random(seed)
        events = [(rng.randrange(4),
                   rng.choice([None, rng.uniform(0.0, 10.0)]))
                  for _ in range(rng.randrange(1, 25))]
        _model_check(events,
                     k=rng.randrange(1, 12),
                     max_pending=rng.choice([None, 1, 3, 8]),
                     now=rng.uniform(0.0, 10.0))


# -------------------------------------------------------- property tests
@settings(max_examples=200, deadline=None)
@given(
    events=st.lists(st.tuples(st.integers(min_value=-3, max_value=3),
                              st.one_of(st.none(),
                                        st.floats(min_value=0.0,
                                                  max_value=10.0))),
                    min_size=0, max_size=40),
    k=st.integers(min_value=1, max_value=16),
    max_pending=st.one_of(st.none(), st.integers(min_value=1, max_value=10)),
    now=st.floats(min_value=0.0, max_value=10.0),
)
def test_property_queue_matches_model(events, k, max_pending, now):
    _model_check(events, k, max_pending, now)


@settings(max_examples=100, deadline=None)
@given(priorities=st.lists(st.integers(min_value=-5, max_value=5),
                           min_size=1, max_size=30))
def test_property_fifo_within_priority(priorities):
    """Within one priority class admission is strictly submission order,
    whatever the surrounding classes do."""
    q = AdmissionQueue()
    for rid, p in enumerate(priorities):
        q.push(_req(rid, priority=p))
    admitted, _ = q.pop_ready(len(priorities), now=0.0)
    for p in set(priorities):
        rids = [r.rid for r in admitted if r.priority == p]
        assert rids == sorted(rids)


@settings(max_examples=100, deadline=None)
@given(deadlines=st.lists(st.floats(min_value=0.0, max_value=10.0),
                          min_size=1, max_size=30),
       now=st.floats(min_value=0.0, max_value=10.0))
def test_property_expired_never_executed(deadlines, now):
    """No request whose deadline has passed is ever on the admitted side,
    and every queued request is accounted for exactly once."""
    q = AdmissionQueue()
    for rid, dl in enumerate(deadlines):
        q.push(_req(rid, deadline=dl))
    admitted, expired = q.pop_ready(len(deadlines), now)
    assert all(r.deadline > now for r in admitted)
    assert all(now >= r.deadline for r in expired)
    assert len(admitted) + len(expired) == len(deadlines)
    assert q.expired == len(expired)


# ------------------------------------------- the port's copy vs the reference
def _both(events, k, max_pending, now, requeue_every):
    """One event stream through the port's queue and the reference's: each
    push's verdict, requeues of every ``requeue_every``-th admitted
    request, and two ``pop_ready`` rounds must agree exactly."""
    got = []
    for queue_cls, req_cls in ((AdmissionQueue, QueuedRequest),
                               (JaxAdmissionQueue, JaxQueuedRequest)):
        q = queue_cls(max_pending=max_pending)
        trace = [q.push(req_cls(rid, None, 0.0, priority=p, deadline=d))
                 for rid, (p, d) in enumerate(events)]
        for _ in range(2):
            admitted, expired = q.pop_ready(k, now)
            trace.append(([r.rid for r in admitted],
                          [r.rid for r in expired]))
            for r in admitted[::requeue_every]:
                q.requeue(r)
        trace.append((q.shed, q.expired, len(q)))
        got.append(trace)
    assert got[0] == got[1]


def test_port_queue_equals_the_reference_fixed_seeds():
    for seed in range(20):
        rng = random.Random(seed)
        events = [(rng.randrange(-2, 4),
                   rng.choice([None, rng.uniform(0.0, 10.0)]))
                  for _ in range(rng.randrange(1, 25))]
        _both(events, k=rng.randrange(1, 12),
              max_pending=rng.choice([None, 1, 3, 8]),
              now=rng.uniform(0.0, 10.0), requeue_every=rng.randrange(1, 4))


@settings(max_examples=100, deadline=None)
@given(
    events=st.lists(st.tuples(st.integers(min_value=-3, max_value=3),
                              st.one_of(st.none(),
                                        st.floats(min_value=0.0,
                                                  max_value=10.0))),
                    min_size=0, max_size=40),
    k=st.integers(min_value=1, max_value=16),
    max_pending=st.one_of(st.none(), st.integers(min_value=1, max_value=10)),
    now=st.floats(min_value=0.0, max_value=10.0),
    requeue_every=st.integers(min_value=1, max_value=4),
)
def test_property_port_queue_equals_the_reference(events, k, max_pending,
                                                   now, requeue_every):
    _both(events, k, max_pending, now, requeue_every)
