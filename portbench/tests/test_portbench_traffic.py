"""The traffic generator, and why an open loop's latency is timed from
the due time on its arrival schedule."""
import collections
import math

import numpy as np
import pytest

from portbench.harness import traffic


def test_backlog_and_poisson_are_seeded():
    a = traffic.schedule({"kind": "poisson", "pool": 8, "rate_per_s": 500},
                         2**31 + 77, 2.0)
    b = traffic.schedule({"kind": "poisson", "pool": 8, "rate_per_s": 500},
                         2**31 + 77, 2.0)
    c = traffic.schedule({"kind": "poisson", "pool": 8, "rate_per_s": 500},
                         5, 2.0)
    np.testing.assert_array_equal(a.due, b.due)
    assert [a.images[i] for i in range(40)] == [b.images[i]
                                                for i in range(40)]
    # another seed: the same gaps in another order, the same total time
    assert len(a.due) == len(c.due) == 1000
    gaps = np.sort(traffic.exponential_gaps(1000, 500.0))
    for s in (a, c):      # every gap but the one after the last request
        at = np.searchsorted(gaps, np.diff(s.due) - 1e-12)
        np.testing.assert_allclose(gaps[at], np.diff(s.due), rtol=1e-9)
        assert len(set(at.tolist())) == 999
    assert not np.array_equal(a.due, c.due)
    assert a.due[-1] == pytest.approx(c.due[-1], rel=0.01)
    assert a.due[0] == 0.0 and a.due[-1] < 2.0
    # every image once before any again
    assert sorted(a.images[i] for i in range(8)) == list(range(8))
    bl = traffic.schedule({"kind": "backlog", "pool": 8,
                           "queue_dispatches": 2}, 1, 2.0)
    assert bl.due is None and bl.queue_dispatches == 2


def test_gaps_are_exponential():
    gaps = traffic.exponential_gaps(100000, 250.0)
    assert gaps.mean() == pytest.approx(1 / 250.0, rel=1e-3)
    assert np.median(gaps) == pytest.approx(np.log(2) / 250.0, rel=1e-3)


def _nearest_rank(values, q):
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def _p95s(stall_at, lanes=4, dispatch_s=2e-3):
    """An open loop over the generator's due times, on a fake clock: the
    client submits what is due, then one dispatch of up to ``lanes``
    requests takes ``dispatch_s`` (the one numbered ``stall_at`` 50 ms
    more).  The 95th percentile in ms from the due time, and from the
    submit, as the port's engines time a request."""
    sched = traffic.schedule({"kind": "poisson", "pool": 4,
                              "rate_per_s": 1000.0}, 3, 0.5)
    now, queue, due_lat, submit_lat = 0.0, collections.deque(), [], []
    i = dispatches = 0
    while i < len(sched.due) or queue:
        while i < len(sched.due) and sched.due[i] <= now:
            queue.append((sched.due[i], now))
            i += 1
        if not queue:
            now = sched.due[i]
            continue
        took = [queue.popleft() for _ in range(min(lanes, len(queue)))]
        now += dispatch_s + (0.05 if dispatches == stall_at else 0.0)
        dispatches += 1
        for due, submitted in took:
            due_lat.append(now - due)
            submit_lat.append(now - submitted)
    assert len(due_lat) == 500
    return 1e3 * _nearest_rank(due_lat, 95), \
        1e3 * _nearest_rank(submit_lat, 95)


def test_a_stall_shows_in_p95_from_the_due_time():
    calm, calm_submit = _p95s(None)
    stalled, stalled_submit = _p95s(stall_at=50)
    # requests due during the 50 ms stall wait it out: timed from their
    # due time the tail grows by most of the stall
    assert stalled - calm > 30.0
    # timed from submit, as the engines time a request, the client's
    # late submits hide half of it
    assert stalled - calm > 1.5 * (stalled_submit - calm_submit)
