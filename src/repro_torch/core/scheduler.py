"""Algorithm 1 of Liberis & Lane (2019): minimal peak memory via operator
reordering, as an exact memoized dynamic program over tensor sets.

``MEM(X)`` is the minimum peak memory needed to produce *and keep live* the
tensors of ``X``.  It recurses backwards by "un-applying" the producer of each
activation in ``X``; a candidate is skipped when its tensor is a (transitive)
predecessor of another tensor still required, since that would force the
producer to execute twice.  Memoised on the full tensor set.

The optimal schedule is recovered by tracing the argmin choices forward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

from .graph import Graph, Operator


@dataclasses.dataclass
class ScheduleResult:
    schedule: List[Operator]
    peak: int
    states_visited: int
    method: str = "exact"
    # When a partial-execution pre-pass rewrote the graph, the schedule's
    # operators belong to this graph (None = the graph passed by the caller).
    graph: Optional["Graph"] = None
    # Halo-recompute cost of a partial-execution/cascade rewrite: extra
    # MACs as a fraction of the *whole graph's* MACs (0.0 = whole-operator
    # schedule) — the model-wide latency price paid for the memory saving.
    # Uniform units everywhere: the ladder rungs, the cascade planner and
    # the joint solver all anchor on ``graph_macs(original graph)``
    # (canonical accounting in core/partition.py), so fractions from any
    # producer compare directly.
    extra_macs_frac: float = 0.0
    # The absolute figures behind the fraction: halo-recompute MACs of the
    # schedule's rewrite, and the original graph's estimated total MACs
    # (``extra_macs / total_macs == extra_macs_frac``).  None only on
    # plain reorder-only results that never touched a rewrite pass.
    extra_macs: Optional[int] = None
    total_macs: Optional[int] = None
    # What a rung left undone that a reader of the result should know, one
    # line each (a run of residual diamonds whose search was over its cap).
    notes: Tuple[str, ...] = ()


def _split(graph: Graph, x_set: FrozenSet[str]) -> Tuple[List[str], List[str]]:
    """PARTITION(X, x: producer(x) is None) -> (constants, activations)."""
    cs, as_ = [], []
    for t in x_set:
        (cs if graph.producer(t) is None else as_).append(t)
    return cs, as_


def minimise_peak_memory(graph: Graph,
                         upper_bound: Optional[int] = None) -> ScheduleResult:
    """Exact Algorithm 1 with memoisation and (optionally) branch-and-bound.

    ``upper_bound``: prune any branch whose running max already reaches this
    value (e.g. the peak of a known schedule).  ``None`` disables pruning and
    yields the literal paper algorithm.
    """
    if not graph.outputs:
        raise ValueError("graph has no outputs set")
    size = graph.size
    memo: Dict[FrozenSet[str], int] = {}
    choice: Dict[FrozenSet[str], str] = {}
    stats = {"states": 0}

    INF = float("inf")

    def mem(x_set: FrozenSet[str]) -> float:
        # NOTE on a fixed edge case vs the literal paper pseudo-code: line 18
        # of Algorithm 1 adds sum(cs) on top of line 15's sum(rs ∪ is ∪ {x}),
        # which double-counts a constant that is simultaneously held in X and
        # consumed by producer(x) (possible when a constant has several
        # consumers).  We instead keep constants inside the recursion set and
        # compute every working-set total over a deduplicated set union —
        # identical to the paper whenever constants have one consumer (e.g.
        # its Figure 1), and consistent with Graph.live_sets() in general.
        if x_set in memo:
            return memo[x_set]
        stats["states"] += 1
        cs, as_ = _split(graph, x_set)
        if not as_:
            total = sum(size(c) for c in cs)
            memo[x_set] = total
            return total
        cs_f = frozenset(cs)
        m = INF
        best: Optional[str] = None
        for x in sorted(as_):  # deterministic tie-breaking
            rs = [a for a in as_ if a != x]
            # producer(x) would need to run again if x precedes a held tensor
            if any(x in graph.predecessors_of_tensor(r) for r in rs):
                continue
            op = graph.producer(x)
            assert op is not None
            succ = frozenset(rs) | frozenset(op.inputs) | cs_f
            here = sum(size(t)
                       for t in (set(rs) | set(op.inputs) | {x} | set(cs)))
            # Branch-and-bound: this candidate's step cost already reaches the
            # incumbent — it cannot improve on it (m' >= here).
            if upper_bound is not None and here >= upper_bound and m < INF:
                continue
            m_prime = max(mem(succ), here)
            if m_prime < m:
                m = m_prime
                best = x
        if best is not None:
            choice[x_set] = best
        memo[x_set] = m
        return m

    top = frozenset(graph.outputs)
    peak = mem(top)
    if peak == INF:
        raise RuntimeError("no valid schedule found (pruning too aggressive?)")

    # ---- trace the argmin choices to recover the (reversed) schedule -------
    rev: List[Operator] = []
    x_set = top
    while True:
        _, as_ = _split(graph, x_set)
        if not as_:
            break
        x = choice[x_set]
        op = graph.producer(x)
        assert op is not None
        rev.append(op)
        # Follow exactly the recursion key used by mem().
        x_set = (frozenset(a for a in as_ if a != x) | frozenset(op.inputs)
                 | frozenset(c for c in x_set if graph.producer(c) is None))
    rev.reverse()

    # The recursion covers operators reachable from the outputs; any operator
    # not reachable (dead code) is appended in original (topological) order.
    scheduled = {id(o) for o in rev}
    dead = [o for o in graph.operators if id(o) not in scheduled]
    schedule = dead + rev if dead else rev
    if not graph.is_valid_schedule(schedule):
        raise AssertionError("extracted schedule is invalid")
    return ScheduleResult(schedule=schedule, peak=int(peak),
                          states_visited=stats["states"], method="exact")
