"""Joint branch-and-bound scheduler with a memory/latency Pareto front.

The paper's DP and the escalation ladder in ``heuristics.schedule`` treat
operator reordering and partial execution as separate rungs: reorder first,
then — if a budget is missed — rewrite with Pex/cascade and reorder the
rewrite greedily.  This module performs the *joint* search the ROADMAP calls
for (cf. SNIPPETS.md Snippet 1, HLS memory-resource-aware scheduling): one
anytime branch-and-bound over

* the operator order (all topological orders, pruned by an incumbent bound
  and a done-set dominance table), and
* the Pex split parameters (which contiguous sliceable sub-run to partition,
  and into how many slices K),

under two objective modes:

* ``mode="latency"`` — minimise extra MACs subject to ``peak <= arena_budget``
  (the deployment question: cheapest schedule that fits the SRAM);
* ``mode="memory"`` — minimise peak bytes subject to
  ``extra_macs_frac <= macs_cap`` (the headline question: smallest arena
  within a latency price).

Every solve also emits the full **Pareto front** of (arena bytes, extra
MACs) over the searched space, so benchmarks can pin points on the curve
instead of single scalars (see ``benchmarks/compare.py``).

Contracts (property- and oracle-tested in ``tests/test_solver_oracle.py``):

* **anytime** — ``max_nodes`` bounds the search; on exhaustion the best
  incumbent found so far is returned and ``SolverResult.complete`` is
  False.  The incumbent is seeded with the cheap candidates (default +
  greedy) of every candidate graph, so the result is always a *valid*
  schedule and never worse than those seeds.  More nodes never yields a
  worse result (the deterministic DFS explores a superset).
* **exact when complete** — with the node budget unexhausted and no
  rewrite candidates dropped, the front points are true optima over the
  searched space: brute-force enumeration of all topological orders and
  Pex splits of small graphs agrees exactly (``tests/oracle.py``).
* **deterministic** — no randomness, no wall-clock dependence; identical
  inputs give identical fronts and schedules.

The searched Pex space is ``{no split} ∪ {one (sub-run, K) split}`` — one
partitioned segment per solve, every contiguous sub-run of every sliceable
run, every K in ``2..min(max_k, rows)`` (or ``k_choices``).  Multi-segment
and cascade rewrites reach the solver only as *seeds* from the escalation
ladder (`heuristics.schedule` passes its rung results in).  The MACs
accounting is uniform on both sides: ``extra_macs`` is always absolute halo
recompute and ``extra_macs_frac`` is always relative to the whole graph's
MACs (``graph_macs`` — canonical definitions in ``core/partition.py``), for
solver points and ladder seeds alike.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .graph import Graph, Operator, inplace_candidates
from .heuristics import _cheap_candidates
from .partition import (Segment, _height, apply_partition, estimate_segment,
                        graph_macs, op_macs, segment_extra_macs,
                        sliceable_runs)
from .scheduler import ScheduleResult

# Re-exported for the brute-force oracle and older call sites: the MACs
# accounting (op_macs / graph_macs / segment_extra_macs) now lives in
# ``core/partition.py`` next to the cost model whose units it defines.
__all__ = ["op_macs", "graph_macs", "segment_extra_macs", "solve",
           "enumerate_pex_configs", "pareto_front"]


# ------------------------------------------------------- incremental sim model
class _Sim:
    """Forward mirror of ``Graph.live_sets``: step cost and the post-step
    live set, order-independent given the set of already-executed ops.

    ``uses[t]`` counts t's remaining consumptions (graph outputs get +1 so
    they never die — the paper pins outputs to the end of the schedule).
    A step executing ``op`` charges the current live bytes plus the output
    buffer, unless the op is ``inplace`` and may overwrite an input that
    dies at this very step (same bytes, has a producer) — exactly the
    ``live_sets`` aliasing rule."""

    __slots__ = ("graph", "uses", "live", "live_bytes", "produced")

    def __init__(self, graph: Graph) -> None:
        self.graph = graph
        uses: Dict[str, int] = {}
        for op in graph.operators:
            for i in op.inputs:
                uses[i] = uses.get(i, 0) + 1
        for o in graph.outputs:
            uses[o] = uses.get(o, 0) + 1
        self.uses = uses
        self.live: Set[str] = {c for c in graph.constants()
                               if uses.get(c, 0) > 0}
        self.live_bytes = sum(graph.size(t) for t in self.live)
        self.produced: Set[str] = set()

    def ready(self, op: Operator) -> bool:
        return all(i in self.produced or self.graph.producer(i) is None
                   for i in op.inputs)

    def _inplace_ok(self, op: Operator) -> bool:
        if not op.attrs.get("inplace"):
            return False
        g, uses = self.graph, self.uses
        out_b = g.size(op.output)
        counts: Dict[str, int] = {}
        for i in op.inputs:
            counts[i] = counts.get(i, 0) + 1
        return any(g.producer(i) is not None and g.size(i) == out_b
                   and uses.get(i, 0) - counts[i] == 0
                   for i in inplace_candidates(op))

    def peek(self, op: Operator) -> Tuple[int, int]:
        """(step cost, live bytes after) of executing ``op`` now — pure."""
        g, uses = self.graph, self.uses
        step = self.live_bytes + (0 if self._inplace_ok(op)
                                  else g.size(op.output))
        after = self.live_bytes
        counts: Dict[str, int] = {}
        for i in op.inputs:
            counts[i] = counts.get(i, 0) + 1
        for i, c in counts.items():
            if uses.get(i, 0) - c == 0 and i in self.live:
                after -= g.size(i)
        if uses.get(op.output, 0) > 0:
            after += g.size(op.output)
        return step, after

    def apply(self, op: Operator) -> tuple:
        """Execute ``op``; returns an undo token for :meth:`undo`."""
        g, uses = self.graph, self.uses
        died: List[str] = []
        counts: Dict[str, int] = {}
        for i in op.inputs:
            counts[i] = counts.get(i, 0) + 1
        for i, c in counts.items():
            uses[i] -= c
            if uses[i] == 0 and i in self.live:
                self.live.remove(i)
                self.live_bytes -= g.size(i)
                died.append(i)
        out_live = uses.get(op.output, 0) > 0
        if out_live:
            self.live.add(op.output)
            self.live_bytes += g.size(op.output)
        self.produced.add(op.output)
        return op, counts, died, out_live

    def undo(self, token: tuple) -> None:
        op, counts, died, out_live = token
        g, uses = self.graph, self.uses
        self.produced.discard(op.output)
        if out_live:
            self.live.remove(op.output)
            self.live_bytes -= g.size(op.output)
        for i in died:
            self.live.add(i)
            self.live_bytes += g.size(i)
        for i, c in counts.items():
            uses[i] += c


# ------------------------------------------------------------ order-space B&B
@dataclasses.dataclass
class _Budget:
    """Shared anytime node budget: one unit = one DFS node expansion."""

    limit: int
    used: int = 0
    exhausted: bool = False

    def tick(self) -> bool:
        if self.used >= self.limit:
            self.exhausted = True
            return False
        self.used += 1
        return True


def _op_lower_bound(graph: Graph, op: Operator) -> int:
    """A step executing ``op`` holds all its distinct inputs plus (unless an
    inplace alias is possible) its output — in *any* schedule."""
    lb = sum(graph.size(i) for i in set(op.inputs))
    out_b = graph.size(op.output)
    maybe_inplace = op.attrs.get("inplace") and any(
        graph.producer(i) is not None and graph.size(i) == out_b
        for i in inplace_candidates(op))
    if not maybe_inplace:
        lb += out_b
    return lb


def branch_and_bound_order(graph: Graph, budget: _Budget,
                           seeds: Sequence[ScheduleResult] = ()
                           ) -> Tuple[ScheduleResult, bool]:
    """Minimal-peak topological order of ``graph`` by anytime DFS B&B.

    Returns ``(result, complete)``; ``complete`` means the search space was
    exhausted (up to sound pruning), so the result is a true optimum.  The
    incumbent is seeded with ``seeds`` plus the graph's cheap candidates
    (default order + greedy), so the result is never worse than either.
    """
    ops = graph.operators
    n = len(ops)
    cand = list(_cheap_candidates(graph))
    cand += [s for s in seeds if s is not None]
    best = min(cand, key=lambda r: r.peak)
    if n == 0:
        return best, True

    incumbent_peak = best.peak
    by_id = {id(op): k for k, op in enumerate(ops)}
    incumbent_order = [by_id[id(op)] for op in best.schedule]

    lbs = [_op_lower_bound(graph, op) for op in ops]
    if max(lbs) >= incumbent_peak:
        # every schedule must pay the fattest step — the seed is optimal
        return best, True

    sim = _Sim(graph)
    visited: Dict[FrozenSet[int], int] = {}
    order: List[int] = []
    state = {"complete": True, "incumbent": incumbent_peak,
             "order": incumbent_order}
    depth_needed = n * 3 + 200
    if sys.getrecursionlimit() < depth_needed:
        sys.setrecursionlimit(depth_needed)

    def dfs(done: FrozenSet[int], peak: int) -> None:
        if len(order) == n:
            if peak < state["incumbent"]:
                state["incumbent"] = peak
                state["order"] = list(order)
            return
        rem_lb = max(lbs[k] for k in range(n) if k not in done)
        if max(peak, rem_lb) >= state["incumbent"]:
            return
        seen = visited.get(done)
        if seen is not None and seen <= peak:
            return
        visited[done] = peak
        if not budget.tick():
            state["complete"] = False
            return
        children: List[Tuple[int, int, int]] = []
        for k, op in enumerate(ops):
            if k in done or not sim.ready(op):
                continue
            step, after = sim.peek(op)
            if max(peak, step) >= state["incumbent"]:
                continue
            children.append((after, step, k))
        children.sort()
        for after, step, k in children:
            if max(peak, step) >= state["incumbent"]:
                continue  # the incumbent may have improved mid-loop
            token = sim.apply(ops[k])
            order.append(k)
            dfs(done | {k}, max(peak, step))
            order.pop()
            sim.undo(token)
            if budget.exhausted:
                state["complete"] = False
                return

    dfs(frozenset(), 0)
    schedule = [ops[k] for k in state["order"]]
    true_peak = graph.peak_usage(schedule)
    assert true_peak == state["incumbent"], \
        "B&B incremental model diverged from Graph.live_sets"
    res = ScheduleResult(schedule, true_peak, budget.used, method="bnb")
    return res, state["complete"]


# ------------------------------------------------------------ joint Pex space
def enumerate_pex_configs(graph: Graph, max_k: int = 16,
                          k_choices: Optional[Sequence[int]] = None
                          ) -> List[Tuple[Tuple[Operator, ...], int]]:
    """The solver's split space: every contiguous sub-run (length >= 2) of
    every sliceable run, crossed with every K in ``2..min(max_k, rows)``
    (or the explicit ``k_choices``).  Deterministic order."""
    configs: List[Tuple[Tuple[Operator, ...], int]] = []
    for run in sliceable_runs(graph):
        for i in range(len(run)):
            for j in range(i + 1, len(run)):
                ops = tuple(run[i:j + 1])
                h = _height(graph, ops[-1].output)
                assert h is not None
                cap = min(max_k, h)
                ks = (sorted(set(k_choices)) if k_choices is not None
                      else range(2, cap + 1))
                for k in ks:
                    if 2 <= k <= cap:
                        configs.append((ops, k))
    return configs


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One point of the arena-bytes × extra-MACs trade-off curve."""

    peak: int                 # arena/peak bytes of the best order found
    extra_macs: int           # absolute halo-recompute MACs of the split
    extra_macs_frac: float    # relative to graph_macs(original graph)
    method: str
    exact: bool = True        # order search completed for this point
    result: Optional[ScheduleResult] = dataclasses.field(
        default=None, compare=False, repr=False)

    def as_json(self) -> dict:
        return {"arena_bytes": self.peak, "extra_macs": self.extra_macs,
                "extra_macs_frac": round(self.extra_macs_frac, 6),
                "method": self.method, "exact": self.exact}


def pareto_front(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Non-dominated subset, sorted by extra MACs ascending.  On the result
    ``extra_macs`` is strictly increasing and ``peak`` strictly decreasing —
    the two monotonicity invariants the property tests pin."""
    front: List[ParetoPoint] = []
    best_peak: Optional[int] = None
    for p in sorted(points, key=lambda p: (p.extra_macs, p.peak, p.method)):
        if best_peak is None or p.peak < best_peak:
            front.append(p)
            best_peak = p.peak
    return front


@dataclasses.dataclass
class SolverResult:
    best: ScheduleResult
    front: List[ParetoPoint]
    nodes: int                # DFS nodes expanded across all candidates
    complete: bool            # False: node budget hit or configs dropped
    mode: str

    def front_json(self) -> List[dict]:
        return [p.as_json() for p in self.front]


def solve(graph: Graph, mode: str = "memory",
          arena_budget: Optional[int] = None,
          macs_cap: Optional[float] = None,
          max_nodes: int = 200_000, max_k: int = 16,
          k_choices: Optional[Sequence[int]] = None,
          max_rewrites: int = 64,
          seeds: Sequence[ScheduleResult] = ()) -> SolverResult:
    """Joint (order × Pex split) solve of ``graph``.  See module docstring
    for the modes, the searched space, and the anytime contract."""
    if mode not in ("memory", "latency"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "latency" and arena_budget is None:
        raise ValueError("mode='latency' needs an arena_budget")
    budget = _Budget(max_nodes)
    total_macs = graph_macs(graph)
    points: List[ParetoPoint] = []

    base_res, base_ok = branch_and_bound_order(graph, budget)
    base_res = dataclasses.replace(base_res, extra_macs=0,
                                   total_macs=total_macs)
    points.append(ParetoPoint(base_res.peak, 0, 0.0, "bnb", base_ok,
                              base_res))

    configs = enumerate_pex_configs(graph, max_k, k_choices)
    dropped = False
    if len(configs) > max_rewrites:
        # deterministic pre-screen: keep the most promising by estimated
        # peak (cheap, no rewrite), tie-broken structurally
        configs.sort(key=lambda c: (estimate_segment(graph, c[0], c[1])[0],
                                    c[0][0].name, c[0][-1].name, c[1]))
        configs = configs[:max_rewrites]
        dropped = True
    for ops, k in configs:
        est, frac_seg = estimate_segment(graph, ops, k)
        extra = segment_extra_macs(graph, ops, k)
        seg = Segment(list(ops), k, est, frac_seg, extra)
        rewritten = apply_partition(graph, [seg])
        res, ok = branch_and_bound_order(rewritten, budget)
        frac = extra / total_macs if total_macs else 0.0
        method = (f"bnb+pex[{ops[0].name}..{ops[-1].name}/k{k}]")
        res = dataclasses.replace(res, graph=rewritten, method=method,
                                  extra_macs_frac=frac, extra_macs=extra,
                                  total_macs=total_macs)
        points.append(ParetoPoint(res.peak, extra, frac, method, ok, res))

    front = pareto_front(points)
    complete = (not dropped and not budget.exhausted
                and all(p.exact for p in front))

    # ---- pick the mode's winner from the front ---------------------------
    if mode == "latency":
        fits = [p for p in front if p.peak <= arena_budget]
        if fits:
            pick = min(fits, key=lambda p: (p.extra_macs, p.peak))
        else:
            pick = min(front, key=lambda p: (p.peak, p.extra_macs))
    else:
        cap = float("inf") if macs_cap is None else macs_cap
        ok_pts = [p for p in front if p.extra_macs_frac <= cap + 1e-12]
        pick = min(ok_pts or front, key=lambda p: (p.peak, p.extra_macs))
    best = pick.result
    assert best is not None

    # ---- external seeds (ladder rungs: multi-segment pex, cascades) ------
    # Seeds carry the same whole-graph extra_macs_frac as solver points
    # (canonical MACs accounting in core/partition.py), so the macs_cap
    # check below compares like with like: a seed wins when it satisfies
    # the active constraint at a strictly lower peak, or fits a budget the
    # solver space misses.
    for s in seeds:
        if s is None:
            continue
        if mode == "latency":
            # same rule as the front pick: among in-budget candidates,
            # fewest extra MACs wins, peak breaks ties.  (Seeds used to
            # carry extra_macs=None and were judged on peak alone — a
            # recomputing cascade could displace a free in-budget point.)
            if s.peak <= arena_budget:
                s_key = (s.extra_macs or 0, s.peak)
                if (best.peak > arena_budget
                        or s_key < (best.extra_macs or 0, best.peak)):
                    best = s
        else:
            cap = float("inf") if macs_cap is None else macs_cap
            if s.extra_macs_frac <= cap + 1e-12 and s.peak < best.peak:
                best = s

    return SolverResult(best=best, front=front, nodes=budget.used,
                        complete=complete, mode=mode)
