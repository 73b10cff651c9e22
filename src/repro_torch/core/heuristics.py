"""Schedulers beyond the paper's exact DP, for graphs too large for
O(|V|·2^|V|):

* ``build_chains`` + ``minimise_peak_memory_contracted`` — maximal linear
  chains have a forced internal order, so they are collapsed into
  super-operators before running the paper's DP.  The per-candidate memory
  term accounts the chain's internal liveness exactly (external inputs die at
  their last internal use unless also held for later operators).  NOTE: this
  is exact *over schedules that run each chain contiguously*; the true
  optimum may interleave chains (running another chain's op mid-chain can
  free a held tensor earlier), so the contracted DP is a near-exact
  heuristic — property tests assert ``contracted.peak >= exact.peak`` and
  benchmarks measure the observed gap (typically zero on CNN graphs).
* ``greedy_schedule`` — forward list scheduling picking the ready operator
  that minimises the post-execution live-set size (tie-break: step peak).
* ``beam_schedule`` — beam search over partial schedules, deduplicated by
  produced-set, scored by (peak so far, current liveness).

``schedule()`` is the one-stop API: exact DP (seeded with the greedy peak as
a branch-and-bound upper bound) when the contracted graph is small, beam
otherwise; always returns a schedule validated against the original graph.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.tracing import phase

from .graph import Graph, Operator, linear_chains
from .scheduler import ScheduleResult, minimise_peak_memory


# --------------------------------------------------------------------- greedy
def greedy_schedule(graph: Graph) -> ScheduleResult:
    ops = graph.operators
    n = len(ops)
    produced: Set[str] = set()
    remaining_uses: Dict[str, int] = {}
    for op in ops:
        for i in op.inputs:
            remaining_uses[i] = remaining_uses.get(i, 0) + 1
    for o in graph.outputs:
        remaining_uses[o] = remaining_uses.get(o, 0) + 1  # pinned

    live: Set[str] = set(c for c in graph.constants()
                         if remaining_uses.get(c, 0) > 0)
    live_bytes = sum(graph.size(t) for t in live)
    scheduled: List[Operator] = []
    done: Set[int] = set()
    peak = live_bytes

    def ready(op: Operator) -> bool:
        return all(i in produced or graph.producer(i) is None
                   for i in op.inputs)

    while len(scheduled) < n:
        best = None
        for op in ops:
            if id(op) in done or not ready(op):
                continue
            # simulate executing op
            step_live = live_bytes + graph.size(op.output)
            after = step_live
            for i in set(op.inputs):
                if remaining_uses.get(i, 0) - op.inputs.count(i) <= 0 \
                        and i in live:
                    after -= graph.size(i)
            key = (after, max(peak, step_live), op.name)
            if best is None or key < best[0]:
                best = (key, op, step_live, after)
        assert best is not None, "graph has a cycle"
        _, op, step_live, after = best
        peak = max(peak, step_live)
        scheduled.append(op)
        done.add(id(op))
        produced.add(op.output)
        live.add(op.output)
        live_bytes = step_live
        for i in set(op.inputs):
            remaining_uses[i] -= op.inputs.count(i)
            if remaining_uses[i] <= 0 and i in live:
                live.remove(i)
                live_bytes -= graph.size(i)
        if remaining_uses.get(op.output, 0) <= 0:
            live.remove(op.output)
            live_bytes -= graph.size(op.output)
    true_peak = graph.peak_usage(scheduled)
    return ScheduleResult(scheduled, true_peak, n, method="greedy")


# ----------------------------------------------------------------------- beam
def beam_schedule(graph: Graph, width: int = 64) -> ScheduleResult:
    ops = graph.operators
    n = len(ops)
    consumers_left_init: Dict[str, int] = {}
    for op in ops:
        for i in set(op.inputs):
            consumers_left_init[i] = consumers_left_init.get(i, 0) + 1
    for o in graph.outputs:
        consumers_left_init[o] = consumers_left_init.get(o, 0) + 1

    # state: (peak, live_bytes, done frozenset, schedule tuple,
    #         uses-left dict) — uses carried incrementally, not replayed.
    const_live = sum(graph.size(c) for c in graph.constants()
                     if consumers_left_init.get(c, 0) > 0)
    init = (const_live, const_live, frozenset(), (), consumers_left_init)
    frontier = [init]

    for _ in range(n):
        candidates: Dict[FrozenSet[int], tuple] = {}
        for peak, live_bytes, done, sched, uses_left in frontier:
            produced = {ops[k].output for k in done}
            for k, op in enumerate(ops):
                if k in done:
                    continue
                if not all(i in produced or graph.producer(i) is None
                           for i in op.inputs):
                    continue
                step = live_bytes + graph.size(op.output)
                after = step
                for i in set(op.inputs):
                    if uses_left.get(i, 0) - 1 <= 0:
                        after -= graph.size(i)
                if uses_left.get(op.output, 0) <= 0:
                    after -= graph.size(op.output)
                nd = done | {k}
                prev = candidates.get(nd)
                if prev is not None and (prev[0], prev[1]) <= (max(peak,
                                                                   step),
                                                               after):
                    continue
                nu = dict(uses_left)
                for i in set(op.inputs):
                    nu[i] = nu.get(i, 0) - 1
                candidates[nd] = (max(peak, step), after, nd,
                                  sched + (k,), nu)
        frontier = heapq.nsmallest(width, candidates.values(),
                                   key=lambda s: (s[0], s[1]))
    best = min(frontier, key=lambda s: s[0])
    schedule = [ops[k] for k in best[3]]
    true_peak = graph.peak_usage(schedule)
    return ScheduleResult(schedule, true_peak, len(frontier), method=f"beam{width}")


# ------------------------------------------------------- chain-contracted DP
@dataclasses.dataclass
class _Chain:
    ops: List[Operator]
    output: str                      # final tensor of the chain
    exts: List[str]                  # external inputs (not produced inside)
    # per-step: (bytes of internal live tensors incl. this step's output,
    #            frozenset of exts still needed at/after this step)
    steps: List[Tuple[int, FrozenSet[str]]]

    def here_cost(self, graph: Graph, held: FrozenSet[str]) -> int:
        """Peak memory while this chain executes, given `held` tensors that
        stay live throughout (excluding this chain's own exts, which are
        accounted per-step unless also in `held`)."""
        held_out = sum(graph.size(t) for t in held if t not in self.exts)
        peak = 0
        for internal, live_exts in self.steps:
            e = sum(graph.size(t) for t in self.exts
                    if t in live_exts or t in held)
            peak = max(peak, held_out + e + internal)
        return peak


def build_chains(graph: Graph) -> Tuple[Dict[str, _Chain], List[_Chain]]:
    """Contract maximal linear chains. Returns (chain by output tensor, all)."""
    chains: List[_Chain] = []
    for ops in linear_chains(graph):
        internal_outputs = {o.output for o in ops}
        exts: List[str] = []
        for op in ops:
            for i in op.inputs:
                if i not in internal_outputs and i not in exts:
                    exts.append(i)
        # last internal use of each ext
        last_use: Dict[str, int] = {}
        for t, op in enumerate(ops):
            for i in op.inputs:
                if i in exts:
                    last_use[i] = t
        # internal tensor lifetime: produced at step t, last used at step u>t
        int_last: Dict[str, int] = {}
        for t, op in enumerate(ops):
            for i in op.inputs:
                if i in internal_outputs:
                    int_last[i] = t
        steps: List[Tuple[int, FrozenSet[str]]] = []
        for t, op in enumerate(ops):
            internal = graph.size(op.output)
            for u, prev in enumerate(ops[:t]):
                o = prev.output
                if int_last.get(o, -1) >= t or o == ops[-1].output:
                    internal += graph.size(o)
            live_exts = frozenset(e for e in exts if last_use[e] >= t)
            steps.append((internal, live_exts))
        chains.append(_Chain(ops, ops[-1].output, exts, steps))
    return {c.output: c for c in chains}, chains


def minimise_peak_memory_contracted(
        graph: Graph, upper_bound: Optional[int] = None,
        max_states: int = 300_000) -> Optional[ScheduleResult]:
    """The paper's DP over the chain-contracted graph (near-exact; see
    module docstring).  ``max_states`` budgets candidate evaluations (the
    unit of work); returns None when exhausted so callers fall back to
    beam search."""
    class _StateBudget(Exception):
        pass

    by_output, chains = build_chains(graph)
    # map: tensor -> chain that produces it (only chain outputs are visible
    # as schedulable units; internal tensors never appear in DP states).
    size = graph.size
    memo: Dict[FrozenSet[str], float] = {}
    choice: Dict[FrozenSet[str], str] = {}
    stats = {"states": 0}
    INF = float("inf")

    # predecessor relation on chain outputs
    pred_cache: Dict[str, FrozenSet[str]] = {}

    def preds(t: str) -> FrozenSet[str]:
        if t in pred_cache:
            return pred_cache[t]
        c = by_output.get(t)
        if c is None:
            res: FrozenSet[str] = frozenset()
        else:
            acc: Set[str] = set()
            for e in c.exts:
                if e in by_output:
                    acc.add(e)
                    acc.update(preds(e))
            res = frozenset(acc)
        pred_cache[t] = res
        return res

    def mem(x_set: FrozenSet[str]) -> float:
        if x_set in memo:
            return memo[x_set]
        cs = frozenset(t for t in x_set if t not in by_output)
        as_ = [t for t in x_set if t in by_output]
        if not as_:
            total = sum(size(c) for c in cs)
            memo[x_set] = total
            return total
        m, best = INF, None
        for x in sorted(as_):
            stats["states"] += 1          # work unit: candidate evaluation
            if stats["states"] > max_states:
                raise _StateBudget()
            rs = frozenset(a for a in as_ if a != x)
            if any(x in preds(r) for r in rs):
                continue
            chain = by_output[x]
            succ = rs | frozenset(chain.exts) | cs
            # Constants stay in the recursion set (deduplicated accounting —
            # see the note in scheduler.mem); here_cost treats them as held.
            here = chain.here_cost(graph, rs | cs)
            if upper_bound is not None and here >= upper_bound and m < INF:
                continue
            m_prime = max(mem(succ), here)
            if m_prime < m:
                m, best = m_prime, x
        if best is not None:
            choice[x_set] = best
        memo[x_set] = m if best is not None else INF
        return memo[x_set]

    try:
        top = frozenset(graph.outputs)
        peak = mem(top)
    except _StateBudget:
        return None
    if peak == INF:
        return None

    rev: List[Operator] = []
    x_set = frozenset(graph.outputs)
    while True:
        as_ = [t for t in x_set if t in by_output]
        if not as_:
            break
        x = choice[x_set]
        chain = by_output[x]
        rev.extend(reversed(chain.ops))
        x_set = (frozenset(a for a in as_ if a != x) | frozenset(chain.exts)
                 | frozenset(t for t in x_set if t not in by_output))
    rev.reverse()
    scheduled = {id(o) for o in rev}
    dead = [o for o in graph.operators if id(o) not in scheduled]
    schedule = dead + rev if dead else rev
    if not graph.is_valid_schedule(schedule):
        raise AssertionError("contracted schedule invalid")
    true_peak = graph.peak_usage(schedule)
    return ScheduleResult(schedule, true_peak, stats["states"],
                          method="exact-contracted")


# ----------------------------------------------------------------- one-stop
def _cheap_candidates(graph: Graph) -> List[ScheduleResult]:
    """Greedy plus the embedded (insertion) order — the tool must never make
    a model worse than the schedule it shipped with."""
    results = [greedy_schedule(graph)]
    try:
        default = graph.default_schedule()
        results.append(ScheduleResult(default, graph.peak_usage(default),
                                      0, method="default"))
    except ValueError:
        pass
    return results


def _schedule_plain(graph: Graph, exact_limit: int, contract_limit: int,
                    beam_width: int) -> ScheduleResult:
    results = _cheap_candidates(graph)
    ub = min(r.peak for r in results) + 1
    _, chains = build_chains(graph)
    if len(graph.operators) <= exact_limit:
        results.append(minimise_peak_memory(graph, upper_bound=ub))
    elif len(chains) <= contract_limit:
        r = minimise_peak_memory_contracted(graph, upper_bound=ub)
        if r is not None:
            results.append(r)
        else:
            results.append(beam_schedule(graph, width=beam_width))
    else:
        results.append(beam_schedule(graph, width=beam_width))
    best = min(results, key=lambda r: r.peak)
    return best


# Every escalation rung ``schedule()`` may climb, in order.  ``rungs``
# restricts the ladder to a subset — the graceful-degradation path in
# ``deploy.build(strict=False)`` walks progressively smaller subsets when a
# higher rung fails, so a cascade-rewrite bug degrades a deployment instead
# of sinking it (DESIGN.md §12).  "reorder" (the plain reordering base the
# paper starts from) is mandatory: with nothing else it is the identity
# fallback that can only fail if the graph itself is unschedulable.
_ALL_RUNGS = ("reorder", "pex", "cascade", "cascade2d", "solver")


def schedule(graph: Graph, exact_limit: int = 18, contract_limit: int = 40,
             beam_width: int = 64, arena_budget: Optional[int] = None,
             partition: bool = False,
             partition_opts: Optional[dict] = None,
             solver_nodes: int = 20_000, solver_op_limit: int = 24,
             objective: str = "memory",
             macs_cap: Optional[float] = None,
             rungs: Optional[Sequence[str]] = None,
             phase_s: Optional[Dict[str, float]] = None) -> ScheduleResult:
    """Best-effort minimal-peak schedule:

    1. greedy (always) — provides a branch-and-bound upper bound;
    2. the paper's exact DP when the graph has ≤ ``exact_limit`` operators;
    3. chain-contracted DP when the contracted graph has ≤ ``contract_limit``
       super-nodes (near-exact; restricts chains to run contiguously);
    4. beam search otherwise;
    returns the best schedule found.

    **Partial-execution pre-pass.**  When ``partition`` is set — or
    ``arena_budget`` is given and reordering alone cannot reach it — the
    graph is rewritten by ``partition.partition_graph`` (operators split into
    K spatial slices plus an incremental concat) and the rewritten graph is
    scheduled too; whichever peak is lower wins.  A partitioned winner is
    returned with ``result.graph`` set to the rewritten graph (the schedule's
    operators belong to it); ``result.graph is None`` means the caller's
    graph.  The rewritten graph's insertion order already encodes the
    partial-execution order, so it is scheduled with the cheap candidates
    (default + greedy) only.

    **Cascaded-streaming escalation.**  When an ``arena_budget`` is given
    and whole-externals partial execution still misses it, the graph is
    rewritten by ``partition.cascade_graph`` — adjacent sliceable segments
    chained through ring buffers so no inter-segment tensor ever exists
    whole (capped on the halo-recompute MACs fraction) — followed by a
    whole-externals pass over the cascaded graph for any remaining
    over-budget runs (the cascade's tail).  When row rings alone still
    miss the budget, a final rung re-plans the cascade with W-strips
    (2-D tiled streaming: reorder → pex → 1-D cascade → 2-D tiled
    cascade).  Last, where both miss the budget and the graph has
    residual diamonds, a rung re-plans row cascades through them
    (``cascade_graph(skips=True)``: a block's input streamed beside its
    branch into the add; its search grows with the diamonds a run holds,
    so it runs only where the rungs before it fall short).  The lowest
    peak wins at every rung.

    **Joint branch-and-bound rung.**  After the ladder, graphs with at most
    ``solver_op_limit`` operators get a bounded pass of the joint
    (order × Pex split) solver (``core/solver.py``), seeded with the
    ladder's winner so the result is never worse; ``solver_nodes`` caps its
    anytime search (0 disables the rung).  ``objective="memory"`` (default)
    keeps the ladder's contract — lowest peak wins, optionally bounded by
    ``macs_cap`` (max extra-MACs fraction) — while ``objective="latency"``
    (requires ``arena_budget``) returns the *cheapest* schedule that fits
    the budget: among in-budget Pareto points, minimal halo-recompute MACs.

    **Rung restriction.**  ``rungs`` limits the ladder to a subset of
    ``("reorder", "pex", "cascade", "cascade2d", "solver")`` — the
    graceful-degradation path (``deploy.build(strict=False)``) retries with
    shrinking subsets when a rung's rewrite fails.  ``"reorder"`` is
    mandatory (it is the base every other rung escalates from); ``None``
    (default) enables every rung, which is the historical behaviour.

    **Rung times.**  Each rung that runs is a ``repro_torch.tracing``
    phase ``rung.<name>``: a span while tracing is on, and its host
    seconds added to ``phase_s`` when one is given.
    A residual-cascade search left undone for its cap (``plan_cascade``)
    is named in the result's ``notes``.
    """
    if rungs is None:
        active = frozenset(_ALL_RUNGS)
    else:
        active = frozenset(rungs)
        unknown = active - frozenset(_ALL_RUNGS)
        if unknown:
            raise ValueError(f"unknown scheduler rungs {sorted(unknown)}; "
                             f"choose from {_ALL_RUNGS}")
        if "reorder" not in active:
            raise ValueError("the 'reorder' rung is the mandatory base of "
                             "the ladder and cannot be disabled")
    notes: List[str] = []
    best = result = _ladder(graph, exact_limit, contract_limit, beam_width,
                            arena_budget, partition, partition_opts, active,
                            phase_s, notes)
    if ("solver" in active and solver_nodes
            and 0 < len(graph.operators) <= solver_op_limit):
        from .solver import solve   # deferred: avoids import cycle
        mode = ("latency" if objective == "latency"
                and arena_budget is not None else "memory")
        joint = arena_budget is not None or partition
        with phase("rung.solver", phase_s):
            sr = solve(graph, mode=mode, arena_budget=arena_budget,
                       macs_cap=macs_cap, max_nodes=solver_nodes,
                       max_rewrites=16 if joint else 0, seeds=[best])
        cand = sr.best
        if ((mode == "latency" and cand.peak <= arena_budget)
                or cand.peak < best.peak):
            result = cand
    return dataclasses.replace(result, notes=tuple(notes)) if notes \
        else result


def _ladder(graph: Graph, exact_limit: int, contract_limit: int,
            beam_width: int, arena_budget: Optional[int],
            partition: bool,
            partition_opts: Optional[dict],
            active: FrozenSet[str] = frozenset(_ALL_RUNGS),
            phase_s: Optional[Dict[str, float]] = None,
            notes: Optional[List[str]] = None
            ) -> ScheduleResult:
    """The fixed escalation ladder: reorder → pex → cascade → pex-over-tail
    → 2-D tiled cascade (greedy search inside each rung); the joint solver
    refines on top.  ``active`` gates which rungs may fire (degradation
    path; "reorder" is always implied); each rung that runs is timed into
    ``phase_s`` as ``rung.<name>``, and the cascade planner's notes of
    what it left unsearched are appended to ``notes``."""
    with phase("rung.reorder", phase_s):
        best = _schedule_plain(graph, exact_limit, contract_limit,
                               beam_width)
    want = partition or (arena_budget is not None
                         and best.peak > arena_budget)
    if not want or not (active & {"pex", "cascade", "cascade2d"}):
        return best
    from .partition import (cascade_graph,    # deferred: partition is
                            partition_graph,  # optional
                            run_skips, sliceable_runs)
    if "pex" in active:
        with phase("rung.pex", phase_s):
            pr = partition_graph(graph, budget=arena_budget,
                                 **(partition_opts or {}))
            pbest = (min(_cheap_candidates(pr.graph), key=lambda r: r.peak)
                     if pr.segments else None)
        if pbest is not None and pbest.peak < best.peak:
            best = dataclasses.replace(pbest, graph=pr.graph,
                                       method=pbest.method + "+pex",
                                       extra_macs=pr.extra_macs,
                                       total_macs=pr.total_macs,
                                       extra_macs_frac=pr.extra_macs_frac)
    if (arena_budget is None or best.peak <= arena_budget
            or not (active & {"cascade", "cascade2d"})):
        return best
    # the cascade planner honours the caller's shared partition knobs —
    # in particular a tightened overhead_cap (the halo-recompute latency
    # budget) must bind the escalation too, not just the whole-Pex passes
    shared = {k: v for k, v in (partition_opts or {}).items()
              if k in ("max_k", "overhead_cap", "k_choices")}

    def cascade_rung(strips_choices, tag, skips=False):
        cr = cascade_graph(graph, budget=arena_budget,
                           strips_choices=strips_choices, skips=skips,
                           **shared)
        if notes is not None:
            notes.extend(cr.notes)
        if not cr.cascades:
            return None
        cg = cr.graph
        extra = cr.extra_macs
        cbest = min(_cheap_candidates(cg), key=lambda r: r.peak)
        method = cbest.method + tag
        if cbest.peak > arena_budget and "pex" in active:
            # the cascade's conventional tail may itself be over budget —
            # whole-externals partial execution composes over the cascaded
            # graph
            tr = partition_graph(cg, budget=arena_budget,
                                 **(partition_opts or {}))
            if tr.segments:
                tbest = min(_cheap_candidates(tr.graph),
                            key=lambda r: r.peak)
                if tbest.peak < cbest.peak:
                    cg, cbest = tr.graph, tbest
                    method = tbest.method + tag + "+pex"
                    # composed rewrites: halo recompute adds up — the Pex
                    # pass re-runs rows of the *cascaded* graph, on top of
                    # the cascade's own recompute.  Keep the fraction
                    # anchored on the original graph's MACs so it composes
                    # with the cascade rung and the solver's points.
                    extra += tr.extra_macs
        frac = extra / cr.total_macs if cr.total_macs else 0.0
        return dataclasses.replace(cbest, graph=cg, method=method,
                                   extra_macs=extra,
                                   total_macs=cr.total_macs,
                                   extra_macs_frac=frac)

    def residual_rung(best):
        # row rings through residual diamonds too (a block's input streamed
        # beside its branch into the join), where the linear runs' rings
        # and strips miss the budget and the graph has such a fork for
        # them to break at, as MobileNetV3's 112x112 first block
        if (best.peak <= arena_budget or "cascade" not in active
                or not any(run_skips(run)
                           for run in sliceable_runs(graph, skips=True))):
            return best
        with phase("rung.rescascade", phase_s):
            cand_res = cascade_rung((1,), "+rescascade", skips=True)
        return (cand_res if cand_res is not None
                and cand_res.peak < best.peak else best)

    if "cascade" in active:
        with phase("rung.cascade", phase_s):
            cand = cascade_rung((1,), "+cascade")
        if cand is None:
            return residual_rung(best)
        if cand.peak < best.peak:
            best = cand
    if best.peak > arena_budget and "cascade2d" in active:
        # 2-D tiled rung: row rings alone miss the budget, so re-plan with
        # W-strips in the search space (MCUNetV2-style patch streaming).
        # Gated on still-over-budget so in-budget row-cascade goldens are
        # byte-identical to the pre-2-D ladder.
        with phase("rung.cascade2d", phase_s):
            cand2d = cascade_rung((2, 3, 4), "+cascade2d")
        if cand2d is not None and cand2d.peak < best.peak:
            best = cand2d
    return residual_rung(best)
