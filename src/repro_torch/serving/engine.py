"""Micro-batched serving of a deployed CNN graph on one device.

``GraphServingEngine`` runs requests through a ``repro_torch.deploy.
Deployment`` in **micro-batches**: each batch is one ``[micro_batch,
arena]`` uint8 arena, one lane per request, and one execution of the
arena program over all lanes — one kernel launch per operator for the
whole batch.  A ragged final batch keeps its unused lanes all zero: pad
lanes are executed (every dispatch has the same geometry) but are
**accounted separately** (``stats.padded_lanes``) and never read back —
they are not requests, and per-request stats never count them.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.graph import Graph
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        dispatch_with_retry)
from repro_torch.serving.stats import EngineStats


class GraphServingEngine:
    """Micro-batched single-device serving of a deployed CNN graph.

    Construct from a graph (the facade runs schedule→plan→compile on
    ``device``, None = the card) or pass an existing ``deployment=``.
    ``serve`` runs micro-batches of ``micro_batch`` lanes; ``stats`` is a
    typed ``EngineStats``.  ``faults`` (a ``FaultPlan``; test-only) wraps
    each dispatch in seeded fault injection with bounded retry.
    """

    def __init__(self, graph: Optional[Graph] = None, *,
                 deployment=None, arena_budget: Optional[int] = None,
                 partition: bool = False, micro_batch: int = 8,
                 faults=None, max_retries: int = 2,
                 dispatch_timeout: Optional[float] = None, device=None):
        if deployment is None:
            if graph is None:
                raise ValueError("need a graph or a deployment")
            from repro_torch.deploy import build
            deployment = build(graph, arena_budget=arena_budget,
                               partition=partition, device=device)
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        self.deployment = deployment
        self.faults = (FaultInjector(faults)
                       if isinstance(faults, FaultPlan) else faults)
        self.max_retries = int(max_retries)
        self.dispatch_timeout = dispatch_timeout
        self.result = deployment.schedule_result
        self.exec_graph = deployment.exec_graph
        self.plan = deployment.plan
        self.executor = deployment.executor
        self.micro_batch = micro_batch
        self.stats = EngineStats(
            arena_bytes=int(self.plan.arena_size),
            schedule_peak_bytes=int(self.result.peak),
            schedule_method=self.result.method,
            replicas=1, lanes=micro_batch)

    def _dispatch(self, chunk: Sequence[Dict[str, Any]]):
        ex = self.executor
        arena = ex.new_arena(self.micro_batch)   # lanes >= len(chunk): pads
        for lane, inputs in enumerate(chunk):
            ex.write_inputs(arena, lane, inputs)
        return ex.execute(arena)

    def serve(self, requests: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Run every request's input dict through the deployed graph;
        returns one output dict per request, in order."""
        ex = self.executor
        results: List[Dict[str, Any]] = []
        latencies: List[float] = []
        padded = n_batches = retried = trips = 0
        t_start = time.perf_counter()
        for i in range(0, len(requests), self.micro_batch):
            chunk = requests[i:i + self.micro_batch]
            padded += self.micro_batch - len(chunk)
            # each attempt rebuilds its arena: a retried dispatch starts
            # from the requests, never from a half-executed arena
            arena, r, w = dispatch_with_retry(
                lambda c=chunk: self._dispatch(c), faults=self.faults,
                max_retries=self.max_retries,
                dispatch_timeout=self.dispatch_timeout)
            retried += r
            trips += w
            n_batches += 1
            ex.verify_guards(arena[:len(chunk)])  # no-op without guards
            for lane in range(len(chunk)):        # pad lanes never read
                results.append(ex.outputs_from(arena, lane))
            # one-shot serve admits everything at t_start, so a request's
            # latency is its batch's completion time
            latencies.extend([time.perf_counter() - t_start] * len(chunk))
        wall = time.perf_counter() - t_start
        self.stats.record_serve(requests=len(requests), padded_lanes=padded,
                                dispatches=n_batches, wall_s=wall,
                                latencies_s=latencies)
        self.stats.admitted = len(requests)
        self.stats.retried = retried
        self.stats.watchdog_trips = trips
        return results


__all__ = ["GraphServingEngine"]
