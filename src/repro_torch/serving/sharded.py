"""Sharded continuous-batching serving engine (the production tier).

``GraphServingEngine`` amortises launches across the lanes of one
``batched_fn`` but runs every batch on one device and makes late requests
wait for the whole serve loop.  ``ShardedServingEngine`` scales that out
and opens the batch boundary:

* **Replica sharding** — the deployed arena program is
  ``executor.replicated_fn(replicas, lanes)``: one ``batched_fn(lanes)``
  per device, each with its own static ``[lanes, pitch]`` arena (on the
  card: its own captured graph).  A dispatch serves up to R×L requests,
  R replicas × L lanes, with no collectives (requests are embarrassingly
  parallel), so per-lane results are bit-identical to a single
  ``Deployment.run``.  Replicas are counted per device kind
  (``repro_torch.device.device_count``): every visible card, or on the CPU
  the host replicas set by ``force_host_devices(N)``.
* **Continuous batching at dispatch granularity** — requests enter an
  admission queue (``submit``); every ``step`` admits up to R×L queued
  requests *at that batch boundary*.  A late arrival joins the next
  dispatch instead of waiting for the current serve loop to finish.
* **Deadline/priority admission** (``serving/admission.py``) — requests
  carry optional ``priority`` (larger admits first; ties FIFO) and an
  absolute ``deadline``: past-deadline requests are *never executed*, they
  complete as typed ``RequestError("expired")`` results.  ``max_pending``
  bounds the queue — excess submissions shed immediately as
  ``RequestError("shed")``.
* **Bounded retry + watchdog** — each dispatch runs through
  ``faults.dispatch_with_retry``: transient device errors retry up to
  ``max_retries``; a ``dispatch_timeout`` turns persistent slowness into a
  typed failure (post-hoc watchdog — see that function's honesty note).
  Exhausted budgets become ``RequestError("dispatch_failed")`` for the
  admitted requests, never an exception out of the serve loop.
* **Fault detection + degradation** (DESIGN.md §12) — with a seeded
  ``FaultPlan``, injected arena corruption is caught by genuine guard-
  canary verification (``guard_bytes`` deployments) or the injector's
  ECC-style lane report, and NaN poison by a genuine output scan; poisoned
  requests re-queue (bounded by ``max_retries``) or fail typed.  If the
  replica program cannot be built, the engine serves through
  ``batched_fn(lanes)`` on the deployment's device with a note in
  ``stats.degraded`` instead of refusing to serve.
* **Honest ragged tails** — a pad lane is a lane of a static arena that
  no admitted request was written to: it holds ``executor.pad_arena()``
  (all zero) when the dispatch starts, is executed (one captured shape),
  counted in ``stats.padded_lanes``, and never read back.
* **Typed stats** — latency p50/p99 and throughput plus the failure-layer
  counters (admitted/expired/shed/retried/failed/watchdog_trips) in
  ``EngineStats``.

With no faults, no guards, and default admission (no deadlines, no bound)
outputs are read straight from the replicas' arenas with
``outputs_from`` (a copy), bit-identical under any arrival interleaving.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.device import device_count
from repro_torch.errors import (DeviceInitError, DispatchFailedError,
                                GuardViolation)
from repro_torch.serving.admission import (AdmissionQueue, QueuedRequest,
                                           RequestError)
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        dispatch_with_retry)
from repro_torch.serving.stats import EngineStats


class ShardedServingEngine:
    """Continuous-batching engine over an ``[R, L]`` replica × lane grid.

    ``deployment`` is a ``repro_torch.deploy.Deployment`` (or a graph,
    which is built through the facade; ``device=None`` there is the card).
    ``replicas=None`` takes every device of the deployment's kind, and a
    larger request is clipped to that count; ``lanes`` is the lane count
    per replica, so one dispatch serves up to ``replicas * lanes``
    requests.

    Failure-layer knobs (all default-off; see the module docstring):
    ``max_pending`` bounds the queue, ``max_retries``/``dispatch_timeout``
    bound the retry/watchdog loop, ``faults`` injects a seeded
    ``FaultPlan``, ``fallback_single_device`` controls degradation when
    the replica program cannot be built, and ``clock`` is injectable so
    deadline/latency logic is testable against a fake clock.
    """

    def __init__(self, deployment, *, replicas: Optional[int] = None,
                 lanes: int = 4, max_pending: Optional[int] = None,
                 max_retries: int = 2,
                 dispatch_timeout: Optional[float] = None,
                 faults: Union[FaultPlan, FaultInjector, None] = None,
                 fallback_single_device: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 **build_opts):
        from repro_torch.deploy import Deployment, build
        if not isinstance(deployment, Deployment):
            deployment = build(deployment, **build_opts)
        elif build_opts:
            raise ValueError(f"build options {sorted(build_opts)} are for "
                             f"graph arguments; this is already a Deployment")
        self.deployment = deployment
        self.executor = deployment.executor
        self._clock = clock
        self.max_retries = int(max_retries)
        self.dispatch_timeout = dispatch_timeout
        self._faults = (FaultInjector(faults)
                        if isinstance(faults, FaultPlan) else faults)
        self._degraded: List[str] = list(deployment.degraded)
        n_dev = device_count(self.executor.device)
        self.replicas = n_dev if replicas is None else min(replicas, n_dev)
        if self.replicas < 1:
            raise ValueError("need at least one replica")
        self.lanes = int(lanes)
        try:
            if self._faults is not None:
                self._faults.engine_init()
            self._fn = self.executor.replicated_fn(self.replicas, self.lanes)
        except (DeviceInitError, RuntimeError) as e:
            if not fallback_single_device:
                raise
            # graceful degradation: the replica program is unavailable —
            # serve everything through batched_fn(lanes) on the
            # deployment's device, one replica
            self._degraded.append(
                f"replica program init failed ({type(e).__name__}: {e}); "
                f"falling back to single-device serving")
            self.replicas = 1
            batched = self.executor.batched_fn(self.lanes)
            self._fn = lambda requests: [batched(requests)]
        self._queue = AdmissionQueue(max_pending=max_pending)
        self._results: Dict[int, Any] = {}
        self._latencies: List[float] = []
        self._next_rid = 0
        self._dispatches = 0
        self._padded = 0
        self._completed = 0
        self._admitted = 0
        self._retried = 0
        self._failed = 0
        self._trips = 0
        self._t_first_submit: Optional[float] = None
        self.stats = EngineStats(
            arena_bytes=deployment.arena_bytes,
            schedule_peak_bytes=int(deployment.schedule_result.peak),
            schedule_method=deployment.schedule_result.method,
            replicas=self.replicas, lanes=self.lanes)

    # ------------------------------------------------------ admission queue
    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def capacity(self) -> int:
        """Requests per dispatch: replicas × lanes."""
        return self.replicas * self.lanes

    def submit(self, inputs: Dict[str, Any], *, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid.  ``priority`` (larger
        first, ties FIFO) and ``deadline`` (absolute, on this engine's
        clock; None = never expires) drive admission.  A submission over
        ``max_pending`` is shed: its result is immediately a typed
        ``RequestError("shed")`` — the rid contract is unchanged."""
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        if self._t_first_submit is None:
            self._t_first_submit = now
        req = QueuedRequest(rid, inputs, now, priority=priority,
                            deadline=deadline)
        if not self._queue.push(req):
            self._results[rid] = RequestError(
                rid, "shed",
                f"queue at max_pending={self._queue.max_pending}")
        return rid

    # --------------------------------------------------------- fault layer
    def _detect_lane(self, lane: np.ndarray, injected_corrupt: bool
                     ) -> Optional[str]:
        """Post-dispatch poison detection for one lane's host arena copy.
        Returns the typed error code, or None for a clean lane."""
        ex = self.executor
        if ex.guard_regions:
            try:
                ex.verify_guards(lane)       # genuine canary verification
            except GuardViolation:
                if self._faults is None:
                    raise        # no injection active: a real OOB write
                return "corrupted"
        out = ex.outputs_from(lane)
        for val in out.values():
            if val.dtype.kind == "f" and np.isnan(val).any():
                return "nan_output"          # genuine NaN scan
        if injected_corrupt and not ex.guard_regions:
            # guard-less runs: the injector's lane report stands in for the
            # ECC/bus-fault signal real hardware raises on a flipped byte
            return "corrupted"
        return None

    def _resolve_poisoned(self, req: QueuedRequest, code: str) -> None:
        """A poisoned lane either re-queues (bounded) or fails typed."""
        if req.retries < self.max_retries:
            req.retries += 1
            self._retried += 1
            self._queue.requeue(req)
        else:
            self._results[req.rid] = RequestError(
                req.rid, code,
                f"retry budget ({self.max_retries}) exhausted")
            self._failed += 1

    # -------------------------------------------------------------- serving
    def step(self) -> int:
        """One dispatch: admit up to ``capacity`` queued requests by
        (priority, arrival) — expiring past-deadline ones — write them into
        the replicas' lanes (the rest are pad lanes), execute under
        retry/watchdog, detect injected poison, complete the survivors.
        Returns how many completed successfully."""
        if not self._queue:
            return 0
        ex = self.executor
        now = self._clock()
        admitted, expired = self._queue.pop_ready(self.capacity, now)
        for req in expired:
            self._results[req.rid] = RequestError(
                req.rid, "expired",
                f"deadline {req.deadline:.6f} passed at {now:.6f}")
        if not admitted:
            return 0
        self._admitted += len(admitted)
        self._padded += self.capacity - len(admitted)
        inputs = [req.inputs for req in admitted]

        # each attempt zeroes the static arenas and writes the requests
        # again: a retry never starts from a half-executed arena
        try:
            arenas, r, w = dispatch_with_retry(
                lambda: self._fn(inputs), faults=self._faults,
                max_retries=self.max_retries,
                dispatch_timeout=self.dispatch_timeout, clock=self._clock)
        except DispatchFailedError as e:
            for req in admitted:
                self._results[req.rid] = RequestError(
                    req.rid, "dispatch_failed", str(e))
            self._failed += len(admitted)
            self._retried += getattr(e, "retried", self.max_retries)
            self._trips += getattr(e, "watchdog_trips", 0)
            return 0
        self._retried += r
        self._trips += w
        self._dispatches += 1
        t_done = self._clock()

        lane_faults = (self._faults is not None
                       and self._faults.plan.any_lane_faults())
        if not lane_faults and not ex.guard_regions:
            # production path: outputs copied straight out of the replicas'
            # arenas; lanes i >= len(admitted) are pads, never read
            for i, req in enumerate(admitted):
                r_, b_ = divmod(i, self.lanes)
                self._results[req.rid] = ex.outputs_from(arenas[r_], b_)
                self._latencies.append(t_done - req.t_submit)
            self._completed += len(admitted)
            return len(admitted)

        # fault/guard path: a writable host copy of each admitted lane (the
        # static arenas are never touched), inject per-lane poison, then
        # detect and resolve
        host = []
        for i in range(len(admitted)):
            r_, b_ = divmod(i, self.lanes)
            host.append(arenas[r_][b_].to("cpu", copy=True).numpy())
        corrupt = set()
        if lane_faults:
            corrupt = set(self._faults.corrupt_lanes(len(admitted)))
            for i in corrupt:
                self._faults.corrupt_arena(host[i], ex.guard_regions)
            for i in self._faults.nan_lanes(len(admitted)):
                if i in corrupt:
                    continue
                self._faults.inject_nan(host[i], ex)
        done = 0
        for i, req in enumerate(admitted):
            code = self._detect_lane(host[i], i in corrupt)
            if code is not None:
                self._resolve_poisoned(req, code)
                continue
            self._results[req.rid] = ex.outputs_from(host[i])
            self._latencies.append(t_done - req.t_submit)
            done += 1
        self._completed += done
        return done

    def take(self, rid: int):
        """The completed result for ``rid`` (pops it): an outputs dict, or
        a typed ``RequestError`` for expired/shed/failed requests."""
        return self._results.pop(rid)

    def drain(self) -> Dict[int, Any]:
        """Step until the queue is empty; returns {rid: result} for every
        result completed and not yet taken (outputs dicts and typed
        ``RequestError`` entries), and records serve stats — including the
        failure-layer counters — over the window since the first
        un-drained submit."""
        while self._queue:
            self.step()
        wall = (self._clock() - self._t_first_submit
                if self._t_first_submit is not None else 0.0)
        self.stats.record_serve(
            requests=self._completed, padded_lanes=self._padded,
            dispatches=self._dispatches, wall_s=wall,
            latencies_s=self._latencies)
        self.stats.admitted = self._admitted
        self.stats.expired = self._queue.expired
        self.stats.shed = self._queue.shed
        self.stats.retried = self._retried
        self.stats.failed = self._failed
        self.stats.watchdog_trips = self._trips
        self.stats.degraded = list(self._degraded) or None
        self._completed = 0
        self._admitted = 0
        self._retried = 0
        self._failed = 0
        self._trips = 0
        self._dispatches = 0
        self._padded = 0
        self._latencies = []
        self._queue.expired = 0
        self._queue.shed = 0
        self._t_first_submit = None
        out, self._results = self._results, {}
        return out

    # -------------------------------------------------------- one-shot API
    def serve(self, requests: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Submit every request, drain, return outputs in request order
        (same contract as ``GraphServingEngine.serve``)."""
        rids = [self.submit(r) for r in requests]
        done = self.drain()
        return [done[rid] for rid in rids]
