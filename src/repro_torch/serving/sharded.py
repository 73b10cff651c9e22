"""Sharded continuous-batching serving engine: the one engine that serves
CNN requests (``GraphServingEngine`` is this engine at one replica).

It amortises launches across the lanes of one ``batched_fn``, scales out
over replicas and opens the batch boundary:

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
* **Dispatch run-ahead** — ``step`` completes exactly one dispatch, the
  oldest.  When the queue still holds a full batch (``capacity`` ready
  requests) behind the dispatch it is about to wait for, it launches that
  batch first (``ReplicatedProgram.launch``: staged, uploaded, replayed,
  downloaded into the programs' other host staging pair) and only then
  waits on the older dispatch's own events.  The next dispatch's staging
  and graph launch, the reading of the current answers and whatever the
  caller does until the next ``step`` then run while the card works.
  Only full batches run ahead, so a late arrival still joins the next
  dispatch after a ragged one.  An engine with a fault plan, a guard-byte
  plan or a ``dispatch_timeout`` dispatches synchronously instead: those
  paths read the arena the next dispatch would overwrite, or time one
  dispatch alone.
* **Bounded retry + watchdog** — each synchronous dispatch runs through
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
* **Running counters and spans** — ``counters`` reads, at any moment, the
  counts that only ever grow: the engine's own (``ENGINE_COUNTERS``:
  dispatches, requests admitted and completed, pad lanes, retries,
  failed requests, watchdog trips, dispatches launched while an earlier
  one was in flight) and the replicas' executors'
  (``EXECUTOR_COUNTERS``: lanes written, uploads, downloads and their
  bytes, replays, captures), summed.  ``drain()``'s stats are their
  differences since the last drain.
  Each dispatch opens the spans ``rt.dispatch`` > ``rt.admit``,
  ``rt.write_inputs``, ``rt.run``, ``rt.wait``, ``rt.read_outputs`` while
  ``repro_torch.tracing`` is enabled.

Every dispatch stages its lanes (``ArenaProgram``: one upload and one
download a replica that was given requests).  With no lane faults and no guards, each answer is
a copy of its lane's staged output row (``outputs_from`` of its
replica's program), bit-identical under any arrival interleaving; the
guard and fault path copies each admitted lane to the host first.
"""
from __future__ import annotations

import collections
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.device import device_count
from repro_torch.errors import (DeviceInitError, DispatchFailedError,
                                GuardViolation)
from repro_torch.mcu.compile import Launched, ReplicatedProgram
from repro_torch.serving.admission import (AdmissionQueue, QueuedRequest,
                                           RequestError)
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        dispatch_with_retry)
from repro_torch.serving.stats import EngineStats
from repro_torch.tracing import span

# What the engine itself counts, in ``step`` (they only ever grow).
ENGINE_COUNTERS = ("dispatches", "admitted", "completed", "pad_lanes",
                   "retried", "failed", "watchdog_trips", "run_ahead")


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
            self._fn = ReplicatedProgram(
                [self.executor.batched_fn(self.lanes)])
        self._queue = AdmissionQueue(max_pending=max_pending)
        # run-ahead where no fault layer reads the arena or times a
        # dispatch alone; the dispatches launched and not yet finished
        self._run_ahead = (self._faults is None and dispatch_timeout is None
                           and not self.executor.guard_regions)
        self._inflight: Deque[Tuple[List[QueuedRequest],
                                    List[Launched]]] = collections.deque()
        self._results: Dict[int, Any] = {}
        self._latencies: List[float] = []
        self._next_rid = 0
        self._counts = dict.fromkeys(ENGINE_COUNTERS, 0)
        self._at_drain = dict(self._counts)
        self._t_first_submit: Optional[float] = None
        self.stats = EngineStats(
            arena_bytes=deployment.arena_bytes,
            schedule_peak_bytes=int(deployment.schedule_result.peak),
            schedule_method=deployment.schedule_result.method,
            replicas=self.replicas, lanes=self.lanes)

    # ------------------------------------------------------ admission queue
    @property
    def pending(self) -> int:
        """Requests submitted and not yet answered: queued, or in a
        dispatch in flight."""
        return len(self._queue) + sum(len(a) for a, _ in self._inflight)

    @property
    def capacity(self) -> int:
        """Requests per dispatch: replicas × lanes."""
        return self.replicas * self.lanes

    @property
    def counters(self) -> Dict[str, int]:
        """The running counts, read now: the engine's ``ENGINE_COUNTERS``
        and, summed over the replicas' executors, their
        ``EXECUTOR_COUNTERS`` (everything run on those executors counts,
        ``Deployment.run`` too).  Take differences between two reads."""
        out = dict(self._counts)
        for prog in self._fn.programs:
            for name, n in prog.executor.counters.items():
                out[name] = out.get(name, 0) + n
        return out

    @property
    def capture_s(self) -> float:
        """Host seconds the replicas' CUDA graphs took to warm up and
        capture (0 on the CPU and before the first dispatch)."""
        return sum((p.graph.warmup_ms + p.graph.capture_ms) / 1e3
                   for p in self._fn.programs if p.graph is not None)

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
            self._counts["retried"] += 1
            self._queue.requeue(req)
        else:
            self._results[req.rid] = RequestError(
                req.rid, code,
                f"retry budget ({self.max_retries}) exhausted")
            self._counts["failed"] += 1

    # -------------------------------------------------------------- serving
    def step(self) -> int:
        """Complete one dispatch, the oldest: admit up to ``capacity``
        queued requests by (priority, arrival) — expiring past-deadline
        ones — write them into the replicas' lanes (the rest are pad
        lanes), execute, and complete them.  With run-ahead (see the
        module docstring) a dispatch launched by the last ``step`` is the
        one completed, and the next full batch is launched before it is
        waited for; otherwise the dispatch runs synchronously under
        retry/watchdog and its injected poison is detected.  Returns how
        many completed successfully."""
        if not self._queue and not self._inflight:
            return 0
        with span("dispatch"):
            if self._run_ahead:
                return self._step_ahead()
            return self._dispatch()

    def _admit(self, now: float) -> List[QueuedRequest]:
        """Pop up to ``capacity`` requests at ``now``; the past-deadline
        ones complete as ``expired``."""
        with span("admit"):
            admitted, expired = self._queue.pop_ready(self.capacity, now)
            for req in expired:
                self._results[req.rid] = RequestError(
                    req.rid, "expired",
                    f"deadline {req.deadline:.6f} passed at {now:.6f}")
        if admitted:
            self._counts["admitted"] += len(admitted)
            self._counts["pad_lanes"] += self.capacity - len(admitted)
        return admitted

    def _step_ahead(self) -> int:
        if not self._inflight and not self._launch(self._clock()):
            return 0                      # everything queued had expired
        now = self._clock()
        if self._queue.can_fill(self.capacity, now):
            self._launch(now)
            self._counts["run_ahead"] += 1
        return self._finish()

    def _launch(self, now: float) -> bool:
        """Admit a dispatch at ``now`` and launch it without waiting for
        it; False when nothing was admitted."""
        admitted = self._admit(now)
        if not admitted:
            return False
        launched = self._fn.launch([req.inputs for req in admitted])
        self._inflight.append((admitted, launched))
        self._counts["dispatches"] += 1
        return True

    def _finish(self) -> int:
        """Wait for the oldest dispatch in flight and complete it."""
        admitted, launched = self._inflight.popleft()
        return self._complete(admitted, self._fn.finish(launched))

    def _dispatch(self) -> int:
        counts = self._counts
        admitted = self._admit(self._clock())
        if not admitted:
            return 0
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
            counts["failed"] += len(admitted)
            counts["retried"] += getattr(e, "retried", self.max_retries)
            counts["watchdog_trips"] += getattr(e, "watchdog_trips", 0)
            return 0
        counts["retried"] += r
        counts["watchdog_trips"] += w
        counts["dispatches"] += 1
        return self._complete(admitted, arenas)

    def _complete(self, admitted: List[QueuedRequest],
                  arenas: List[Any]) -> int:
        """Read the admitted requests' outputs (``rt.read_outputs``);
        returns how many completed."""
        t_done = self._clock()
        with span("read_outputs"):
            done = self._read_outputs(admitted, arenas, t_done)
        self._counts["completed"] += done
        return done

    def _read_outputs(self, admitted: List[QueuedRequest],
                      arenas: List[Any], t_done: float) -> int:
        """Read the admitted requests' outputs out of ``arenas``; returns
        how many completed."""
        ex = self.executor
        lane_faults = (self._faults is not None
                       and self._faults.plan.any_lane_faults())
        if not lane_faults and not ex.guard_regions:
            # production path: each answer a copy of its lane's row of its
            # replica's staged outputs; lanes i >= len(admitted) are pads,
            # never read
            progs = self._fn.programs
            for i, req in enumerate(admitted):
                r_, b_ = divmod(i, self.lanes)
                self._results[req.rid] = ex.outputs_from(progs[r_], b_)
                self._latencies.append(t_done - req.t_submit)
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
        return done

    def take(self, rid: int):
        """The completed result for ``rid`` (pops it): an outputs dict, or
        a typed ``RequestError`` for expired/shed/failed requests.  A rid
        in a dispatch still in flight finishes that dispatch (and any
        older one) first."""
        if rid not in self._results:
            for i, (admitted, _) in enumerate(self._inflight):
                if any(req.rid == rid for req in admitted):
                    with span("dispatch"):
                        for _ in range(i + 1):
                            self._finish()
                    break
        return self._results.pop(rid)

    def drain(self) -> Dict[int, Any]:
        """Step until the queue is empty and no dispatch is in flight;
        returns {rid: result} for every
        result completed and not yet taken (outputs dicts and typed
        ``RequestError`` entries), and records serve stats — including the
        failure-layer counters — over the window since the first
        un-drained submit."""
        while self._queue or self._inflight:
            self.step()
        wall = (self._clock() - self._t_first_submit
                if self._t_first_submit is not None else 0.0)
        now = dict(self._counts)
        moved = {k: now[k] - self._at_drain[k] for k in now}
        self.stats.record_serve(
            requests=moved["completed"], padded_lanes=moved["pad_lanes"],
            dispatches=moved["dispatches"], wall_s=wall,
            latencies_s=self._latencies)
        self.stats.admitted = moved["admitted"]
        self.stats.expired = self._queue.expired
        self.stats.shed = self._queue.shed
        self.stats.retried = moved["retried"]
        self.stats.failed = moved["failed"]
        self.stats.watchdog_trips = moved["watchdog_trips"]
        self.stats.degraded = list(self._degraded) or None
        self._at_drain = now
        self._latencies = []
        self._queue.expired = 0
        self._queue.shed = 0
        self._t_first_submit = None
        out, self._results = self._results, {}
        return out

    # -------------------------------------------------------- one-shot API
    def serve(self, requests: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Submit every request, drain, return the results in request
        order: outputs dicts and typed ``RequestError`` entries."""
        rids = [self.submit(r) for r in requests]
        done = self.drain()
        return [done[rid] for rid in rids]
