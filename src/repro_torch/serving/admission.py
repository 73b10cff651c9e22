"""Deadline- and priority-aware admission for the serving engines.

The FIFO deque the sharded engine first shipped with admitted strictly by
arrival and ran every queued request, however stale.  On a deadline-driven
deployment that is the wrong contract twice over: a request whose deadline
has already passed burns a dispatch producing an answer nobody will read,
and an unbounded queue turns overload into unbounded latency for everyone
instead of fast, explicit rejection for the excess.  ``AdmissionQueue``
fixes both:

* **priority admission** — requests are admitted by ``(priority, arrival)``:
  numerically larger ``priority`` first, ties in submission order (so the
  default ``priority=0`` queue is exactly the old FIFO — admission order is
  bit-for-bit unchanged for existing callers);
* **deadline expiry** — a request whose absolute ``deadline`` has passed by
  the time it would be admitted is *never executed*: it is returned on the
  ``expired`` side of ``pop_ready`` and the engine records a typed
  ``RequestError("expired")`` result for it;
* **bounded depth / load shedding** — with ``max_pending`` set, ``push``
  refuses requests beyond the bound (returns ``False``); the engine records
  a typed ``RequestError("shed")`` so backpressure is an explicit, typed
  outcome, not a hidden latency cliff.

Counts (``shed``, ``expired``) are exact and maintained here, property
tested in tests/test_admission.py against a reference model under random
arrival/deadline interleavings.  The queue is clock-agnostic: callers pass
``now`` explicitly, so tests and the chaos suite drive a fake clock.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional, Tuple


@dataclasses.dataclass
class QueuedRequest:
    """One pending request.  ``deadline`` is an *absolute* clock value
    (same clock as the engine's), ``None`` = never expires; larger
    ``priority`` admits first; ``retries`` counts fault-layer re-admissions
    already consumed (bounded by the engine's ``max_retries``)."""

    rid: int
    inputs: Any
    t_submit: float
    priority: int = 0
    deadline: Optional[float] = None
    retries: int = 0


@dataclasses.dataclass
class RequestError:
    """Typed per-request failure result.  Engines store these in place of
    an output dict so one bad request never tears down the serve loop;
    ``code`` is machine-checkable:

    * ``"expired"``          — deadline passed before admission
    * ``"shed"``             — queue at ``max_pending``, request refused
    * ``"dispatch_failed"``  — dispatch retries exhausted
    * ``"corrupted"``        — arena corruption detected, retries exhausted
    * ``"nan_output"``       — NaN activations detected, retries exhausted
    """

    rid: int
    code: str
    detail: str = ""


class AdmissionQueue:
    """Priority + arrival admission with deadline expiry and a bounded
    depth.  ``push`` → ``pop_ready`` is the whole lifecycle; the caller
    owns what happens to shed/expired requests (typed results)."""

    def __init__(self, max_pending: Optional[int] = None) -> None:
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._heap: List[Tuple[int, int, QueuedRequest]] = []
        self._seq = 0
        self.shed = 0       # exact count of refused pushes
        self.expired = 0    # exact count of deadline-expired pops

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, req: QueuedRequest) -> bool:
        """Enqueue ``req``; ``False`` = shed (queue at ``max_pending``)."""
        if self.max_pending is not None and len(self._heap) >= self.max_pending:
            self.shed += 1
            return False
        heapq.heappush(self._heap, (-req.priority, self._seq, req))
        self._seq += 1
        return True

    def requeue(self, req: QueuedRequest) -> None:
        """Re-admit a request the fault layer wants retried.  Bypasses the
        ``max_pending`` bound — the request was already admitted once and
        shedding it now would double-charge the overload policy.  It keeps
        its priority but takes a fresh arrival position (behind same-
        priority peers: a retry must not starve fresh requests)."""
        heapq.heappush(self._heap, (-req.priority, self._seq, req))
        self._seq += 1

    def pop_ready(self, k: int, now: float
                  ) -> Tuple[List[QueuedRequest], List[QueuedRequest]]:
        """Admit up to ``k`` requests by (priority desc, arrival asc) at
        clock ``now``.  Returns ``(admitted, expired)``: requests whose
        deadline has passed are diverted to ``expired`` — they never count
        against ``k`` and are never executed."""
        admitted: List[QueuedRequest] = []
        expired: List[QueuedRequest] = []
        while self._heap and len(admitted) < k:
            _, _, req = heapq.heappop(self._heap)
            if req.deadline is not None and now >= req.deadline:
                expired.append(req)
                self.expired += 1
            else:
                admitted.append(req)
        return admitted, expired


__all__ = ["AdmissionQueue", "QueuedRequest", "RequestError"]
