"""Deterministic fault injection for the serving/deploy failure layer.

Chaos testing an MCU inference stack only works if the chaos replays: a
fault that appears on one CI run and not the next is a flake, not a test.
Everything here is therefore driven by one seeded ``numpy`` generator
inside ``FaultInjector`` — the same ``FaultPlan`` (seed + rates) produces
the same fault sequence on every run, so ``tests/test_chaos.py`` can
assert exact outcomes (which lanes were poisoned, how many retries fired)
rather than statistical ones.

Fault taxonomy (DESIGN.md §12):

* **device error** — the dispatch call raises ``TransientDeviceError``
  before executing; models a flaky bus/DMA transfer.  Retryable.
* **slow dispatch** — the dispatch stalls ``slow_s`` seconds; models a
  contended device.  The post-hoc watchdog in ``dispatch_with_retry``
  detects the overrun, discards the (complete but late) result and
  re-dispatches — see the honesty note on that function.
* **corrupted arena bytes** — lane arena bytes are XOR-flipped after
  execution; models bit-flips/out-of-bounds writes.  Detected either by
  genuine guard-canary verification (when the plan carries guard bytes)
  or by the injector's own lane report standing in for the ECC/bus-fault
  signal real hardware would raise.
* **NaN activations** — a float output lane is overwritten with NaN;
  detected by a genuine ``np.isnan`` scan of decoded outputs.
* **engine-init failure** — replica-mesh bring-up raises
  ``DeviceInitError``; the sharded engine degrades to single-device.

The injector mutates **numpy copies** of lane arenas only — jax buffers
are never written in place, so with faults disabled the execution path is
byte-identical to the un-instrumented engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.errors import (DeviceInitError, DispatchFailedError,
                          TransientDeviceError)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule.  All rates are per-dispatch (or per-lane for
    corruption/NaN) probabilities in [0, 1]; the default plan injects
    nothing and costs nothing."""

    seed: int = 0
    device_error_rate: float = 0.0   # dispatch raises TransientDeviceError
    slow_rate: float = 0.0           # dispatch sleeps slow_s first
    slow_s: float = 0.02
    corrupt_rate: float = 0.0        # per-lane arena byte corruption
    corrupt_bytes: int = 4
    nan_rate: float = 0.0            # per-lane NaN output poisoning
    fail_engine_init: bool = False   # replica mesh bring-up fails

    def any_lane_faults(self) -> bool:
        return self.corrupt_rate > 0.0 or self.nan_rate > 0.0


class FaultInjector:
    """Executes a ``FaultPlan`` with one private seeded RNG.

    ``injected`` counts every fault actually fired, keyed by kind — the
    chaos suite's ledger: every count here must be matched by a
    retry-success, a typed error result, or a recorded degradation.
    """

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.injected: Dict[str, int] = {
            "device_error": 0, "slow": 0, "corrupt": 0, "nan": 0,
            "engine_init": 0,
        }

    # ----------------------------------------------------------- init
    def engine_init(self) -> None:
        """Hook at replica-mesh bring-up; raises when the plan says the
        mesh fails (models a missing/odd device topology)."""
        if self.plan.fail_engine_init:
            self.injected["engine_init"] += 1
            raise DeviceInitError("injected replica-mesh init failure")

    # ------------------------------------------------------- dispatch
    def before_dispatch(self, sleep: Callable[[float], None] = time.sleep
                        ) -> None:
        """Hook before each dispatch: one RNG draw decides device error
        (raises) vs slow dispatch (sleeps) vs nothing.  One draw, not two,
        keeps the fault sequence a pure function of the draw count."""
        p = self.plan
        if p.device_error_rate <= 0.0 and p.slow_rate <= 0.0:
            return
        u = float(self._rng.random())
        if u < p.device_error_rate:
            self.injected["device_error"] += 1
            raise TransientDeviceError("injected transient device error")
        if u < p.device_error_rate + p.slow_rate:
            self.injected["slow"] += 1
            sleep(p.slow_s)

    # ---------------------------------------------------- lane faults
    def corrupt_lanes(self, n_lanes: int) -> List[int]:
        """Which of ``n_lanes`` get arena-byte corruption this dispatch."""
        if self.plan.corrupt_rate <= 0.0 or n_lanes == 0:
            return []
        draws = self._rng.random(n_lanes)
        return [i for i in range(n_lanes)
                if draws[i] < self.plan.corrupt_rate]

    def nan_lanes(self, n_lanes: int) -> List[int]:
        """Which of ``n_lanes`` get NaN output poisoning this dispatch."""
        if self.plan.nan_rate <= 0.0 or n_lanes == 0:
            return []
        draws = self._rng.random(n_lanes)
        return [i for i in range(n_lanes) if draws[i] < self.plan.nan_rate]

    def corrupt_arena(self, lane_arena: np.ndarray,
                      guard_regions: Sequence[Tuple[int, int]] = ()) -> None:
        """XOR-flip ``corrupt_bytes`` bytes of one lane arena in place
        (numpy copy, never a jax buffer).  When the plan has guard
        regions, corruption lands inside one — modelling the adjacent
        out-of-bounds write guards exist to catch — so detection is the
        *genuine* canary check, not injector bookkeeping."""
        self.injected["corrupt"] += 1
        n = min(self.plan.corrupt_bytes, lane_arena.size)
        if n <= 0:
            return
        if guard_regions:
            regions = list(guard_regions)
            off, size = regions[int(self._rng.integers(len(regions)))]
            start = off + int(self._rng.integers(max(1, size - n + 1)))
            n = min(n, off + size - start)
        else:
            start = int(self._rng.integers(max(1, lane_arena.size - n + 1)))
        lane_arena[start:start + n] ^= 0xFF

    def inject_nan(self, lane_arena: np.ndarray, executor) -> bool:
        """Overwrite the first float32 output's leading element with NaN
        in one lane arena (numpy copy).  Returns False when the graph has
        no float output to poison (int8 outputs can't encode NaN)."""
        for name in executor.graph.outputs:
            if executor.graph.tensors[name].dtype == "float32":
                off, _size = executor.offsets[name]
                nan = np.frombuffer(
                    np.float32(np.nan).tobytes(), dtype=np.uint8)
                lane_arena[off:off + 4] = nan
                self.injected["nan"] += 1
                return True
        return False


def dispatch_with_retry(dispatch: Callable[[], object], *,
                        faults: Optional[FaultInjector] = None,
                        max_retries: int = 2,
                        dispatch_timeout: Optional[float] = None,
                        clock: Callable[[], float] = time.perf_counter
                        ) -> Tuple[object, int, int]:
    """Run ``dispatch`` with bounded retry-on-transient-failure and a
    post-hoc watchdog.  Returns ``(result, retried, watchdog_trips)``;
    raises ``DispatchFailedError`` once the retry budget is spent.

    Watchdog honesty: a synchronous jax call cannot be pre-empted from
    Python, so the watchdog is *post-hoc* — it measures elapsed wall time
    and, past ``dispatch_timeout``, discards the (late but complete)
    result and re-dispatches.  That bounds how stale a served result can
    be and converts a persistently-slow device into a typed
    ``DispatchFailedError`` instead of unbounded tail latency; it does
    not abort an in-flight kernel.  Double execution is safe because the
    compiled arena program is pure (callers rebuild donated inputs per
    attempt).
    """
    retried = 0
    watchdog_trips = 0
    last_err: Optional[BaseException] = None
    for attempt in range(max_retries + 1):
        t0 = clock()
        try:
            if faults is not None:
                faults.before_dispatch()
            result = dispatch()
        except TransientDeviceError as e:
            last_err = e
            retried += 1
            continue
        if dispatch_timeout is not None and clock() - t0 > dispatch_timeout:
            watchdog_trips += 1
            last_err = TransientDeviceError(
                f"dispatch exceeded watchdog timeout {dispatch_timeout}s")
            retried += 1
            continue
        return result, retried, watchdog_trips
    err = DispatchFailedError(
        f"dispatch failed after {max_retries + 1} attempts "
        f"(last: {last_err})")
    err.retried = retried                  # the spent budget rides on the
    err.watchdog_trips = watchdog_trips    # exception so stats stay exact
    raise err from last_err


__all__ = ["FaultPlan", "FaultInjector", "dispatch_with_retry"]
