"""Typed serving statistics.

``EngineStats`` replaces the stringly-keyed ``Dict[str, float]`` both
engines used to mutate ad hoc: every field the engines report — and that
``benchmarks/run.py --json`` rows or the ``benchmarks/compare.py`` gate
consume — is a declared attribute, so a renamed or dropped stat is an
AttributeError at the producer instead of a silently-disarmed gate at the
consumer.

Two kinds of fields coexist:

* **deployment-level** (known at construction): arena bytes, schedule peak
  and method, replica/lane geometry — deterministic artefacts of the
  schedule→plan→compile chain;
* **serve-level** (filled per ``serve()``/``drain()`` call): true request
  count vs padded lanes, dispatch count, wall clock, per-request latency
  percentiles and engine throughput.

``as_json()`` emits only the fields that were actually measured (None
fields are dropped), which is what the benchmark trajectory embeds.  The
legacy ``stats["key"]`` spelling keeps working through ``__getitem__`` so
out-of-tree callers of the old dict API migrate on their own schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


def percentile_ms(latencies_s: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of a list of second-latencies, in ms."""
    if not latencies_s:
        return 0.0
    xs = sorted(latencies_s)
    k = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k] * 1e3


# old dict key -> EngineStats attribute (the pre-redesign engines used
# these spellings; __getitem__ honours them so `stats["requests"]` and
# friends stay valid during migration)
_LEGACY_KEYS = {
    "micro_batches": "dispatches",
    "arena_peak_bytes": "kv_arena_peak_bytes",
    "static_bytes": "kv_static_bytes",
}


@dataclasses.dataclass
class EngineStats:
    """One serving engine's deployment + last-serve statistics."""

    # ---- deployment-level (schedule→plan→compile artefacts)
    arena_bytes: int = 0                 # compiled arena size, bytes
    schedule_peak_bytes: int = 0         # scheduler's simulated peak
    schedule_method: str = ""            # winning scheduler rung
    replicas: int = 1                    # device replicas (1 = unsharded)
    lanes: int = 1                       # vmap lanes per replica dispatch

    # ---- serve-level (reset by each serve()/drain())
    requests: int = 0                    # true requests served
    padded_lanes: int = 0                # pad lanes executed, NOT requests
    dispatches: int = 0                  # XLA dispatches issued
    wall_s: float = 0.0                  # serve() wall clock
    us_per_request: float = 0.0          # wall / true requests
    requests_per_s: float = 0.0          # true requests / wall
    p50_ms: float = 0.0                  # per-request latency percentiles
    p99_ms: float = 0.0                  # (admission -> completion)

    # ---- robustness (failure layer, DESIGN.md §12).  These are NOT in
    # the as_json falsy-drop list on purpose: a zero here is a *measured*
    # zero — the CI bench gate requires expired/shed to be present and
    # zero on no-fault serving rows, so "0" and "absent" must differ.
    admitted: int = 0                    # requests admitted to dispatch
    expired: int = 0                     # deadline-expired, never executed
    shed: int = 0                        # refused at max_pending bound
    retried: int = 0                     # dispatch/lane retries consumed
    failed: int = 0                      # typed RequestError results
    watchdog_trips: int = 0              # post-hoc watchdog overruns
    degraded: Optional[List[str]] = None  # degradation notes, None = none

    # ---- LLM engine (KV-block arena accounting); None on graph engines
    kv_arena_peak_bytes: Optional[int] = None
    kv_static_bytes: Optional[int] = None
    peak_concurrent: Optional[int] = None

    def record_serve(self, *, requests: int, padded_lanes: int,
                     dispatches: int, wall_s: float,
                     latencies_s: Sequence[float] = ()) -> None:
        """Fill the serve-level fields from one completed serve/drain."""
        self.requests = requests
        self.padded_lanes = padded_lanes
        self.dispatches = dispatches
        self.wall_s = wall_s
        self.us_per_request = wall_s * 1e6 / requests if requests else 0.0
        self.requests_per_s = requests / wall_s if wall_s > 0 else 0.0
        self.p50_ms = percentile_ms(latencies_s, 50)
        self.p99_ms = percentile_ms(latencies_s, 99)

    def as_json(self) -> Dict[str, object]:
        """Measured fields only — the ``run.py --json`` row payload."""
        out: Dict[str, object] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if f.name in ("requests", "dispatches", "padded_lanes",
                          "wall_s", "us_per_request", "requests_per_s",
                          "p50_ms", "p99_ms") and not v:
                continue                  # never measured: drop, not 0
            out[f.name] = v
        return out

    # ------------------------------------------------- legacy dict API
    def __getitem__(self, key: str):
        name = _LEGACY_KEYS.get(key, key)
        try:
            return getattr(self, name)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key: str) -> bool:
        return hasattr(self, _LEGACY_KEYS.get(key, key))


__all__: List[str] = ["EngineStats", "percentile_ms"]
