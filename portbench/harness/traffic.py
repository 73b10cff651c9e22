"""The one traffic generator: a mix file's parameters and a seed in, the
requests' images and arrival times out.

Kinds:

* ``backlog`` — a closed backlog: the queue never holds fewer than
  ``queue_dispatches`` dispatches' worth of requests, so the system sets
  the pace.  No arrival times.
* ``poisson`` — an open loop at ``rate_per_s``: ``round(rate * seconds)``
  requests due over the window.  The gaps are the exponential
  distribution's quantiles at the midpoints of equal-probability strata,
  in an order drawn from the seed, so every seed offers the same set of
  gaps and the same total time, and only their order changes.

Every request carries one image of a pool of ``pool`` images; the images
are taken in successive permutations of the pool drawn from the seed, so
every image is used once before any is used again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

STREAM_ORDER, STREAM_GAPS = 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


class ImageOrder:
    """Pool indices of requests 0, 1, 2, ... (successive seeded
    permutations of the pool)."""

    def __init__(self, pool: int, seed: int) -> None:
        self.pool = pool
        self._rng = rng(seed, STREAM_ORDER)
        self._order = np.empty(0, np.int64)

    def __getitem__(self, i: int) -> int:
        while i >= self._order.size:
            self._order = np.concatenate(
                [self._order, self._rng.permutation(self.pool)])
        return int(self._order[i])


@dataclasses.dataclass
class Schedule:
    kind: str
    images: ImageOrder
    due: Optional[np.ndarray]        # seconds after the window opens
    queue_dispatches: int = 0        # backlog: dispatches kept queued


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """``n`` gaps: the exponential quantiles at (i + 0.5) / n."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / rate


def schedule(params: Dict[str, Any], seed: int, seconds: float) -> Schedule:
    kind = params["kind"]
    images = ImageOrder(int(params["pool"]), seed)
    if kind == "backlog":
        return Schedule(kind, images, None, int(params["queue_dispatches"]))
    if kind == "poisson":
        rate = float(params["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        gaps = rng(seed, STREAM_GAPS).permutation(exponential_gaps(n, rate))
        # the first request is due when the window opens
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        return Schedule(kind, images, due)
    raise ValueError(f"unknown traffic kind {kind!r}")


__all__ = ["ImageOrder", "Schedule", "exponential_gaps", "rng", "schedule"]
