"""Reading the card's activity from ``torch.profiler`` over a short stretch
of the window.

``Tracer`` profiles the card and the host together; the benchmark marks
its own spans on the host (``span``: the client's submits, the engine's
steps, the takes).  ``summarize`` turns the raw events into what the
per-layer metrics read: the union of the card's busy intervals inside the
traced stretch, each device activity's count and time by name, and the
card's idle gaps labelled with what the host was doing.  The busy and
idle arithmetic follows ``chip_smoke.py``'s (a device activity is a
kernel, a copy or a memset; idle is the traced stretch less their union).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

WINDOW = "pb.traced"          # the span around the whole traced stretch
SPAN_PREFIX = "pb."
SMALL_GAP_NS = 10_000         # idle gaps below 10 us are lumped together
SMALL_GAPS = "device gaps under 10 us"
# records the profiler files under the card that are not the card's work
# (besides the benchmark's own spans, which it mirrors onto the card's
# timeline as annotations)
NOT_ACTIVITY = ("Activity Buffer Request",)


def short_name(full: str) -> str:
    """A device activity's name as the metrics group it: the port's
    kernels by their ``*_kernel`` function, copies and memsets by kind,
    PyTorch's elementwise kernels by their functor."""
    if full.startswith("Memcpy"):
        return " ".join(full.split()[:2])
    if full.startswith("Memset"):
        return "Memset"
    if "copy_kernel" in full:
        return "copy kernel"
    m = re.search(r"(\w+Functor)", full)
    if m:
        return m.group(1)
    m = re.search(r"\w+_kernel", full)
    return m.group(0) if m else full[:60]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name == "copy kernel"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[int, float]]     # count, seconds
    idle_by_host: Dict[str, float]            # seconds

    @property
    def activities(self) -> int:
        return sum(n for n, _ in self.by_name.values())

    def seconds(self, pred) -> float:
        return sum(s for name, (_, s) in self.by_name.items() if pred(name))

    def count(self, pred) -> int:
        return sum(n for name, (n, _) in self.by_name.items() if pred(name))


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns) of every recorded event."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == cuda, e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in evs]
    except AttributeError:
        return [(e.name, e.device_type == cuda,
                 int(e.time_range.start * 1000), int(e.time_range.end * 1000))
                for e in prof.events()]


def summarize(prof) -> Optional[Summary]:
    """The traced stretch of ``prof`` (the ``WINDOW`` span), or None when
    the profiler recorded no device activity inside it."""
    events = _raw_events(prof)
    win = [(s, e) for name, dev, s, e in events if name == WINDOW and not dev]
    if not win:
        return None
    w0, w1 = win[0]
    device = sorted((s, e, short_name(n)) for n, dev, s, e in events
                    if dev and e > w0 and s < w1 and n not in NOT_ACTIVITY
                    and not n.startswith(SPAN_PREFIX))
    if not device:
        return None
    by_name: Dict[str, Tuple[int, float]] = {}
    busy, gaps = 0, []
    cur_s, cur_e = max(device[0][0], w0), min(device[0][1], w1)
    gaps.append((w0, cur_s))
    for s, e, name in device:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (min(e, w1) - max(s, w0)) / 1e9)
        s, e = max(s, w0), min(e, w1)
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    host = sorted((s, e, n) for n, dev, s, e in events
                  if not dev and n != WINDOW and e > w0 and s < w1)
    return Summary((w1 - w0) / 1e9, busy / 1e9, by_name,
                   _label_gaps(gaps, host))


def _label_gaps(gaps: List[Tuple[int, int]],
                host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds by what the host was doing at each gap's midpoint:
    ``<benchmark span> > <innermost host event>``."""
    starts = [s for s, _, _ in host]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        if g1 - g0 < SMALL_GAP_NS:
            out[SMALL_GAPS] = out.get(SMALL_GAPS, 0.0) + (g1 - g0) / 1e9
            continue
        mid = (g0 + g1) // 2
        span, inner, inner_start = "outside spans", "", -1
        # events that start before mid; the host's events nest, so the
        # innermost is the latest-starting one still running at mid
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, n = host[i]
            if e < mid:
                if mid - s > 5e9:
                    break
                continue
            if n.startswith(SPAN_PREFIX):
                span = n
                break
            if s > inner_start:
                inner, inner_start = n, s
        label = f"{span} > {inner}" if inner else span
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return out


class Tracer:
    """Profiles the card and the host from ``start()`` to ``stop()``;
    ``span(name)`` marks a benchmark span while tracing (and costs nothing
    otherwise)."""

    def __init__(self) -> None:
        self._prof = None
        self._window = None
        self.summary: Optional[Summary] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def warm(self, fn) -> None:
        """Profile ``fn`` once and drop the result: the profiler's first
        start (CUPTI's set-up) is paid here, in set-up, not in the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.summary = summarize(self._prof)
        self._prof = self._window = None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)


__all__ = ["SMALL_GAPS", "Summary", "Tracer", "WINDOW", "is_copy",
           "short_name", "summarize"]
