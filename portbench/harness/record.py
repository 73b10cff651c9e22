"""What one run leaves for the metric readers: the benchmark's spans and
counts, the program's counters, the work counted from the executed graph
and the trace of the card."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .judge import Check
from .trace import Summary
from .work import Work


@dataclasses.dataclass
class Record:
    cell: Any                          # spec.Cell
    seed: int
    device_kind: str
    setup_s: float = 0.0               # process start -> first timed request
    build_s: float = 0.0               # the span around deploy.build
    arena_bytes: int = 0
    lanes: int = 1
    # the measured window: from its opening to the end of its last dispatch
    window_s: float = 0.0
    completed: int = 0                 # requests its dispatches completed
    attempted: int = 0
    failed: int = 0
    # the stretch before tracing starts (the whole window when untraced)
    quiet_s: float = 0.0
    quiet_dispatches: int = 0
    quiet_requests: int = 0            # requests those dispatches completed
    # one dispatch's work per kind of convolution, and MACs of one image
    work: Dict[str, Work] = dataclasses.field(default_factory=dict)
    executed_macs: int = 0
    model_macs: int = 0
    peaks: Optional[Dict[str, float]] = None
    trace: Optional[Summary] = None
    traced_dispatches: int = 0
    traced_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)


__all__ = ["Record"]
