"""Work of the squeeze-and-excite channel scales a graph executes, counted
from its shapes: for each scale of the executed schedule (a slice of one
included), the map read once and the output written once, two bytes an
element a lane, and the gate read once, one byte a channel a lane (K10
reads each channel's gate byte again for every element it scales, but
from the read-only cache, not from memory).  A scale has no weights and
one product and one requantize an element, so its bound on the card is
its bytes over the memory bandwidth."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

SCALE_KINDS = ("mul", "qmul")


@dataclasses.dataclass
class Scales:
    count: int = 0         # scale operators of one dispatch (launches of K10)
    bytes: int = 0         # bytes they move over every lane
    bound_s: float = 0.0   # bytes / the card's memory bandwidth


def executed_scales(graph, schedule: Iterable, lanes: int,
                    peaks: Optional[Dict[str, float]]) -> Scales:
    """The channel scales of one dispatch of ``schedule`` over ``lanes``
    lanes, on a card of ``peaks`` (``hbm_bytes_per_s``; None: no
    bound)."""
    out = Scales()
    for op in schedule:
        if op.kind not in SCALE_KINDS:
            continue
        out.count += 1
        out.bytes += lanes * (2 * graph.tensors[op.output].size
                              + graph.tensors[op.inputs[1]].size)
    if peaks is not None:
        out.bound_s = out.bytes / peaks["hbm_bytes_per_s"]
    return out


__all__ = ["SCALE_KINDS", "Scales", "executed_scales"]
