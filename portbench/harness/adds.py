"""Work of the residual adds a graph executes, counted from its shapes:
for each add of the executed schedule (a slice of one included), both
legs read and the output written once per lane.  An add has no weights
and next to no arithmetic (two products and a shift an element), so its
bound on the card is its bytes over the memory bandwidth."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

ADD_KINDS = ("add", "qadd")


@dataclasses.dataclass
class Adds:
    count: int = 0         # add operators of one dispatch (launches of K9)
    bytes: int = 0         # bytes they move over every lane
    bound_s: float = 0.0   # bytes / the card's memory bandwidth


def executed_adds(graph, schedule: Iterable, lanes: int,
                  peaks: Optional[Dict[str, float]]) -> Adds:
    """The adds of one dispatch of ``schedule`` over ``lanes`` lanes, on
    a card of ``peaks`` (``hbm_bytes_per_s``; None: no bound)."""
    out = Adds()
    for op in schedule:
        if op.kind not in ADD_KINDS:
            continue
        out.count += 1
        out.bytes += lanes * sum(graph.tensors[t].size
                                 for t in (*op.inputs, op.output))
    if peaks is not None:
        out.bound_s = out.bytes / peaks["hbm_bytes_per_s"]
    return out


__all__ = ["ADD_KINDS", "Adds", "executed_adds"]
