"""Work a graph asks for, counted from its shapes: multiply-accumulates,
operations and bytes of each convolution, grouped by the kind of kernel
that runs it.

The counts come from the graph the program executes (its slices, tiles
and ring windows as they are), not from the launches, so a kernel that
later fuses or splits them is held to the same work.  A convolution's
bytes are its input and output once per lane, times the lanes, and its
weights once per call; its operations are two per multiply-accumulate,
every tap counted.  Which kernel names run which kind of convolution is
data (``data/kernel_kinds.json``), and so are the card's peaks
(``data/peaks.json``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

CONV_KINDS = ("conv", "dwconv", "qconv", "qdwconv")


def conv_kind(op) -> Optional[str]:
    """``pointwise`` (1x1, stride 1, no pads: the 1x1 kernel), ``depthwise``
    or ``conv`` (any other window) for a convolution; None otherwise."""
    if op.kind in ("dwconv", "qdwconv"):
        return "depthwise"
    if op.kind not in ("conv", "qconv"):
        return None
    a = op.attrs
    flat = all(tuple(a.get(p) or (0, 0)) == (0, 0)
               for p in ("pex_pads", "pex_wpads"))
    return ("pointwise" if a.get("k", 1) == 1 and a["stride"] == 1 and flat
            else "conv")


def op_macs(graph, op) -> int:
    """Multiply-accumulates of one lane of ``op``: convolutions (every tap)
    and fully connected layers; 0 for anything else."""
    if op.kind in CONV_KINDS:
        oh, ow, cout = graph.tensors[op.output].shape
        taps = op.attrs.get("k", 1) ** 2
        cin = graph.tensors[op.inputs[0]].shape[-1]
        return oh * ow * cout * taps * (1 if "dw" in op.kind else cin)
    if op.kind in ("fc", "qfc"):
        return (graph.tensors[op.inputs[0]].elements
                * graph.tensors[op.output].elements)
    return 0


@dataclasses.dataclass
class Work:
    macs: int = 0          # all lanes
    ops: int = 0           # 2 x macs
    bytes: int = 0
    bound_s: float = 0.0   # sum over calls of max(bytes / bw, ops / peak)


def executed_work(graph, schedule: Iterable, lanes: int,
                  peaks: Dict[str, float]) -> Dict[str, Work]:
    """Per kind of convolution, the work of one dispatch of ``schedule``
    over ``lanes`` lanes, with its roofline bound on a card of ``peaks``
    (``hbm_bytes_per_s``, ``int8_ops_per_s``)."""
    out: Dict[str, Work] = {}
    for op in schedule:
        kind = conv_kind(op)
        if kind is None:
            continue
        macs = op_macs(graph, op) * lanes
        nbytes = (lanes * (graph.tensors[op.inputs[0]].size
                           + graph.tensors[op.output].size)
                  + int(op.attrs.get("weight_bytes", 0)))
        w = out.setdefault(kind, Work())
        w.macs += macs
        w.ops += 2 * macs
        w.bytes += nbytes
        w.bound_s += max(nbytes / peaks["hbm_bytes_per_s"],
                         2 * macs / peaks["int8_ops_per_s"])
    return out


def graph_macs(graph, schedule: Optional[Iterable] = None) -> int:
    """Multiply-accumulates of one lane of ``schedule`` (default: every
    operator of ``graph``)."""
    ops = graph.operators if schedule is None else schedule
    return sum(op_macs(graph, op) for op in ops)


def card_peaks(table: Dict[str, Any], kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind`` (the first key of ``table``
    that the name contains), or None for a card the table lacks."""
    for key, peaks in table.items():
        if key in kind:
            return peaks
    return None


__all__ = ["CONV_KINDS", "Work", "card_peaks", "conv_kind", "executed_work",
           "graph_macs", "op_macs"]
