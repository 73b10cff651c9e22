"""The paper's Figure-1 example graph, reconstructed exactly from Appendix A.

Solving the working-set tables of Figures 2/3 gives the tensor sizes:
  t0=1568 (input), t1=3136, t2=1568, t3=512, t4=512, t5=256, t6=256, t7=512
and the structure: two branches off t1 — (op2→op3→op5) and (op4→op6) —
joined by a concat (op7):

    t0 ──op1──► t1 ──op2──► t2 ──op3──► t3 ──op5──► t5 ─┐
                 └──op4──► t4 ──op6──► t6 ───────────────┴─op7──► t7

Default order 1..7 peaks at 5,216 B (at op3); optimal order
1,4,6,2,3,5,7 peaks at 4,960 B (at op2).

The executable variants carry deterministic torch semantics.  Each ``fn``
takes one lane's unbatched tensor, as in the reference; the arena
executor's ``op.fn`` fallback calls it once per lane.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import Graph

SIZES = {"t0": 1568, "t1": 3136, "t2": 1568, "t3": 512,
         "t4": 512, "t5": 256, "t6": 256, "t7": 512}

DEFAULT_PEAK = 5216
OPTIMAL_PEAK = 4960


def _wire_ops(g: Graph) -> None:
    g.add_operator("op1", ["t0"], "t1", kind="conv2d")
    g.add_operator("op2", ["t1"], "t2", kind="conv2d")
    g.add_operator("op3", ["t2"], "t3", kind="conv2d")
    g.add_operator("op4", ["t1"], "t4", kind="conv2d")
    g.add_operator("op5", ["t3"], "t5", kind="conv2d")
    g.add_operator("op6", ["t4"], "t6", kind="conv2d")
    g.add_operator("op7", ["t5", "t6"], "t7", kind="concat")
    g.set_outputs(["t7"])


def figure1_graph() -> Graph:
    g = Graph()
    for name, size in SIZES.items():
        g.add_tensor(name, size)
    _wire_ops(g)
    return g


def _resize(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.resize(x, (n,))``: the flattened input repeated cyclically and
    cut to ``n`` elements."""
    flat = x.reshape(-1)
    return flat.repeat(-(-n // flat.numel()))[:n]


def _concat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in xs])


def figure1_executable_graph() -> Graph:
    """figure1 with deterministic f32 semantics attached, so the executors
    (micro-interpreter and compiled) can run it — the paper's figure is a
    scheduling exemplar and ships without numerics.  The byte sizes are the
    paper's, so as a float32 graph each tensor holds ``size // 4`` elements
    (the memory model is byte-granular; dtype honesty is what the executors
    verify)."""
    g = Graph()
    for name, size in SIZES.items():
        g.add_tensor(name, size, shape=(size // 4,), dtype="float32")
    _wire_ops(g)
    for op in g.operators:
        if op.kind == "concat":
            op.fn = _concat
        else:
            n = g.elements(op.output)
            op.fn = (lambda n: lambda x: _resize(x, n) * 0.5 + 0.25)(n)
    return g


def figure1_int8_graph() -> Graph:
    """figure1 as a *directly-constructed* int8 graph (1 byte per element,
    deterministic integer semantics): ``y * 3 // 2 + 1`` on int32, with
    floor division, then clipped to int8."""
    g = Graph()
    for name, size in SIZES.items():
        g.add_tensor(name, size, shape=(size,), dtype="int8")
    _wire_ops(g)
    for op in g.operators:
        if op.kind == "concat":
            op.fn = _concat
        else:
            n = g.elements(op.output)

            def fn(x, n=n):
                y = _resize(x, n).to(torch.int32) * 3
                y = torch.div(y, 2, rounding_mode="floor") + 1
                return torch.clamp(y, -128, 127).to(torch.int8)
            op.fn = fn
    return g


__all__ = ["SIZES", "DEFAULT_PEAK", "OPTIMAL_PEAK", "figure1_graph",
           "figure1_executable_graph", "figure1_int8_graph"]
