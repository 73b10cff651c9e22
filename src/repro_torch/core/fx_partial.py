"""Partial execution (Pex-style) for traced PyTorch programs — the port's
counterpart of the reference's ``jaxpr_partial``.

``fx_reorder`` applies the paper's operator reordering to the aten nodes
of a ``torch.fx`` graph; this module applies its sequel's transform: a
chain of eligible nodes is split into K row slices so the chain's
interior tensors only ever exist one slice at a time.  The rewritten
program allocates the chain's output once (``aten.empty``), computes
each output slice from row views of the chain's inputs (``aten.slice``,
free) and clones of the chain's nodes, and writes it into that
accumulator with ``write_rows``: ``Tensor.copy_`` into
``acc.narrow(0, start, rows)``, in place, returning the accumulator.
``fx_reorder.fx_to_graph`` marks each ``write_rows`` ``inplace`` on its
accumulator (as the reference marks ``dynamic_update_slice``), so the
liveness model charges the output buffer exactly once — which is what
eager torch allocates.

Eligible nodes (split along the leading axis of the output):

* shape-preserving **elementwise** aten ops (every tensor operand has the
  output's shape, or is 0-dim and taken whole);
* **mm** / **addmm** — the left-hand side's rows are free, so slicing them
  slices the output's rows; the right-hand side (weights) is taken whole,
  and so is an addmm bias that broadcasts over the rows;
* **sum / amax / amin / prod** over dimensions that do not include
  dimension 0.

All have identity row maps (no halo), so slicing costs no recompute.  A
run is a chain of two or more of them along the scheduling graph's linear
chains, each link reading the previous node itself at sliced positions
only; its output must be contiguous (the accumulator is).  The expansion
takes the place of the run's last node, after every input of the run.

Numerics, the reference's contract: elementwise and reduce slices are
bit-identical (slices hold the same bits, and each element's reduction
runs over the same values in the same order); a sliced ``mm`` may differ
from the whole op within float accumulation tolerance (~1 ulp per
contraction step), because the GEMM library's kernel — and with it the
K-blocking order — depends on the row count.

The transform is conservative: anything it does not recognise leaves the
program unchanged.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import fx

from .fx_reorder import _node_args, alias_base, fx_to_graph, node_bytes
from .graph import linear_chains

aten = torch.ops.aten

ELEMENTWISE_OPS = frozenset({
    aten.add, aten.sub, aten.mul, aten.div, aten.maximum, aten.minimum,
    aten.pow, aten.remainder, aten.fmod, aten.neg, aten.abs, aten.sign,
    aten.exp, aten.expm1, aten.log, aten.log1p, aten.sqrt, aten.rsqrt,
    aten.reciprocal, aten.tanh, aten.sigmoid, aten.erf, aten.sin, aten.cos,
    aten.tan, aten.sinh, aten.cosh, aten.floor, aten.ceil, aten.round,
    aten.trunc, aten.relu, aten.clamp, aten.where, aten._to_copy,
    aten.bitwise_and, aten.bitwise_or, aten.bitwise_xor, aten.bitwise_not,
    aten.logical_and, aten.logical_or, aten.logical_not,
    aten.gt, aten.lt, aten.ge, aten.le, aten.eq, aten.ne,
})
REDUCE_OPS = frozenset({aten.sum, aten.amax, aten.amin, aten.prod})


def write_rows(acc: torch.Tensor, rows: torch.Tensor,
               start: int) -> torch.Tensor:
    """Write ``rows`` into ``acc`` from row ``start`` on, in place; returns
    ``acc``."""
    acc.narrow(0, start, rows.shape[0]).copy_(rows)
    return acc


@dataclasses.dataclass(frozen=True)
class NodeSlice:
    sliced: Tuple[int, ...]   # positional args sliced along their leading axis


def _val(node) -> Optional[torch.Tensor]:
    v = node.meta.get("val") if isinstance(node, fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


def node_sliceable(node: fx.Node) -> Optional[NodeSlice]:
    """Row-slice policy of a node, or None when it cannot be split."""
    if node.op != "call_function" or not isinstance(
            node.target, torch._ops.OpOverload):
        return None
    out = _val(node)
    if out is None or out.dim() < 1 or out.shape[0] < 2:
        return None
    if any(isinstance(v, fx.Node) for v in node.kwargs.values()):
        return None
    packet = node.target.overloadpacket
    args = node.args
    if packet in ELEMENTWISE_OPS:
        sliced = []
        for pos, a in enumerate(args):
            if not isinstance(a, fx.Node):
                if isinstance(a, (list, tuple)):
                    return None
                continue                          # a Python scalar
            v = _val(a)
            if v is None:
                return None
            if tuple(v.shape) == tuple(out.shape):
                sliced.append(pos)
            elif v.dim() != 0:
                return None                       # implicit broadcast: skip
        return NodeSlice(tuple(sliced)) if sliced else None
    if packet in (aten.mm, aten.addmm):
        lhs = 0 if packet is aten.mm else 1
        if not all(isinstance(a, fx.Node) for a in args[:lhs + 2]):
            return None
        sliced = [lhs]
        if packet is aten.addmm:
            bias = _val(args[0])
            if bias is None:
                return None
            if tuple(bias.shape) == tuple(out.shape):
                sliced.insert(0, 0)
            elif bias.dim() == 2 and bias.shape[0] != 1:
                return None
        return NodeSlice(tuple(sliced))
    if packet in REDUCE_OPS:
        x = _val(args[0]) if args and isinstance(args[0], fx.Node) else None
        if x is None or x.dim() < 1 or x.shape[0] != out.shape[0]:
            return None
        dims = args[1] if len(args) > 1 else node.kwargs.get("dim")
        if dims is None or isinstance(dims, fx.Node):
            return None
        dims = [dims] if isinstance(dims, int) else list(dims)
        if not dims or 0 in [d % x.dim() for d in dims]:
            return None
        return NodeSlice((0,))
    return None


def _find_runs(gm: fx.GraphModule) -> List[List[fx.Node]]:
    """Maximal runs (length >= 2) of sliceable nodes along the linear
    chains of the program's scheduling graph, where each link reads the
    previous node itself, at sliced positions only."""
    fg = fx_to_graph(gm)
    runs: List[List[fx.Node]] = []
    for chain in linear_chains(fg.graph):
        cur: List[fx.Node] = []
        for op in chain:
            node = fg.node_of[op.name]
            spec = node_sliceable(node)
            ok = spec is not None
            if ok and cur:
                prev = cur[-1]
                reads = [p for p, a in enumerate(node.args)
                         if isinstance(a, fx.Node)
                         and fg.tensor_of[a] == fg.tensor_of[prev]]
                ok = bool(reads) and all(
                    p in spec.sliced and node.args[p] is prev for p in reads)
            if ok:
                cur.append(node)
            else:
                if len(cur) >= 2:
                    runs.append(cur)
                cur = [node] if spec is not None else []
        if len(cur) >= 2:
            runs.append(cur)
    return [r for r in runs if _val(r[-1]).is_contiguous()]


def _estimate_run(nodes: Sequence[fx.Node], k: int,
                  shard_divisor: int = 1) -> Tuple[int, int]:
    """(estimated local peak after splitting into k slices, before) — in the
    same per-device units the caller's budget uses."""
    def nbytes(n):
        return node_bytes(n.meta.get("val"), shard_divisor)

    internal = set(nodes)
    ext, seen = 0, set()
    for n in nodes:
        for a in _node_args(n):
            if a in internal or a in seen:
                continue
            seen.add(a)
            ext += nbytes(a)
    out_b = nbytes(nodes[-1])
    slice_live = before = 0
    for n in nodes:
        spec = node_sliceable(n)
        assert spec is not None
        whole = nbytes(n) + sum(nbytes(a) for a in _node_args(n))
        before = max(before, whole)
        step = -(-nbytes(n) // k)
        for pos in spec.sliced:
            step += -(-nbytes(n.args[pos]) // k)
        slice_live = max(slice_live, step)
    return ext + out_b + slice_live, before


def _meta(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device="meta")


def _expand_run(new: fx.Graph, run: Sequence[fx.Node], k: int,
                env: Dict[fx.Node, fx.Node]) -> fx.Node:
    """Emit into ``new`` the accumulator, and per slice the row views of
    the run's inputs, the clones and the ``write_rows``; returns the last
    write (the run's output).  ``env`` maps the old graph's nodes to the
    new graph's."""
    out = _val(run[-1])
    oshape = tuple(out.shape)
    h = oshape[0]
    bounds = [(s * h) // k for s in range(k + 1)]
    acc = new.call_function(aten.empty.memory_format, (list(oshape),),
                            {"dtype": out.dtype, "device": out.device})
    acc.meta["val"] = _meta(oshape, out)
    views: Dict[Tuple[fx.Node, int, int], fx.Node] = {}
    for s in range(k):
        a, b = bounds[s], bounds[s + 1]
        prev = None
        for d, node in enumerate(run):
            spec = node_sliceable(node)
            args = []
            for pos, v in enumerate(node.args):
                if pos not in spec.sliced:
                    args.append(fx.node.map_arg(v, lambda n: env[n]))
                elif d > 0 and v is run[d - 1]:
                    args.append(prev)
                else:
                    key = (v, a, b)
                    if key not in views:
                        sv = new.call_function(aten.slice.Tensor,
                                               (env[v], 0, a, b))
                        sv.meta["val"] = _meta(
                            (b - a,) + tuple(_val(v).shape)[1:], _val(v))
                        views[key] = sv
                    args.append(views[key])
            prev = new.call_function(node.target, tuple(args),
                                     dict(node.kwargs))
            prev.meta["val"] = _meta((b - a,) + tuple(_val(node).shape)[1:],
                                     _val(node))
        acc_next = new.call_function(write_rows, (acc, prev, a))
        acc_next.meta["val"] = acc.meta["val"]
        acc = acc_next
    return acc


def partial_execute_graph_module(gm: fx.GraphModule,
                                 budget: Optional[int] = None,
                                 k_choices: Sequence[int] = (2, 4, 8, 16),
                                 shard_divisor: int = 1
                                 ) -> Tuple[fx.GraphModule, int]:
    """Split beneficial node runs.  Returns (module, #runs split).
    ``budget`` is in the same per-device units as ``shard_divisor``
    scales to (matching ``fx_to_graph``'s liveness accounting)."""
    if fx_to_graph(gm).mutation is not None:
        return gm, 0
    chosen: Dict[fx.Node, Tuple[List[fx.Node], int]] = {}
    for run in _find_runs(gm):
        h = _val(run[-1]).shape[0]
        best: Optional[Tuple[Tuple, int]] = None
        _, before = _estimate_run(run, 2, shard_divisor)
        for k in k_choices:
            if k > h:
                continue
            est, _ = _estimate_run(run, k, shard_divisor)
            if est >= before:
                continue
            meets = budget is not None and est <= budget
            key = (0 if meets else 1, est, k)
            if best is None or key < best[0]:
                best = (key, k)
        if best is not None:
            chosen[run[-1]] = (run, best[1])
    if not chosen:
        return gm, 0
    return _rewrite(gm, chosen), len(chosen)


def _rewrite(gm: fx.GraphModule,
             chosen: Dict[fx.Node, Tuple[List[fx.Node], int]]
             ) -> fx.GraphModule:
    """``gm`` with each chosen run (keyed by its last node) split into its
    number of slices."""
    dropped = {n for run, _ in chosen.values() for n in run[:-1]}
    new = fx.Graph()
    new._codegen = copy.deepcopy(gm.graph._codegen)
    env: Dict[fx.Node, fx.Node] = {}
    for node in gm.graph.nodes:
        if node in dropped:
            continue
        base = node
        while base is not None and base not in dropped:
            base = alias_base(base) if base.op == "call_function" else None
        if base is not None:
            continue            # an unread alias of a dropped node
        if node in chosen:
            run, k = chosen[node]
            env[node] = _expand_run(new, run, k, env)
        else:
            env[node] = new.node_copy(node, lambda n: env[n])
    new.lint()
    out = fx.GraphModule(gm, new)
    out.recompile()
    return out


__all__ = ["ELEMENTWISE_OPS", "NodeSlice", "REDUCE_OPS", "node_sliceable",
           "partial_execute_graph_module", "write_rows"]
