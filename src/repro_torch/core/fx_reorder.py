"""Operator reordering for traced PyTorch programs — the paper's technique
applied to the aten nodes of a ``torch.fx`` graph, the port's counterpart
of the reference's ``jaxpr_reorder`` (which reorders ``ClosedJaxpr``
equations; see DESIGN.md §2).

A program is traced with ``make_fx(functionalize(fn))``: a graph of aten
nodes, each with its output's ``node.meta["val"]`` (shape and dtype), and
every in-place update of an input turned into a functional computation
followed by a trailing ``aten.copy_`` into that input.  Tensors are
nodes, sizes come from ``meta["val"]`` (optionally divided by a sharding
factor to model per-device liveness).  We build the paper's graph IR,
minimise peak liveness with the core schedulers, and re-emit the nodes in
the optimised order into a fresh ``fx.Graph`` (``node_copy``, then
``lint()`` and ``recompile()``).  Eager PyTorch runs the nodes in that
order and frees a tensor when its last use is gone, so the reported peak
is the schedule-induced peak of live tensor bytes — the working-set
accounting the paper reports for TFLite.

How nodes map onto the scheduling ``Graph``:

* placeholders and ``get_attr`` constants are its inputs;
* every other node that computes is an operator with one output tensor:
  a node whose value is a tuple or list of tensors becomes one bundle
  tensor (the sum of its outputs' bytes), and its ``getitem`` nodes are
  aliases of the bundle, as the reference bundles the outputs of a
  multi-output equation;
* **the view rule** — a view node (an aten op whose schema returns an
  alias of its input: ``view``, ``t``, ``permute``, ``select``,
  ``slice``, ``unsqueeze``, ``expand``, ``alias``, ``transpose``,
  ``split``, …, and ``_unsafe_view``, whose schema does not say so)
  shares its base's storage.  It is not an operator: a use of the view is
  a use of its base, so the base lives as long as any view of it is still
  to be read.  On re-emit, each view (and each ``getitem``) goes right
  after the node it aliases.  Views make up about half the nodes of a
  traced transformer step;
* **mutation** — after functionalization the only writes are the trailing
  ``copy_`` nodes into mutated inputs.  They are not operators; they stay
  last, after every reader, and the tensors they copy from are outputs of
  the scheduling graph.  If any other node still mutates a tensor, the
  program is returned unchanged with ``method="skipped-mutation"`` (the
  reference's ``skipped-effects``: reordering could reorder a write and
  its readers).  The accumulator writes of the partial-execution rewrite
  (``fx_partial.write_rows``) are the one exception: they are operators
  marked ``inplace`` on their accumulator.

Guarantees:

* the reordered program is a valid topological order (``lint()``);
* evaluation is numerically identical: the same aten calls on the same
  operands, in another order (tests assert bit-equality against eager
  torch).

With ``partition_budget`` set, the partial-execution rewrite
(``fx_partial``, DESIGN.md §3) may additionally split node chains into
row slices; see that module for its numerics contract.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import operator
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import fx

from .graph import Graph
from .heuristics import schedule as _schedule
from .scheduler import ScheduleResult

aten = torch.ops.aten

# aten ops whose output shares its input's storage although their schema
# declares no alias
_UNDECLARED_VIEWS = frozenset({aten._unsafe_view})


def node_bytes(val: Any, shard_divisor: int = 1) -> int:
    """Bytes of a node's value (``meta["val"]``): a tensor's, the sum over
    a tuple or list of them, 0 for anything else (the counterpart of
    ``aval_bytes``)."""
    if isinstance(val, torch.Tensor):
        size = val.numel() * val.element_size()
        return max(1, math.ceil(size / shard_divisor))
    if isinstance(val, (list, tuple)):
        return sum(node_bytes(v, shard_divisor) for v in val)
    return 0


@dataclasses.dataclass
class ReorderReport:
    n_eqns: int          # operators of the scheduling graph
    peak_before: int
    peak_after: int
    method: str
    changed: bool

    @property
    def saving(self) -> int:
        return self.peak_before - self.peak_after

    def __str__(self) -> str:
        return (f"fx reorder: {self.n_eqns} ops, peak "
                f"{self.peak_before:,} -> {self.peak_after:,} B "
                f"(-{self.saving:,}, {self.method})")


def _node_args(node: fx.Node) -> List[fx.Node]:
    """Every node ``node`` reads, in argument order, without repeats."""
    seen: List[fx.Node] = []
    fx.node.map_arg((node.args, node.kwargs),
                    lambda n: seen.append(n) if n not in seen else None)
    return seen


def is_view(node: fx.Node) -> bool:
    """An aten view of its first argument (see the module docstring)."""
    t = node.target
    if node.op != "call_function" or not isinstance(t, torch._ops.OpOverload):
        return False
    if not node.args or not isinstance(node.args[0], fx.Node):
        return False
    if len(_node_args(node)) != 1:
        return False            # reads another tensor too: an operator
    if t.overloadpacket in _UNDECLARED_VIEWS:
        return True
    rets = t._schema.returns
    return bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write


def alias_base(node: fx.Node) -> Optional[fx.Node]:
    """The node ``node`` aliases (a view's base, a ``getitem``'s bundle),
    or None when ``node`` has storage of its own."""
    if node.op == "call_function" and node.target is operator.getitem:
        return node.args[0]
    if is_view(node):
        return node.args[0]
    return None


def mutates(node: fx.Node) -> bool:
    t = node.target
    return (node.op == "call_function"
            and isinstance(t, torch._ops.OpOverload)
            and t._schema.is_mutable)


def _writebacks(gm: fx.GraphModule) -> List[fx.Node]:
    """The trailing ``copy_`` nodes into placeholders that functionalize
    leaves for mutated inputs."""
    nodes = [n for n in gm.graph.nodes if n.op != "output"]
    tail: List[fx.Node] = []
    for n in reversed(nodes):
        if (n.op == "call_function" and n.target is aten.copy_.default
                and isinstance(n.args[0], fx.Node)
                and n.args[0].op == "placeholder"):
            tail.append(n)
        else:
            break
    return tail[::-1]


@dataclasses.dataclass
class FxGraph:
    """A traced program as the scheduling ``Graph``: ``node_of`` maps each
    operator name to its fx node, ``tensor_of`` each fx node to the tensor
    it reads or writes (an alias maps to its base's), ``writebacks`` are
    the trailing copies, ``mutation`` the first other mutating node."""
    graph: Graph
    node_of: Dict[str, fx.Node]
    tensor_of: Dict[fx.Node, str]
    writebacks: List[fx.Node]
    mutation: Optional[fx.Node]


def fx_to_graph(gm: fx.GraphModule, shard_divisor: int = 1) -> FxGraph:
    """Build the scheduling graph of ``gm`` (module docstring).  Operators
    are added in node order, so the graph's default schedule is the
    program's own order."""
    from .fx_partial import write_rows
    g = Graph()
    tensor_of: Dict[fx.Node, str] = {}
    node_of: Dict[str, fx.Node] = {}
    writebacks = _writebacks(gm)
    skip = set(writebacks)
    mutation = None
    n_in = 0
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            name = f"in{n_in}"
            n_in += 1
            val = node.meta.get("val")
            if val is None and node.op == "get_attr":
                val = operator.attrgetter(node.target)(gm)
            g.add_tensor(name, node_bytes(val, shard_divisor))
            tensor_of[node] = name
            continue
        if node.op == "output" or node in skip:
            continue
        base = alias_base(node)
        if base is not None:
            tensor_of[node] = tensor_of[base]
            continue
        if mutation is None and mutates(node):
            mutation = node
        ins: List[str] = []
        for a in _node_args(node):
            t = tensor_of[a]
            if t not in ins:
                ins.append(t)
        name = f"n{len(g.operators)}_{node.name}"
        out = f"{name}.out"
        g.add_tensor(out, node_bytes(node.meta.get("val"), shard_divisor))
        tensor_of[node] = out
        attrs = {}
        if node.target is write_rows:
            attrs = {"inplace": True,
                     "inplace_input": tensor_of[node.args[0]]}
        g.add_operator(name, ins, out, kind=str(node.target), **attrs)
        node_of[name] = node
    outs: List[str] = []
    for n in _node_args(gm.graph.output_node()) + [w.args[1]
                                                   for w in writebacks]:
        t = tensor_of.get(n)
        if t is not None and t not in outs:
            outs.append(t)
    g.set_outputs(outs)
    return FxGraph(g, node_of, tensor_of, writebacks, mutation)


def _emit(gm: fx.GraphModule, order: List[fx.Node]) -> fx.GraphModule:
    """A new GraphModule of ``gm``'s nodes: its placeholders and constants,
    then ``order`` (the operators), then the writebacks and the output;
    every alias right after the node it aliases."""
    children: Dict[fx.Node, List[fx.Node]] = {}
    for node in gm.graph.nodes:
        base = alias_base(node) if node.op == "call_function" else None
        if base is not None:
            children.setdefault(base, []).append(node)
    new = fx.Graph()
    new._codegen = copy.deepcopy(gm.graph._codegen)
    env: Dict[fx.Node, fx.Node] = {}

    def put(node: fx.Node) -> None:
        env[node] = new.node_copy(node, lambda n: env[n])
        for child in children.get(node, ()):
            put(child)

    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            put(node)
    for node in order + _writebacks(gm):
        put(node)
    put(gm.graph.output_node())
    new.lint()
    out = fx.GraphModule(gm, new)
    out.recompile()
    return out


def reorder_graph_module(gm: fx.GraphModule, shard_divisor: int = 1,
                         exact_limit: int = 16, contract_limit: int = 36,
                         beam_width: int = 32,
                         partition_budget: Optional[int] = None,
                         ) -> Tuple[fx.GraphModule, ReorderReport]:
    """Reorder ``gm``'s nodes for minimal peak liveness; when
    ``partition_budget`` is given and reordering alone stays above it,
    additionally try the partial-execution rewrite (``fx_partial``) and
    keep whichever program peaks lower."""
    fg = fx_to_graph(gm, shard_divisor)
    g = fg.graph
    default_peak = g.peak_usage(g.default_schedule())
    if fg.mutation is not None:
        return gm, ReorderReport(len(g.operators), default_peak,
                                 default_peak, "skipped-mutation", False)
    res: ScheduleResult = _schedule(g, exact_limit=exact_limit,
                                    contract_limit=contract_limit,
                                    beam_width=beam_width)
    order = [fg.node_of[op.name] for op in res.schedule]
    changed = [op.name for op in res.schedule] != \
        [op.name for op in g.operators]
    if changed:
        best = (_emit(gm, order), ReorderReport(
            len(g.operators), default_peak, res.peak, res.method, True))
    else:
        best = (gm, ReorderReport(len(g.operators), default_peak,
                                  default_peak, res.method, False))
    if partition_budget is not None and best[1].peak_after > partition_budget:
        from .fx_partial import partial_execute_graph_module
        pgm, n_runs = partial_execute_graph_module(
            gm, budget=partition_budget, shard_divisor=shard_divisor)
        if n_runs:
            pgm2, rep2 = reorder_graph_module(
                pgm, shard_divisor, exact_limit, contract_limit, beam_width)
            if rep2.peak_after < best[1].peak_after:
                rep2 = dataclasses.replace(
                    rep2, peak_before=default_peak,
                    method=rep2.method + "+pex", changed=True)
                best = (pgm2, rep2)
    return best


def peak_liveness(gm: fx.GraphModule, shard_divisor: int = 1) -> int:
    """Schedule-induced peak live bytes of ``gm`` in its node order."""
    g = fx_to_graph(gm, shard_divisor).graph
    return g.peak_usage(g.default_schedule())


def trace(fn: Callable[..., Any], *args, **kwargs
          ) -> Tuple[fx.GraphModule, List[Any]]:
    """``make_fx(functionalize(fn))`` over the flattened ``(args,
    kwargs)``; returns the module and the leaves it is called with."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree
    leaves, spec = pytree.tree_flatten((args, kwargs))

    def flat(*xs):
        a, kw = pytree.tree_unflatten(list(xs), spec)
        return fn(*a, **kw)
    return make_fx(torch.func.functionalize(flat))(*leaves), leaves


def reorder(fn: Callable[..., Any], shard_divisor: int = 1,
            report_to: Optional[list] = None, **kw) -> Callable[..., Any]:
    """Function transform: trace → reorder nodes → run the reordered
    module on the same arguments.  ``report_to`` (a list) collects
    ``ReorderReport``s; ``kw`` goes to ``reorder_graph_module``."""

    def wrapped(*args, **kwargs):
        gm, leaves = trace(fn, *args, **kwargs)
        new_gm, rep = reorder_graph_module(gm, shard_divisor, **kw)
        if report_to is not None:
            report_to.append(rep)
        return new_gm(*leaves)

    return wrapped


__all__ = ["FxGraph", "ReorderReport", "alias_base", "fx_to_graph",
           "is_view", "mutates", "node_bytes", "peak_liveness", "reorder",
           "reorder_graph_module", "trace"]
