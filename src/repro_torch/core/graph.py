"""Computation-graph IR for operator-reordering memory optimisation.

This is the data model of Liberis & Lane (2019): a DAG of operators over
tensors.  A *working set* at a point in an execution schedule is the set of
tensors that must be resident simultaneously: the pending operator's inputs
and output, plus any already-produced tensors still needed by later operators.
Constants (tensors with no producer) are counted unconditionally, matching the
paper's Algorithm 1 (they "just contribute to memory usage").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

# Byte width per supported element type.  The planner, allocators and the
# compiled executor are byte-granular: every ``Tensor.size`` is
# ``elements * itemsize(dtype)`` bytes, and arena offsets are byte offsets
# aligned to at least the tensor's itemsize (an MCU cannot dereference a
# misaligned ``float*``).  ``int8`` is the historical default so
# scheduling-only graphs with abstract byte sizes stay coherent
# (1 byte == 1 element).
DTYPE_ITEMSIZE: Dict[str, int] = {
    # no "bool": XLA cannot bitcast bytes to i1, so the compiled arena
    # executor could never honour it — masks model as uint8
    "int8": 1, "uint8": 1,
    "int16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "float32": 4,
}


def dtype_itemsize(dtype: str) -> int:
    try:
        return DTYPE_ITEMSIZE[dtype]
    except KeyError:
        raise ValueError(f"unsupported tensor dtype {dtype!r}; "
                         f"known: {sorted(DTYPE_ITEMSIZE)}") from None


@dataclasses.dataclass(frozen=True)
class Tensor:
    """A tensor in the graph. ``size`` is in **bytes**
    (= ``elements * itemsize(dtype)``)."""

    name: str
    size: int
    shape: Tuple[int, ...] = ()
    dtype: str = "int8"

    @property
    def itemsize(self) -> int:
        return dtype_itemsize(self.dtype)

    @property
    def elements(self) -> int:
        if self.size % self.itemsize:
            raise ValueError(
                f"tensor {self.name!r}: {self.size} bytes is not a multiple "
                f"of {self.dtype} itemsize {self.itemsize}")
        return self.size // self.itemsize

    def __repr__(self) -> str:  # keep trace output compact
        return f"T({self.name}:{self.size})"


@dataclasses.dataclass
class Operator:
    """An operator consuming ``inputs`` and producing a single ``output``.

    ``fn`` optionally carries executable semantics (used by the
    micro-interpreter simulator); scheduling never calls it.
    """

    name: str
    inputs: List[str]
    output: str
    kind: str = "op"
    fn: Optional[Callable[..., Any]] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


def inplace_candidates(op: "Operator") -> List[str]:
    """Inputs an ``inplace`` operator may overwrite: the one named by
    ``attrs["inplace_input"]`` when present (ops like dynamic_update_slice
    can only write into a specific operand), every input otherwise."""
    target = op.attrs.get("inplace_input")
    if target is not None:
        return [i for i in op.inputs if i == target]
    return op.inputs


class Graph:
    """A computation DAG. Tensors are identified by name; each non-constant
    tensor has exactly one producer (single-output operators, as in TFLite)."""

    def __init__(self) -> None:
        self.tensors: Dict[str, Tensor] = {}
        self.operators: List[Operator] = []
        self._producer: Dict[str, Operator] = {}
        self._consumers: Dict[str, List[Operator]] = {}
        self.outputs: List[str] = []

    # ------------------------------------------------------------------ build
    def add_tensor(self, name: str, size: int, shape: Tuple[int, ...] = (),
                   dtype: str = "int8") -> Tensor:
        if name in self.tensors:
            raise ValueError(f"duplicate tensor {name!r}")
        t = Tensor(name, int(size), tuple(shape), dtype)
        t.elements     # validates size % itemsize == 0 and a known dtype
        self.tensors[name] = t
        self._consumers.setdefault(name, [])
        return t

    def add_operator(self, name: str, inputs: Sequence[str], output: str,
                     kind: str = "op", fn: Optional[Callable[..., Any]] = None,
                     **attrs: Any) -> Operator:
        for i in inputs:
            if i not in self.tensors:
                raise ValueError(f"operator {name!r}: unknown input {i!r}")
        if output not in self.tensors:
            raise ValueError(f"operator {name!r}: unknown output {output!r}")
        if output in self._producer:
            raise ValueError(f"tensor {output!r} already has a producer")
        op = Operator(name, list(inputs), output, kind, fn, dict(attrs))
        self.operators.append(op)
        self._producer[output] = op
        for i in inputs:
            self._consumers[i].append(op)
        return op

    def set_outputs(self, names: Sequence[str]) -> None:
        for n in names:
            if n not in self.tensors:
                raise ValueError(f"unknown output tensor {n!r}")
        self.outputs = list(names)

    # ------------------------------------------------------------------ query
    def producer(self, tensor: str) -> Optional[Operator]:
        return self._producer.get(tensor)

    def consumers(self, tensor: str) -> List[Operator]:
        return self._consumers.get(tensor, [])

    def constants(self) -> List[str]:
        """Tensors with no producer: graph inputs and weights."""
        return [n for n in self.tensors if n not in self._producer]

    def size(self, tensor: str) -> int:
        return self.tensors[tensor].size

    def itemsize(self, tensor: str) -> int:
        return self.tensors[tensor].itemsize

    def elements(self, tensor: str) -> int:
        return self.tensors[tensor].elements

    def max_itemsize(self) -> int:
        """Widest element type in the graph — the natural arena alignment
        for mixed-dtype plans (see ``ArenaPlanner``)."""
        return max((t.itemsize for t in self.tensors.values()), default=1)

    def op_by_name(self, name: str) -> Operator:
        for op in self.operators:
            if op.name == name:
                return op
        raise KeyError(name)

    # Transitive predecessor relation over *operators*, via produced tensors.
    def predecessors_of_tensor(self, tensor: str) -> FrozenSet[str]:
        """All tensors that must be produced before ``tensor`` (transitively),
        excluding constants. Cached."""
        cache = getattr(self, "_pred_cache", None)
        if cache is None:
            cache = self._pred_cache = {}
        if tensor in cache:
            return cache[tensor]
        op = self._producer.get(tensor)
        if op is None:
            result: FrozenSet[str] = frozenset()
        else:
            acc: Set[str] = set()
            for i in op.inputs:
                if i in self._producer:
                    acc.add(i)
                    acc.update(self.predecessors_of_tensor(i))
            result = frozenset(acc)
        cache[tensor] = result
        return result

    # --------------------------------------------------------------- validity
    def is_valid_schedule(self, schedule: Sequence[Operator]) -> bool:
        """A valid schedule executes every operator exactly once, in an order
        where each operator's inputs are constants or already produced."""
        if len(schedule) != len(self.operators) or set(id(o) for o in schedule) != set(
            id(o) for o in self.operators
        ):
            return False
        produced: Set[str] = set()
        for op in schedule:
            for i in op.inputs:
                if i in self._producer and i not in produced:
                    return False
            produced.add(op.output)
        return True

    def default_schedule(self) -> List[Operator]:
        """The order operators were added in (must already be topological —
        mirrors the schedule embedded in a serialized model)."""
        if not self.is_valid_schedule(self.operators):
            raise ValueError("insertion order is not topological")
        return list(self.operators)

    # ----------------------------------------------------------- memory model
    def live_sets(self, schedule: Sequence[Operator],
                  include_constants: bool = True) -> List[FrozenSet[str]]:
        """Working set at each step of ``schedule``.

        At step t (executing op), live = op.inputs ∪ {op.output} ∪ tensors
        already produced that a *later* op (or a graph output) still needs.
        Constants are included when ``include_constants`` (the paper counts
        them; Figure-1 accounting includes the network input tensor while it
        has pending consumers).
        """
        n = len(schedule)
        # Last step at which each tensor is used as an input; graph outputs
        # are pinned to the end.
        last_use: Dict[str, int] = {}
        for t, op in enumerate(schedule):
            for i in op.inputs:
                last_use[i] = t
        for o in self.outputs:
            last_use[o] = n  # never freed
        sets: List[FrozenSet[str]] = []
        produced: Set[str] = set()
        for t, op in enumerate(schedule):
            live: Set[str] = set()
            for i in op.inputs:
                if include_constants or i in self._producer:
                    live.add(i)
            # paper §6 extension: an accumulating operator (attrs
            # inplace=True, e.g. elementwise add) whose input dies here and
            # matches the output size can write INTO that input — the output
            # needs no separate buffer at this step.  When only one input is
            # genuinely writable (e.g. dynamic_update_slice's operand), the
            # op names it via attrs["inplace_input"].
            inplace_ok = op.attrs.get("inplace") and any(
                last_use.get(i, -1) == t
                and self.size(i) == self.size(op.output)
                and i in self._producer
                for i in inplace_candidates(op))
            if not inplace_ok:
                live.add(op.output)
            for p in produced:
                if last_use.get(p, -1) > t:
                    live.add(p)
            if include_constants:
                # Constants with uses strictly after this step stay resident.
                for c in self.constants():
                    if last_use.get(c, -1) > t:
                        live.add(c)
            produced.add(op.output)
            sets.append(frozenset(live))
        return sets

    def usage_profile(self, schedule: Sequence[Operator],
                      include_constants: bool = True) -> List[int]:
        return [sum(self.size(t) for t in s)
                for s in self.live_sets(schedule, include_constants)]

    def peak_usage(self, schedule: Sequence[Operator],
                   include_constants: bool = True) -> int:
        prof = self.usage_profile(schedule, include_constants)
        return max(prof) if prof else 0

    # ------------------------------------------------------------------ misc
    def __repr__(self) -> str:
        return (f"Graph(tensors={len(self.tensors)}, ops={len(self.operators)}, "
                f"outputs={self.outputs})")


def linear_chains(graph: Graph) -> List[List[Operator]]:
    """Maximal chains of operators where each link is the sole consumer of its
    predecessor's output and has exactly one non-constant input.  Inside such a
    chain the execution order is forced, so schedulers may contract each chain
    into a single super-operator (see heuristics.contract_chains)."""
    chains: List[List[Operator]] = []
    visited: Set[str] = set()

    def sole_activation_input(op: Operator) -> Optional[str]:
        acts = [i for i in op.inputs if graph.producer(i) is not None]
        return acts[0] if len(acts) == 1 else None

    for op in graph.operators:
        if op.name in visited:
            continue
        # Is `op` a chain head?  Its activation input (if any) must not chain
        # into it (predecessor has >1 consumer, or op has !=1 activation input).
        a = sole_activation_input(op)
        prev = graph.producer(a) if a is not None else None
        if prev is not None and len(graph.consumers(prev.output)) == 1 \
                and prev.output not in graph.outputs:
            continue  # not a head; will be visited as part of prev's chain
        chain = [op]
        visited.add(op.name)
        cur = op
        while True:
            cons = graph.consumers(cur.output)
            if len(cons) != 1 or cur.output in graph.outputs:
                break
            nxt = cons[0]
            if sole_activation_input(nxt) != cur.output or nxt.name in visited:
                break
            chain.append(nxt)
            visited.add(nxt.name)
            cur = nxt
        chains.append(chain)
    return chains
