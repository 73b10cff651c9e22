"""Partial execution (Pex-style) graph transform.

The paper (Liberis & Lane 2019) reorders whole operators; its sequel — *Pex:
Memory-efficient Microcontroller Deep Learning through Partial Execution*
(Liberis & Lane 2022) — goes further: an operator chain is split into K
spatial slices so that only a fraction of its interior tensors is ever live.
This module implements that transform over the reordering ``Graph`` IR:

* **Eligibility** is declared per-operator through a ``SliceSpec`` attached in
  ``Operator.attrs`` (see ``graphs/cnn_ops.py`` for the CNN classification:
  elementwise ops, depthwise/regular convolutions and spatial pooling are
  sliceable; global pooling, FC and concat are not).  A spec carries the
  row-map of the op — kernel/stride under TF-style SAME padding — which is
  everything needed to push an output row range back to the input rows it
  reads (including the halo that neighbouring slices recompute).

* **Segments** are contiguous runs of sliceable operators inside the maximal
  linear chains of the graph.  Splitting a single operator cannot save
  memory (its input and output buffers must coexist regardless); splitting a
  chain means the fat *interior* tensors only ever exist one slice at a time.

* **The rewrite** replaces a segment with, per slice ``s``:
  ``pex_slice`` extract operators (halo-aware row windows of the segment's
  external inputs), per-slice clones of the member operators (explicit
  padding replaces SAME so numerics are bit-identical), and an incremental
  ``pex_concat`` that writes the slice into the full output buffer.  The
  concat chain is marked ``inplace`` — each link dies as the next is written
  — so the memory model (``Graph.live_sets``), the arena planner and the
  micro-interpreter all charge the output buffer exactly once.  This mirrors
  Pex's "operators write into a shared buffer" execution.

* **The cost model** (``plan_partition``) picks per-segment boundaries and K
  to hit a target arena budget, subject to a cap on the extra MACs spent
  recomputing halo rows — the Pex latency/memory trade-off.

The transform never changes results: a partitioned graph evaluates
bit-identically to the original (property-tested through the
micro-interpreter).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, Operator, linear_chains

# Attribute key under which builders attach a SliceSpec to eligible ops.
PEX_ATTR = "pex_slice_spec"


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """Row-map of a spatially-sliceable operator (TF SAME padding semantics).

    ``kernel``/``stride`` describe how output rows map to input rows along
    the leading (height) axis.  ``sliced_inputs`` lists the input positions
    that follow the row map (``None`` = all of them — elementwise); inputs
    not listed are consumed whole by every slice.  ``make_fn(op, pad_top,
    pad_bottom)`` builds the executable for a clone whose input slice needs
    explicit edge padding; ``None`` leaves clones without semantics
    (scheduling-only graphs).  ``macs_per_row`` feeds the halo-recompute
    overhead model.

    ``kernel_w``/``stride_w`` describe the same window map along the second
    (width) axis for 2-D tiled streaming; ``None`` means square — the
    height values apply.  A 2-D-capable ``make_fn`` additionally accepts
    ``(pad_left, pad_right)``; 1-D callers never pass them, so legacy
    two-argument factories keep working unchanged.
    """

    kernel: int = 1
    stride: int = 1
    sliced_inputs: Optional[Tuple[int, ...]] = None
    make_fn: Optional[Callable[[Operator, int, int], Callable[..., Any]]] = None
    macs_per_row: int = 0
    kernel_w: Optional[int] = None
    stride_w: Optional[int] = None

    @property
    def kw(self) -> int:
        return self.kernel if self.kernel_w is None else self.kernel_w

    @property
    def sw(self) -> int:
        return self.stride if self.stride_w is None else self.stride_w


def spec_of(op: Operator) -> Optional[SliceSpec]:
    return op.attrs.get(PEX_ATTR)


# ------------------------------------------------------------------ row maps
def same_pads(h_in: int, kernel: int, stride: int) -> Tuple[int, int, int]:
    """(out_rows, pad_begin, pad_end) of TF-style SAME padding."""
    out = -(-h_in // stride)
    total = max((out - 1) * stride + kernel - h_in, 0)
    return out, total // 2, total - total // 2


def in_rows(kernel: int, stride: int, h_in: int, oa: int, ob: int
            ) -> Tuple[int, int, int, int]:
    """Input rows [lo, hi) and explicit pads (top, bottom) needed to produce
    output rows [oa, ob) of a SAME-padded windowed op."""
    _, pad_beg, _ = same_pads(h_in, kernel, stride)
    lo = oa * stride - pad_beg
    hi = (ob - 1) * stride - pad_beg + kernel
    top, bottom = max(0, -lo), max(0, hi - h_in)
    return max(lo, 0), min(hi, h_in), top, bottom


def _height(graph: Graph, tensor: str) -> Optional[int]:
    t = graph.tensors[tensor]
    if not t.shape:
        return None
    h = int(t.shape[0])
    if h < 1 or t.size % h != 0:
        return None
    return h


def _width(graph: Graph, tensor: str) -> Optional[int]:
    """Spatial width (second axis) of a tensor, or ``None`` when the shape
    has no width axis — 1-D tensors stream by rows only."""
    t = graph.tensors[tensor]
    if len(t.shape) < 2:
        return None
    h, w = int(t.shape[0]), int(t.shape[1])
    if w < 1 or h < 1 or t.size % (h * w) != 0:
        return None
    return w


def _win_row_bytes(graph: Graph, tensor: str, cols: Tuple[int, int]) -> int:
    """Bytes of ONE row narrowed to the column window [clo, chi): row bytes
    scale linearly in retained columns (rows are column-major contiguous in
    the byte model, so the division is exact)."""
    w = _width(graph, tensor)
    assert w is not None
    clo, chi = cols
    return _row_bytes(graph, tensor) * (chi - clo) // w


def _chain_input_index(op: Operator, pred_output: str) -> int:
    return op.inputs.index(pred_output)


def _op_eligible(graph: Graph, op: Operator) -> bool:
    spec = spec_of(op)
    if spec is None:
        return False
    h_out = _height(graph, op.output)
    if h_out is None or h_out < 2:
        return False
    sliced = (spec.sliced_inputs if spec.sliced_inputs is not None
              else tuple(range(len(op.inputs))))
    if not sliced:
        return False
    if spec.kernel > 1 or spec.stride > 1:
        # windowed ops: exactly one halo'd input whose SAME output height
        # matches the recorded output height
        if len(sliced) != 1:
            return False
        h_in = _height(graph, op.inputs[sliced[0]])
        if h_in is None or same_pads(h_in, spec.kernel, spec.stride)[0] != h_out:
            return False
    else:
        # elementwise family: every sliced input must share the output height
        for idx in sliced:
            if idx >= len(op.inputs) or _height(graph, op.inputs[idx]) != h_out:
                return False
    return True


def _sliced_indices(op: Operator) -> Tuple[int, ...]:
    spec = spec_of(op)
    assert spec is not None
    return (spec.sliced_inputs if spec.sliced_inputs is not None
            else tuple(range(len(op.inputs))))


def _skips_sliced(op: Operator, cur: Sequence[Operator]) -> bool:
    """Whether every input ``op`` reads from the run so far enters through
    a sliced position (for a linear chain: its predecessor's output)."""
    if spec_of(op) is None:
        return False
    made = {m.output for m in cur}
    return all(idx in _sliced_indices(op)
               for idx, t in enumerate(op.inputs) if t in made)


def _residual_chains(graph: Graph) -> List[List[Operator]]:
    """The maximal linear chains with every residual diamond merged in: where
    a chain's last output ``t`` has exactly two consumers, one heading a
    chain whose last output only the other reads, and that other (the join,
    e.g. an add) reads ``t`` too, the branch chain and the chain the join
    heads are appended.  In the merged chain every op still reads its
    predecessor's output; the join also reads ``t``, a *skip* from an
    earlier member."""
    chains = linear_chains(graph)
    by_head = {c[0].name: c for c in chains}
    used: set = set()
    merged: List[List[Operator]] = []
    for chain in chains:
        if chain[0].name in used:
            continue
        run = list(chain)
        used.update(op.name for op in run)
        while True:
            t = run[-1].output
            cons = graph.consumers(t)
            if len(cons) != 2 or t in graph.outputs:
                break
            found = None
            for a, b in ((cons[0], cons[1]), (cons[1], cons[0])):
                branch, after = by_head.get(a.name), by_head.get(b.name)
                if (branch is None or after is None or t not in b.inputs
                        or branch[-1].output not in b.inputs
                        or graph.consumers(branch[-1].output) != [b]
                        or any(op.name in used for op in branch + after)):
                    continue
                found = branch + after
                break
            if found is None:
                break
            run += found
            used.update(op.name for op in found)
        merged.append(run)
    return merged


def run_skips(run: Sequence[Operator]) -> List[Tuple[int, int, int]]:
    """(producer position, consumer position, input index) of every input
    a member of ``run`` reads from a member other than its predecessor: the
    skips of the residual diamonds ``sliceable_runs(skips=True)`` merged."""
    pos = {op.output: p for p, op in enumerate(run)}
    out = []
    for j, op in enumerate(run):
        for idx, t in enumerate(op.inputs):
            p = pos.get(t)
            if p is not None and p != j - 1:
                out.append((p, j, idx))
    return out


def sliceable_runs(graph: Graph, skips: bool = False
                   ) -> List[List[Operator]]:
    """Contiguous runs (length >= 2) of sliceable ops within the maximal
    linear chains of the graph, where every chain link enters its consumer
    through a sliced input position.  ``skips`` merges residual diamonds
    into the chains first (``_residual_chains``): a run may then hold a
    join that also reads an earlier member's output, through a sliced
    position (``run_skips``)."""
    runs: List[List[Operator]] = []
    chains = _residual_chains(graph) if skips else linear_chains(graph)
    for chain in chains:
        cur: List[Operator] = []
        for op in chain:
            links = (not cur or
                     _chain_input_index(op, cur[-1].output) in
                     (_sliced_indices(op) if spec_of(op) else ())
                     and _skips_sliced(op, cur))
            if _op_eligible(graph, op) and links:
                cur.append(op)
            else:
                if len(cur) >= 2:
                    runs.append(cur)
                cur = [op] if _op_eligible(graph, op) else []
        if len(cur) >= 2:
            runs.append(cur)
    return runs


# --------------------------------------------------------------- slice plans
@dataclasses.dataclass
class _SlicePlan:
    # per op name: output row range (oa, ob)
    out: Dict[str, Tuple[int, int]]
    # per op name: per input index -> (lo, hi, pad_top, pad_bottom) for
    # sliced inputs, None for whole inputs
    ins: Dict[str, List[Optional[Tuple[int, int, int, int]]]]


def slice_plans(graph: Graph, ops: Sequence[Operator], k: int
                ) -> List[_SlicePlan]:
    """Back-propagate output row ranges of the K slices through the segment.
    Slice ``s`` of the final output covers rows [s*H//K, (s+1)*H//K)."""
    h_final = _height(graph, ops[-1].output)
    assert h_final is not None and 2 <= k <= h_final
    bounds = [(s * h_final) // k for s in range(k + 1)]
    return [_backprop_segment(graph, ops, bounds[s], bounds[s + 1])
            for s in range(k)]


# ----------------------------------------------------------------- cost model
@dataclasses.dataclass
class Segment:
    ops: List[Operator]
    k: int
    est_peak: int            # local estimate: externals + output + slice live
    extra_macs_frac: float   # halo recompute cost relative to segment MACs
    extra_macs: int = 0      # absolute halo-recompute MACs (whole-graph units)


def _row_bytes(graph: Graph, tensor: str) -> int:
    h = _height(graph, tensor)
    assert h is not None
    return graph.size(tensor) // h


def _macs_per_row(graph: Graph, op: Operator) -> int:
    spec = spec_of(op)
    if spec is not None and spec.macs_per_row > 0:
        return spec.macs_per_row
    return max(1, _row_bytes(graph, op.output))


def _external_inputs(ops: Sequence[Operator]) -> List[str]:
    internal = {op.output for op in ops}
    exts: List[str] = []
    for op in ops:
        for i in op.inputs:
            if i not in internal and i not in exts:
                exts.append(i)
    return exts


# ----------------------------------------------------------- MACs accounting
# Canonical home of the latency cost model's units (the joint solver and the
# brute-force oracle import these via core/solver.py): absolute MACs so
# numbers from different rewrites — single segments, multi-segment Pex,
# cascades — are commensurable, and whole-graph totals so every reported
# ``extra_macs_frac`` means "fraction of the model's inference MACs".
def op_macs(graph: Graph, op: Operator) -> int:
    """Estimated MACs of one operator: ``rows * macs_per_row`` when the op
    has a spatial height (the Pex cost model's unit), otherwise the output
    bytes as a proxy."""
    h = _height(graph, op.output)
    if h is None:
        return max(1, graph.size(op.output))
    return h * _macs_per_row(graph, op)


def graph_macs(graph: Graph) -> int:
    """Estimated MACs of the whole (unpartitioned) graph."""
    return sum(op_macs(graph, op) for op in graph.operators)


def segment_extra_macs(graph: Graph, ops: Sequence[Operator], k: int) -> int:
    """Absolute halo-recompute MACs of splitting ``ops`` into K slices:
    rows computed beyond each op's height, priced at its per-row MACs."""
    rows_done: Dict[str, int] = {}
    for plan in slice_plans(graph, ops, k):
        for op in ops:
            oa, ob = plan.out[op.name]
            rows_done[op.name] = rows_done.get(op.name, 0) + (ob - oa)
    extra = 0
    for op in ops:
        h = _height(graph, op.output)
        assert h is not None
        extra += max(0, rows_done[op.name] - h) * _macs_per_row(graph, op)
    return extra


def estimate_segment(graph: Graph, ops: Sequence[Operator], k: int
                     ) -> Tuple[int, float]:
    """(estimated peak bytes while the partitioned segment runs, halo
    overhead as a fraction of the segment's MACs).

    The estimate charges: every external input whole (slices are extracted
    from it, so it lives until the last slice), the full output buffer (the
    inplace concat accumulator), and the fattest per-slice step
    (inputs + output of one clone).  Co-live tensors from elsewhere in the
    graph are not the segment's to know — callers verify the true peak by
    scheduling the rewritten graph.
    """
    plans = slice_plans(graph, ops, k)
    ext_bytes = sum(graph.size(e) for e in _external_inputs(ops))
    out_bytes = graph.size(ops[-1].output)
    slice_live = 0
    base_macs = extra_macs = 0
    rows_done: Dict[str, int] = {}
    for op in ops:
        base_macs += _height(graph, op.output) * _macs_per_row(graph, op)
    for plan in plans:
        for d, op in enumerate(ops):
            oa, ob = plan.out[op.name]
            step = (ob - oa) * _row_bytes(graph, op.output)
            for idx, rp in enumerate(plan.ins[op.name]):
                if rp is not None:
                    lo, hi, _, _ = rp
                    step += (hi - lo) * _row_bytes(graph, op.inputs[idx])
            slice_live = max(slice_live, step)
            rows_done[op.name] = rows_done.get(op.name, 0) + (ob - oa)
    for op in ops:
        extra = rows_done[op.name] - _height(graph, op.output)
        extra_macs += max(0, extra) * _macs_per_row(graph, op)
    frac = extra_macs / base_macs if base_macs else 0.0
    return ext_bytes + out_bytes + slice_live, frac


def _local_baseline(graph: Graph, ops: Sequence[Operator]) -> int:
    """Unpartitioned local peak proxy: fattest single step of the run."""
    return max(graph.size(op.output) + sum(graph.size(i) for i in op.inputs)
               for op in ops)


def _choose_in_run(graph: Graph, run: List[Operator],
                   budget: Optional[int], max_k: int, overhead_cap: float,
                   k_choices: Sequence[int]) -> List[Segment]:
    """Best (sub-segment, K) of a sliceable run, then recurse on what is left
    to the segment's sides (a long chain may need several segments)."""
    if len(run) < 2:
        return []
    best: Optional[Tuple[Tuple, int, int, int, float]] = None
    baseline = _local_baseline(graph, run)
    for i in range(len(run)):
        for j in range(i + 1, len(run)):
            ops = run[i:j + 1]
            h_final = _height(graph, ops[-1].output)
            floor = (sum(graph.size(e) for e in _external_inputs(ops))
                     + graph.size(ops[-1].output))
            if floor >= baseline and (budget is None or floor >= budget):
                continue            # cannot beat the unsplit run
            for k in k_choices:
                if k > min(max_k, h_final):
                    continue
                est, frac = estimate_segment(graph, ops, k)
                if frac > overhead_cap or est >= baseline:
                    continue
                meets = budget is not None and est <= budget
                # rank: meeting the budget first, then lowest estimated
                # peak, then cheapest halo recompute, then smallest K
                key = (0 if meets else 1, est, frac, k)
                if best is None or key < best[0]:
                    best = (key, i, j, k, frac)
    if best is None:
        return []
    _, i, j, k, frac = best
    ops = run[i:j + 1]
    est, frac = estimate_segment(graph, ops, k)
    segs = [Segment(list(ops), k, est, frac,
                    segment_extra_macs(graph, ops, k))]
    segs += _choose_in_run(graph, run[:i], budget, max_k, overhead_cap,
                           k_choices)
    segs += _choose_in_run(graph, run[j + 1:], budget, max_k, overhead_cap,
                           k_choices)
    return segs


def plan_partition(graph: Graph, budget: Optional[int] = None,
                   max_k: int = 16, overhead_cap: float = 0.5,
                   k_choices: Sequence[int] = (2, 3, 4, 6, 8, 12, 16)
                   ) -> List[Segment]:
    segs: List[Segment] = []
    for run in sliceable_runs(graph):
        segs.extend(_choose_in_run(graph, run, budget, max_k, overhead_cap,
                                   k_choices))
    return segs


# -------------------------------------------------------------------- rewrite
def _slice_fn(lo: int, hi: int, clo: Optional[int] = None,
              chi: Optional[int] = None) -> Callable[..., Any]:
    if clo is None:
        def fn(a, lo=lo, hi=hi):
            return np.asarray(a)[lo:hi]
    else:
        def fn(a, lo=lo, hi=hi, clo=clo, chi=chi):
            return np.asarray(a)[lo:hi, clo:chi]
    return fn


def _concat_fn(start: int, shape: Tuple[int, ...], first: bool,
               cstart: Optional[int] = None) -> Callable[..., Any]:
    if first:
        def fn(part, start=start, shape=shape, cstart=cstart):
            part = np.asarray(part)
            acc = np.zeros(shape, part.dtype)
            if cstart is None:
                acc[start:start + part.shape[0]] = part
            else:
                acc[start:start + part.shape[0],
                    cstart:cstart + part.shape[1]] = part
            return acc
    else:
        def fn(acc, part, start=start, cstart=cstart):
            part = np.asarray(part)
            out = np.array(acc)        # the simulator copies; on-device this
            if cstart is None:         # writes in place
                out[start:start + part.shape[0]] = part
            else:
                out[start:start + part.shape[0],
                    cstart:cstart + part.shape[1]] = part
            return out
    return fn


def _emit_segment(old: Graph, new: Graph, seg: Segment) -> None:
    ops, k = seg.ops, seg.k
    head = ops[0].name
    y = ops[-1].output
    ty = old.tensors[y]
    executable = all(op.fn is not None for op in ops) and all(
        spec_of(op).make_fn is not None for op in ops)  # type: ignore[union-attr]
    plans = slice_plans(old, ops, k)
    bounds = [plan.out[ops[-1].name] for plan in plans]
    extracts: Dict[Tuple[str, int, int], str] = {}
    acc_prev: Optional[str] = None

    # Every emitted op carries structured metadata (segment head, slice
    # index, row windows) so backends that cannot call the numpy closures —
    # the compiled arena executor lowers pex_slice/pex_concat to
    # lax.dynamic_slice/dynamic_update_slice and rolls uniform slices into a
    # fori_loop — can reconstruct the computation from attrs alone.
    def extract(inp: str, lo: int, hi: int, s: int) -> str:
        key = (inp, lo, hi)
        if key not in extracts:
            t_in = old.tensors[inp]
            tname = f"{inp}__pex_{head}_{lo}_{hi}"
            shape = (hi - lo,) + tuple(t_in.shape[1:]) if t_in.shape else ()
            new.add_tensor(tname, (hi - lo) * _row_bytes(old, inp), shape,
                           t_in.dtype)
            new.add_operator(f"pexsl__{head}_{len(extracts)}", [inp], tname,
                             kind="pex_slice",
                             fn=_slice_fn(lo, hi) if executable else None,
                             pex_seg=head, pex_slice_idx=s, pex_rows=(lo, hi))
            extracts[key] = tname
        return extracts[key]

    for s in range(k):
        plan = plans[s]
        for d, op in enumerate(ops):
            spec = spec_of(op)
            assert spec is not None
            oa, ob = plan.out[op.name]
            pads = (0, 0)
            ins: List[str] = []
            for idx, inp in enumerate(op.inputs):
                rp = plan.ins[op.name][idx]
                if rp is None:
                    ins.append(inp)               # consumed whole
                    continue
                lo, hi, top, bottom = rp
                if top or bottom:
                    pads = (top, bottom)
                if d > 0 and inp == ops[d - 1].output:
                    ins.append(f"{inp}__pex{s}")
                else:
                    ins.append(extract(inp, lo, hi, s))
            t_out = old.tensors[op.output]
            oname = f"{op.output}__pex{s}"
            shape = ((ob - oa,) + tuple(t_out.shape[1:])
                     if t_out.shape else ())
            new.add_tensor(oname, (ob - oa) * _row_bytes(old, op.output),
                           shape, t_out.dtype)
            attrs = {a: v for a, v in op.attrs.items() if a != PEX_ATTR}
            attrs["pex_of"] = op.name
            attrs["pex_seg"] = head
            attrs["pex_slice_idx"] = s
            attrs["pex_pads"] = pads
            fn = (spec.make_fn(op, pads[0], pads[1])
                  if executable else None)   # type: ignore[misc]
            new.add_operator(f"{op.name}__pex{s}", ins, oname, kind=op.kind,
                             fn=fn, **attrs)
        # incremental concat: write this slice into the shared output buffer
        part = f"{y}__pex{s}"
        start = bounds[s][0]
        out_name = y if s == k - 1 else f"{y}__pexacc{s}"
        if s < k - 1:
            new.add_tensor(out_name, ty.size, ty.shape, ty.dtype)
        if s == 0:
            new.add_operator(f"pexcat__{head}_0", [part], out_name,
                             kind="pex_concat",
                             fn=(_concat_fn(start, tuple(ty.shape), True)
                                 if executable else None),
                             pex_seg=head, pex_slice_idx=s, pex_start=start,
                             pex_first=True)
        else:
            new.add_operator(f"pexcat__{head}_{s}", [acc_prev, part],
                             out_name, kind="pex_concat",
                             fn=(_concat_fn(start, tuple(ty.shape), False)
                                 if executable else None),
                             inplace=True, inplace_input=acc_prev,
                             pex_seg=head, pex_slice_idx=s, pex_start=start,
                             pex_first=False)
        acc_prev = out_name


@dataclasses.dataclass
class PartitionResult:
    graph: Graph
    segments: List[Segment]
    total_macs: int = 0      # graph_macs of the ORIGINAL (unsplit) graph

    @property
    def n_slices(self) -> int:
        return sum(s.k for s in self.segments)

    @property
    def extra_macs(self) -> int:
        """Absolute halo-recompute MACs over all segments (disjoint ops)."""
        return sum(s.extra_macs for s in self.segments)

    @property
    def extra_macs_frac(self) -> float:
        """Halo recompute overhead as a fraction of the whole graph's MACs
        (the model-wide latency price — same units as the joint solver's
        front axis)."""
        return self.extra_macs / self.total_macs if self.total_macs else 0.0

    def __str__(self) -> str:
        return (f"pex: {len(self.segments)} segments, "
                f"{self.n_slices} slices, halo overhead "
                f"{self.extra_macs_frac:.1%} of graph MACs")


def apply_partition(graph: Graph, segments: Sequence[Segment]) -> Graph:
    """Rewrite ``graph`` with every segment split into its K slices.  The
    rewritten graph's insertion order is the Pex execution order (slice 0's
    chain, its concat, slice 1's chain, ...), so ``default_schedule`` of the
    result is already partial-execution-shaped; schedulers may still improve
    on it."""
    heads = {seg.ops[0].name: seg for seg in segments}
    member = {op.name for seg in segments for op in seg.ops}
    interior = {op.output for seg in segments for op in seg.ops[:-1]}
    new = Graph()
    for name, t in graph.tensors.items():
        if name not in interior:
            new.add_tensor(name, t.size, t.shape, t.dtype)
    for op in graph.operators:
        if op.name in heads:
            _emit_segment(graph, new, heads[op.name])
        elif op.name in member:
            continue
        else:
            new.add_operator(op.name, list(op.inputs), op.output,
                             kind=op.kind, fn=op.fn, **op.attrs)
    new.set_outputs(graph.outputs)
    return new


def partition_graph(graph: Graph, budget: Optional[int] = None,
                    max_k: int = 16, overhead_cap: float = 0.5,
                    k_choices: Sequence[int] = (2, 3, 4, 6, 8, 12, 16)
                    ) -> PartitionResult:
    """One-stop transform: plan segments/K against ``budget`` (None = just
    minimise the estimated peak) and rewrite the graph.  Returns the input
    graph unchanged (``result.graph is graph``) when nothing is eligible."""
    segments = plan_partition(graph, budget, max_k, overhead_cap, k_choices)
    if not segments:
        return PartitionResult(graph, [], graph_macs(graph))
    return PartitionResult(apply_partition(graph, segments), segments,
                           graph_macs(graph))


# ======================================================= cascaded streaming
# Whole-externals partial execution (above) charges every segment's external
# input whole and materialises its output whole — a ~280 KB floor under
# MobileNet-1.0@192 int8 (108 KB input + accumulator + slice live).  Full
# Pex (Liberis & Lane 2022) and MCUNetV2's patch-based inference break that
# floor by *cascading*: adjacent segments execute interleaved, slice by
# slice, and the tensor between two cascaded segments never exists whole.
# Only a rolling window of its most recent rows is kept — a **ring buffer**
# sized by the consumer's receptive field (kernel + stride carry from the
# SAME-padding row map):
#
#   input ──seg0──▶ [ring: R0 rows] ──seg1──▶ [ring: R1 rows] ──seg2──▶ out
#
# Per final-output slice s, each segment i produces only the *delta* rows
# its consumer newly needs (rows already in the ring are retained, not
# recomputed — cascades also cut halo recompute vs whole-externals), pushes
# them into the ring at position ``row % R`` (``pex_ring_push``, an inplace
# rolling write — the SSA chain of ring states aliases to ONE buffer via the
# existing inplace accounting), and the consumer reads its halo'd window
# back out as a contiguous tensor (``pex_ring_read``).  The cost model
# charges an inter-segment tensor ``ring_rows * row_bytes`` instead of its
# full size; externals of the first segment and the cascade's final output
# are still charged whole.


@dataclasses.dataclass
class Cascade:
    """A planned cascade: consecutive sub-segments of one sliceable run,
    ring row counts for the boundaries between them, and the slice count K
    of the final output that drives the interleaved execution."""

    segments: List[List[Operator]]
    k: int
    ring_rows: List[int]          # per boundary i (= output of segments[i])
    est_peak: int
    extra_macs_frac: float        # relative to the cascade's own MACs
    min_rows: int = 1             # per-iteration chunk floor (see plans)
    rate_div: int = 1             # pipeline slowdown factor (see plans)
    extra_macs: int = 0           # absolute halo MACs (whole-graph units)
    strips: int = 1               # W-strips: 1 = row rings, >1 = 2-D tiles

    @property
    def ops(self) -> List[Operator]:
        return [op for seg in self.segments for op in seg]


@dataclasses.dataclass
class _CascadeSlice:
    """Row bookkeeping of one final-output slice across the cascade."""

    deltas: List[Tuple[int, int]]               # per segment: new out rows
    plans: List[Optional[_SlicePlan]]           # per segment (None = empty)
    reads: List[Optional[Tuple[int, int]]]      # per segment i>0: ring window


def _backprop_segment(graph: Graph, ops: Sequence[Operator],
                      d_lo: int, d_hi: int) -> _SlicePlan:
    """Back-propagate an output row range through one segment's ops (the
    per-slice step of ``slice_plans``, reused per cascade delta).  A member
    whose output several members read (a residual skip) computes the union
    of their windows; in a linear chain that is its consumer's window."""
    out: Dict[str, Tuple[int, int]] = {}
    ins: Dict[str, List[Optional[Tuple[int, int, int, int]]]] = {}
    made = {op.output for op in ops}
    need: Dict[str, Tuple[int, int]] = {ops[-1].output: (d_lo, d_hi)}
    for d in range(len(ops) - 1, -1, -1):
        op = ops[d]
        spec = spec_of(op)
        assert spec is not None
        a, b = need[op.output]
        out[op.name] = (a, b)
        sliced = _sliced_indices(op)
        row_plan: List[Optional[Tuple[int, int, int, int]]] = []
        for idx, inp in enumerate(op.inputs):
            if idx not in sliced:
                row_plan.append(None)
                continue
            h_in = _height(graph, inp)
            assert h_in is not None
            rp = in_rows(spec.kernel, spec.stride, h_in, a, b)
            row_plan.append(rp)
            if inp in made:
                lo, hi = rp[0], rp[1]
                if inp in need:
                    lo, hi = min(lo, need[inp][0]), max(hi, need[inp][1])
                need[inp] = (lo, hi)
        ins[op.name] = row_plan
    return _SlicePlan(out, ins)


def _seg_need_hi(graph: Graph, ops: Sequence[Operator], ob: int,
                 boundary: Optional[str] = None) -> int:
    """Highest input row (exclusive) of the segment's chain input needed to
    produce output rows [*, ob) — the hi of the row-map composition; with
    ``boundary`` (the chain input's name), over every member that reads
    it, a residual skip included."""
    if boundary is not None and (run_skips(ops) or sum(
            boundary in op.inputs for op in ops) > 1):
        plan = _backprop_segment(graph, ops, ob - 1, ob)
        return max(rp[1] for op in ops
                   for t, rp in zip(op.inputs, plan.ins[op.name])
                   if t == boundary and rp is not None)
    b = ob
    for op in reversed(ops):
        spec = spec_of(op)
        assert spec is not None
        if spec.kernel == 1 and spec.stride == 1:
            continue                    # elementwise: hi passes through
        h_in = _height(graph, op.inputs[_sliced_indices(op)[0]])
        assert h_in is not None
        _, pad_beg, _ = same_pads(h_in, spec.kernel, spec.stride)
        b = min((b - 1) * spec.stride - pad_beg + spec.kernel, h_in)
    return b


def _backprop_cols(graph: Graph, members: Sequence[Operator],
                   ca: int, cb: int
                   ) -> Tuple[Dict[str, Tuple[int, int]],
                              Dict[str, List[Optional[Tuple[int, int,
                                                            int, int]]]]]:
    """Column twin of ``_backprop_segment`` over the whole member chain:
    compose the width-axis window maps backward from final-output columns
    [ca, cb).  Column windows are constant across row slices (the row and
    column maps are independent under SAME padding), so one pass per
    W-strip covers every iteration of the cascade.

    Returns (per-op output column window, per-op per-input column window
    ``(lo, hi, pad_left, pad_right)`` — ``None`` for whole inputs)."""
    out: Dict[str, Tuple[int, int]] = {}
    ins: Dict[str, List[Optional[Tuple[int, int, int, int]]]] = {}
    a, b = ca, cb
    for d in range(len(members) - 1, -1, -1):
        op = members[d]
        spec = spec_of(op)
        assert spec is not None
        out[op.name] = (a, b)
        sliced = _sliced_indices(op)
        col_plan: List[Optional[Tuple[int, int, int, int]]] = []
        for idx, inp in enumerate(op.inputs):
            if idx not in sliced:
                col_plan.append(None)
                continue
            w_in = _width(graph, inp)
            assert w_in is not None
            col_plan.append(in_rows(spec.kw, spec.sw, w_in, a, b))
        ins[op.name] = col_plan
        if d > 0:
            ci = _chain_input_index(op, members[d - 1].output)
            lo, hi, _, _ = col_plan[ci]  # type: ignore[misc]
            a, b = lo, hi
    return out, ins


def _strips_eligible(graph: Graph, members: Sequence[Operator],
                     strips: int) -> bool:
    """Whether the member chain supports ``strips`` W-strips: every tensor
    on the chain has a width axis, every windowed member's SAME width map
    is consistent (mirror of the height checks in ``_op_eligible``), and
    the final output is wide enough to split."""
    if strips < 2:
        return True
    w_final = _width(graph, members[-1].output)
    if w_final is None or w_final < strips:
        return False
    for op in members:
        spec = spec_of(op)
        assert spec is not None
        w_out = _width(graph, op.output)
        if w_out is None:
            return False
        sliced = _sliced_indices(op)
        if spec.kw > 1 or spec.sw > 1:
            if len(sliced) != 1:
                return False
            w_in = _width(graph, op.inputs[sliced[0]])
            if w_in is None or same_pads(w_in, spec.kw, spec.sw)[0] != w_out:
                return False
        else:
            for idx in sliced:
                if (idx >= len(op.inputs)
                        or _width(graph, op.inputs[idx]) != w_out):
                    return False
    return True


def _strip_bounds(w_final: int, strips: int) -> List[Tuple[int, int]]:
    """Final-output column ranges of the W-strips (same balanced split rule
    as the row-slice bounds in ``slice_plans``)."""
    bounds = [(j * w_final) // strips for j in range(strips + 1)]
    return [(bounds[j], bounds[j + 1]) for j in range(strips)]


def cascade_slice_plans(graph: Graph, segments: Sequence[List[Operator]],
                        k: int, min_rows: int = 1, rate_div: int = 1
                        ) -> Tuple[List[_CascadeSlice], List[int]]:
    """Forward streaming schedule of a cascade, plus the ring size (rows)
    of every boundary.

    Each iteration advances every segment (first to last) by at most its
    steady-state chunk — ``ceil(h_final / k)`` rows of the final output,
    scaled upstream by the consumer segments' stride product, floored at
    ``min_rows`` (deep low-resolution segments are cheap per row, so a
    bigger chunk there buys halo-recompute savings at almost no memory
    cost) — never past what its producer has already pushed into the
    ring, and never past what its consumer's next chunk demands (a
    backward demand pass per iteration; eager production would sit in the
    ring as pure lag).  Capping the
    chunk is what breaks the warm-up: the receptive field of the first
    output rows ramps up over several small iterations instead of being
    materialised in one fat step, so neither the rings nor the per-step
    working set ever hold a whole warm-up window.  The last segment
    finishes at the final iteration; early iterations may leave it (and
    any downstream segment) with an empty delta while upstream primes.

    A boundary's ring must hold, after iteration t, every row from the
    oldest one a future read still needs to the newest one pushed —
    ``ring_rows = max_t (pushed_hi - oldest_needed)``; rows are placed at
    ``row % ring_rows``, so a row is overwritten exactly when the ring has
    advanced a full revolution past it, by which time (monotone windows)
    no reader wants it."""
    m = len(segments)
    heights: List[int] = []
    for seg in segments:
        h = _height(graph, seg[-1].output)
        assert h is not None
        heights.append(h)
    h_final = heights[-1]
    assert 2 <= k <= h_final
    caps = list(_cascade_caps(graph, segments, k, min_rows, rate_div))
    prev = [0] * m                      # rows produced so far, per segment
    slices: List[_CascadeSlice] = []
    guard = m + 4 + sum(-(-heights[i] // caps[i]) for i in range(m))
    while prev[-1] < h_final and len(slices) < guard:
        # demand pass (backward): a producer must never run ahead of what
        # its consumer's next chunk will read — eager production would sit
        # in the ring as pure lag and inflate ring_rows past the
        # kernel+stride-carry window the cost model is built around
        demand = [0] * m
        demand[m - 1] = min(h_final, prev[m - 1] + caps[m - 1])
        for i in range(m - 2, -1, -1):
            demand[i] = min(heights[i],
                            max(prev[i],
                                _seg_need_hi(graph, segments[i + 1],
                                             demand[i + 1],
                                             segments[i][-1].output)))
        deltas: List[Tuple[int, int]] = [(0, 0)] * m
        plans: List[Optional[_SlicePlan]] = [None] * m
        reads: List[Optional[Tuple[int, int]]] = [None] * m
        for i in range(m):
            d_lo = prev[i]
            ob = min(d_lo + caps[i], demand[i])
            if i > 0:
                # never read past what the producer has pushed so far
                while ob > d_lo and _seg_need_hi(
                        graph, segments[i], ob,
                        segments[i - 1][-1].output) > prev[i - 1]:
                    ob -= 1
            if ob <= d_lo:
                deltas[i] = (d_lo, d_lo)
                continue
            deltas[i] = (d_lo, ob)
            plan = _backprop_segment(graph, segments[i], d_lo, ob)
            plans[i] = plan
            if i > 0:
                # the boundary's windows: the first member's, and a
                # residual skip's where a later member reads it too
                boundary = segments[i - 1][-1].output
                wins = [rp for op in segments[i]
                        for t, rp in zip(op.inputs, plan.ins[op.name])
                        if t == boundary and rp is not None]
                reads[i] = (min(w[0] for w in wins), max(w[1] for w in wins))
            prev[i] = ob
        slices.append(_CascadeSlice(deltas, plans, reads))
    assert prev[-1] == h_final, "cascade streaming failed to make progress"

    # ring sizing: occupancy after iteration t = pushed_hi - oldest row any
    # read at t' >= t still needs (window lows are monotone)
    ring_need = [0] * (m - 1)
    n = len(slices)
    for i in range(m - 1):
        hi_after = []
        h = 0
        for cs in slices:
            h = max(h, cs.deltas[i][1])
            hi_after.append(h)
        lo_next: List[Optional[int]] = [None] * n
        nxt: Optional[int] = None
        for t in range(n - 1, -1, -1):
            r = slices[t].reads[i + 1]
            if r is not None:
                nxt = r[0]
            lo_next[t] = nxt
        for t in range(n):
            if lo_next[t] is not None:
                ring_need[i] = max(ring_need[i],
                                   hi_after[t] - min(lo_next[t],
                                                     hi_after[t]))
    return slices, ring_need


def estimate_cascade(graph: Graph, segments: Sequence[List[Operator]],
                     k: int, min_rows: int = 1, rate_div: int = 1,
                     strips: int = 1) -> Tuple[int, float, List[int], int]:
    """(estimated peak bytes, halo-recompute MACs as a fraction of the
    cascade's own MACs — the planner's overhead-cap unit, ring rows,
    absolute halo-recompute MACs — the whole-graph reporting unit).

    Charges: every cascade-external input whole, each boundary at
    ``ring_rows * row_bytes`` (the streaming saving), the final output
    whole (the inplace concat accumulator), and the fattest per-slice
    step.  Boundary rows are produced exactly once — recompute happens
    only *inside* segments, so cascades also shrink the extra-MACs cost.

    With ``strips > 1`` the cascade runs once per W-strip: rings and
    working slices narrow to each strip's column windows (``tile_rows ×
    tile_cols × C`` working sets), the strips execute sequentially so the
    peak takes the max over strips, and the column halos show up as extra
    per-element work — MACs scale by retained-columns / full-width, which
    reduces exactly to the 1-D formula at ``strips == 1``."""
    slices, rings = cascade_slice_plans(graph, segments, k, min_rows,
                                        rate_div)
    members = [op for seg in segments for op in seg]
    ext_bytes = sum(graph.size(e) for e in _external_inputs(members))
    out_bytes = graph.size(segments[-1][-1].output)
    if strips == 1:
        ring_bytes = sum(r * _row_bytes(graph, seg[-1].output)
                         for r, seg in zip(rings, segments[:-1]))
        slice_live = 0
        rows_done: Dict[str, int] = {}
        for cs in slices:
            for i, seg in enumerate(segments):
                plan = cs.plans[i]
                if plan is None:
                    continue
                for op in seg:
                    oa, ob = plan.out[op.name]
                    step = (ob - oa) * _row_bytes(graph, op.output)
                    for idx, rp in enumerate(plan.ins[op.name]):
                        if rp is None:
                            continue
                        # boundary inputs: the ring itself is charged whole
                        # in ring_bytes; the read materialises the halo'd
                        # window once, same cost shape as an external
                        # extract
                        lo, hi, _, _ = rp
                        step += (hi - lo) * _row_bytes(graph, op.inputs[idx])
                    slice_live = max(slice_live, step)
                    rows_done[op.name] = rows_done.get(op.name, 0) + (ob - oa)
        base_macs = extra_macs = 0
        for op in members:
            h = _height(graph, op.output)
            assert h is not None
            base_macs += h * _macs_per_row(graph, op)
            extra = rows_done.get(op.name, 0) - h
            extra_macs += max(0, extra) * _macs_per_row(graph, op)
        frac = extra_macs / base_macs if base_macs else 0.0
        return (ext_bytes + ring_bytes + out_bytes + slice_live, frac, rings,
                extra_macs)

    assert _strips_eligible(graph, members, strips)
    w_final = _width(graph, members[-1].output)
    assert w_final is not None
    strip_peak = 0
    work: Dict[str, int] = {}        # per op: row-equivalents done (x W)
    for ca, cb in _strip_bounds(w_final, strips):
        cols_out, cols_ins = _backprop_cols(graph, members, ca, cb)
        ring_bytes = sum(
            r * _win_row_bytes(graph, seg[-1].output,
                               cols_out[seg[-1].name][:2])
            for r, seg in zip(rings, segments[:-1]))
        slice_live = 0
        for cs in slices:
            for i, seg in enumerate(segments):
                plan = cs.plans[i]
                if plan is None:
                    continue
                for op in seg:
                    oa, ob = plan.out[op.name]
                    oc = cols_out[op.name]
                    step = (ob - oa) * _win_row_bytes(graph, op.output,
                                                      oc[:2])
                    for idx, rp in enumerate(plan.ins[op.name]):
                        if rp is None:
                            continue
                        lo, hi, _, _ = rp
                        cc = cols_ins[op.name][idx]
                        assert cc is not None
                        step += (hi - lo) * _win_row_bytes(
                            graph, op.inputs[idx], cc[:2])
                    slice_live = max(slice_live, step)
                    w_op = _width(graph, op.output)
                    assert w_op is not None
                    # rows x retained columns, in per-full-row units x W
                    work[op.name] = (work.get(op.name, 0)
                                     + (ob - oa) * (oc[1] - oc[0]))
        strip_peak = max(strip_peak, ring_bytes + slice_live)
    base_macs = extra_macs = 0
    for op in members:
        h = _height(graph, op.output)
        w_op = _width(graph, op.output)
        assert h is not None and w_op is not None
        mpr = _macs_per_row(graph, op)
        base_macs += h * mpr
        extra_macs += max(0, work.get(op.name, 0) * mpr // w_op - h * mpr)
    frac = extra_macs / base_macs if base_macs else 0.0
    return (ext_bytes + out_bytes + strip_peak, frac, rings, extra_macs)


# the most cuts a cascade through residual diamonds is searched with, and
# the most cut sets a run of diamonds is searched over: past it (MobileNetV2's
# runs of eight diamonds at 32x32 hold ~35 000, a search of hours) the run is
# not cascaded, and the planner's notes say so (``plan_cascade``)
SKIP_CUTS = 4
SKIP_CUT_SETS = 4096


def _closed(graph: Graph, ops: Sequence[Operator]) -> bool:
    """Whether every member output but the last is read by members only
    (a cascade drops its interior tensors: a skip must not leave it)."""
    names = {op.name for op in ops}
    return all(c.name in names for op in ops[:-1]
               for c in graph.consumers(op.output)) \
        and not any(op.output in graph.outputs for op in ops[:-1])


def _skips_streamable(skips: Sequence[Tuple[int, int, int]],
                      cuts: Sequence[int], end: int) -> bool:
    """Whether each skip ``(producer, join, _)`` of a run lies within the
    cascade cut at ``cuts`` and ending at ``end`` so that the join can read
    it: both in one segment, or the producer last in its segment and the
    join in the next one (the boundary's ring)."""
    bounds = sorted(cuts)

    def seg(p: int) -> int:
        return sum(c <= p for c in bounds)
    for p, j, _ in skips:
        if j >= end:
            if p < end:
                return False
            continue
        sp, sj = seg(p), seg(j)
        if sj != sp and not (sj == sp + 1 and p + 1 in bounds):
            return False
    return True


def _cut_candidates(graph: Graph, run: Sequence[Operator]) -> List[int]:
    """Positions p where ``run[:p]`` / ``run[p:]`` is a sensible boundary:
    after every op that shrinks the spatial height (stride > 1) — the
    boundary tensor is smallest right after a stride level."""
    cuts = []
    h_prev = _height(graph, run[0].inputs[_sliced_indices(run[0])[0]])
    for p, op in enumerate(run):
        h = _height(graph, op.output)
        if h is not None and h_prev is not None and h < h_prev \
                and 0 < p + 1 < len(run):
            cuts.append(p + 1)
        h_prev = h
    return cuts


def _cascade_caps(graph: Graph, segments: Sequence[List[Operator]],
                  k: int, min_rows: int, rate_div: int) -> Tuple[int, ...]:
    """The effective per-segment chunk caps a (k, min_rows, rate_div)
    triple resolves to: the stride-steady rate (``ceil(h_final/k)`` final
    rows, scaled upstream by consumer stride products) divided by
    ``rate_div`` (a slower pipeline: smaller chunks, smaller rings and
    working set, more iterations), floored at ``min_rows`` (deep
    low-resolution segments are cheap per row, so bigger chunks there cut
    halo recompute at almost no memory cost).  Single source of truth —
    ``cascade_slice_plans`` paces with these caps and the planner
    deduplicates estimate candidates on them (distinct triples often
    collapse to the same caps)."""
    heights = [_height(graph, seg[-1].output) for seg in segments]
    steady = [0] * len(segments)
    steady[-1] = -(-heights[-1] // k)       # type: ignore[operator]
    for i in range(len(segments) - 2, -1, -1):
        stride_prod = 1
        for op in segments[i + 1]:
            stride_prod *= spec_of(op).stride   # type: ignore[union-attr]
        steady[i] = max(1, steady[i + 1] * stride_prod)
    return tuple(min(h, max(-(-c // rate_div), min_rows))  # type: ignore
                 for c, h in zip(steady, heights))


def _end_height(graph: Graph, ops: Sequence[Operator]) -> Optional[int]:
    """The final height of a cascade over ``ops``, or None where no
    cascade may end after them: fewer than two ops or rows, or an interior
    output read outside them (``_closed``)."""
    h = _height(graph, ops[-1].output)
    if h is None or h < 2 or len(ops) < 2 or not _closed(graph, ops):
        return None
    return h


# one end of a run's search: (end, final height, cut sets, W-strip counts)
_EndSearch = Tuple[int, int, List[Tuple[int, ...]], List[int]]


def _linear_search(graph: Graph, run: Sequence[Operator],
                   cuts_all: Sequence[int],
                   strips_choices: Sequence[int]) -> List[_EndSearch]:
    """The ends and cut sets a linear run is searched over: ends at its
    stride-level candidates and its last op, every subset of the
    candidates before the end, and suffixes of two structural families
    (``plan_cascade``)."""
    import itertools

    windowed = tuple(
        p for p in range(1, len(run))
        if (spec_of(run[p]).kernel > 1          # type: ignore[union-attr]
            or spec_of(run[p]).stride > 1))     # type: ignore[union-attr]
    singles = tuple(range(1, len(run)))
    out: List[_EndSearch] = []
    for end in sorted(set(cuts_all) | {len(run)}):
        ops_e = run[:end]
        h_final = _end_height(graph, ops_e)
        if h_final is None:
            continue
        strips_e = [st for st in strips_choices
                    if st == 1 or _strips_eligible(graph, ops_e, st)]
        ends_cuts = [c for c in cuts_all if c < end]
        if not ends_cuts:
            continue
        cut_sets = [cuts for r in range(1, len(ends_cuts) + 1)
                    for cuts in itertools.combinations(ends_cuts, r)]
        for fam in (windowed, singles,
                    tuple(sorted(set(windowed) | set(ends_cuts)))):
            fam_e = tuple(c for c in fam if c < end)
            for j in range(min(4, len(fam_e))):
                suffix = fam_e[j:]
                if suffix and suffix not in cut_sets:
                    cut_sets.append(suffix)
        out.append((end, h_final, cut_sets, strips_e))
    return out


def _residual_search(graph: Graph, run: Sequence[Operator],
                     skips: Sequence[Tuple[int, int, int]],
                     strips_choices: Sequence[int]
                     ) -> Tuple[List[_EndSearch], int]:
    """The ends and cut sets a run with residual skips is searched over,
    row rings only, and how many cut sets that is.  Its joins sit between
    the stride levels, so every end whose interior stays inside the run
    and every cut set of up to ``SKIP_CUTS`` cuts that keeps the skips
    streamable (``_skips_streamable``; a cut set does exactly when each of
    its cuts alone does) is searched.  Over ``SKIP_CUT_SETS`` cut sets the
    search is left empty."""
    import itertools

    ends = [e for e in range(2, len(run) + 1) if _closed(graph, run[:e])]
    allowed = {e: [c for c in range(1, e)
                   if _skips_streamable(skips, (c,), e)] for e in ends}
    count = sum(math.comb(len(a), r) for a in allowed.values()
                for r in range(1, SKIP_CUTS + 1))
    if count > SKIP_CUT_SETS:
        return [], count
    strips = [st for st in strips_choices if st == 1]
    out: List[_EndSearch] = []
    for end in ends:
        h_final = _end_height(graph, run[:end])
        cuts = allowed[end]
        if h_final is None or not cuts:
            continue
        out.append((end, h_final,
                    [c for r in range(1, min(len(cuts), SKIP_CUTS) + 1)
                     for c in itertools.combinations(cuts, r)], strips))
    return out, count


def _best_cascade(graph: Graph, run: Sequence[Operator],
                  search: Sequence[_EndSearch], budget: Optional[int],
                  max_k: int, overhead_cap: float,
                  k_choices: Sequence[int],
                  min_rows_choices: Sequence[int],
                  rate_div_choices: Sequence[int]) -> Optional[Cascade]:
    """The best cascade of ``run`` over ``search``'s ends and cut sets and
    every (K, chunk floor, rate divisor, W-strip count): meeting the budget
    first, then estimated peak, halo overhead, K.  An early end's estimate
    is floored by its tail's fattest single step."""
    best: Optional[Tuple] = None
    for end, h_final, cut_sets, strips_e in search:
        tail_floor = (_local_baseline(graph, run[end:])
                      if end < len(run) else 0)
        for cuts in cut_sets:
            segs = []
            lo = 0
            for c in list(cuts) + [end]:
                segs.append(list(run[lo:c]))
                lo = c
            seen_caps: set = set()
            for k in k_choices:
                if k > min(max_k, h_final) or k < 2:
                    continue
                for mr in min_rows_choices:
                    for rd in rate_div_choices:
                        caps = _cascade_caps(graph, segs, k, mr, rd)
                        for st in strips_e:
                            if (caps, st) in seen_caps:
                                continue
                            seen_caps.add((caps, st))
                            est, frac, rings, extra = estimate_cascade(
                                graph, segs, k, mr, rd, st)
                            if frac > overhead_cap:
                                continue
                            est = max(est, tail_floor)
                            meets = budget is not None and est <= budget
                            key = (0 if meets else 1, est, frac, k,
                                   mr, rd, st)
                            if best is None or key < best[0]:
                                best = (key, segs, k, est, frac, rings,
                                        mr, rd, extra, st)
    if best is None:
        return None
    _, segs, k, est, frac, rings, mr, rd, extra, st = best
    return Cascade(segs, k, rings, est, frac, mr, rd, extra, st)


def plan_cascade(graph: Graph, budget: Optional[int] = None,
                 max_k: int = 16, overhead_cap: float = 0.25,
                 k_choices: Sequence[int] = (2, 3, 4, 6, 8, 12, 16),
                 max_cuts: int = 8,
                 min_rows_choices: Sequence[int] = (1, 2, 4),
                 rate_div_choices: Sequence[int] = (1, 2, 4),
                 strips_choices: Sequence[int] = (1,),
                 skips: bool = False,
                 notes: Optional[List[str]] = None
                 ) -> List[Cascade]:
    """Choose, per sliceable run, the best (end, cut set, K, chunk floor,
    rate divisor, W-strip count) — ranked like ``_choose_in_run``: meeting
    the budget first, then estimated peak, halo overhead, K.

    ``strips_choices`` widens the search to 2-D tiled cascades: the whole
    cascade re-runs once per W-strip with rings and working sets narrowed
    to per-strip column windows (the MCUNetV2-style patch regime).  The
    default ``(1,)`` searches only row cascades and is byte-identical to
    the pre-2-D planner — the scheduler ladder escalates to strips > 1
    only when row rings alone miss the budget.

    The cascade may **end early** — at the boundary right after a stride
    level, where the feature map is small — leaving the run's tail to
    conventional scheduling: driving slices from the network's final
    low-resolution output would make slice 0's receptive field global and
    the rings as tall as the tensors they replace.  An early end's
    estimate is floored by the tail's fattest single step, so an end that
    merely shifts the peak into the tail cannot rank as a win.

    Cut sets searched: every subset of the stride-level candidates, plus
    suffixes of two structural families — a boundary right before every
    windowed op (each [windowed, 1x1...] block becomes a segment whose
    1x1 tail recomputes nothing) and all-singletons (every interior tensor
    retained in a kernel-sized ring: zero recompute, maximum rings).
    Suffixes merge the first ops into one head segment, which reads the
    (whole, already-charged) external input — recompute there trades
    against rings that would sit next to the fattest feature maps.  Only
    cascades with at least two segments qualify — a single segment is
    whole-externals Pex.

    ``skips`` plans the runs with residual diamonds merged in
    (``sliceable_runs(skips=True)``).  A run that holds a skip is searched
    by ``_residual_search``: the skip stays inside the cascade, its
    producer and its join in one segment (the producer's window is the
    union of both readers'), or the producer last in its segment and the
    join in the next (both read the boundary's ring).  A run whose search
    is over ``SKIP_CUT_SETS`` is not cascaded, and a line saying so is
    appended to ``notes`` where one is given."""
    cascades: List[Cascade] = []
    for run in sliceable_runs(graph, skips):
        if len(run) < 3:
            continue
        cuts_all = _cut_candidates(graph, run)[:max_cuts]
        if not cuts_all:
            continue
        sk = run_skips(run)
        if sk:
            search, count = _residual_search(graph, run, sk, strips_choices)
            if count > SKIP_CUT_SETS and notes is not None:
                notes.append(
                    f"cascade: the run of {len(run)} operators from "
                    f"{run[0].name} through {len(sk)} residual skips holds "
                    f"{count} cut sets, over SKIP_CUT_SETS = "
                    f"{SKIP_CUT_SETS}: not searched")
        else:
            search = _linear_search(graph, run, cuts_all, strips_choices)
        best = _best_cascade(graph, run, search, budget, max_k,
                             overhead_cap, k_choices, min_rows_choices,
                             rate_div_choices)
        if best is not None:
            cascades.append(best)
    return cascades


# ----------------------------------------------------------- ring rewriting
def _ring_read_fn(lo: int, n: int, ring_rows: int) -> Callable[..., Any]:
    def fn(ring, lo=lo, n=n, ring_rows=ring_rows):
        ring = np.asarray(ring)
        return ring[(lo + np.arange(n)) % ring_rows]
    return fn


def _ring_push_fn(dst: int, ring_rows: int, first: bool) -> Callable[..., Any]:
    if first:
        def fn(part, dst=dst, ring_rows=ring_rows):
            part = np.asarray(part)
            ring = np.zeros((ring_rows,) + part.shape[1:], part.dtype)
            ring[(dst + np.arange(part.shape[0])) % ring_rows] = part
            return ring
    else:
        def fn(ring, part, dst=dst, ring_rows=ring_rows):
            out = np.array(np.asarray(ring))   # simulator copies; on-device
            part = np.asarray(part)            # this is a rolling in-place
            out[(dst + np.arange(part.shape[0])) % ring_rows] = part
            return out
    return fn


def _sub_rows(old: Graph, new: Graph, part: str, tensor: str,
              have: Tuple[int, int], want: Tuple[int, int], name: str,
              seg_tag: str, phase: int, executable: bool) -> str:
    """Rows ``want`` of ``tensor`` out of ``part``, the rows ``have`` of it
    an iteration made: a ``pex_slice`` with rows relative to ``part``."""
    lo, hi = want[0] - have[0], want[1] - have[0]
    assert 0 <= lo < hi <= have[1] - have[0], (have, want)
    t = old.tensors[tensor]
    tname = f"{part}__{name}"
    new.add_tensor(tname, (hi - lo) * _row_bytes(old, tensor),
                   (hi - lo,) + tuple(t.shape[1:]), t.dtype)
    new.add_operator(name, [part], tname, kind="pex_slice",
                     fn=_slice_fn(lo, hi) if executable else None,
                     pex_seg=seg_tag, pex_slice_idx=phase, pex_rows=(lo, hi))
    return tname


def _emit_cascade(old: Graph, new: Graph, casc: Cascade) -> None:
    segments, k, strips = casc.segments, casc.k, casc.strips
    m = len(segments)
    head = segments[0][0].name
    y = segments[-1][-1].output
    ty = old.tensors[y]
    members = casc.ops
    executable = all(op.fn is not None for op in members) and all(
        spec_of(op).make_fn is not None for op in members)  # type: ignore[union-attr]
    slices, _ = cascade_slice_plans(old, segments, k, casc.min_rows,
                                    casc.rate_div)

    # W-strips: one (cstart, column-window maps) triple per outer pass.
    # strips == 1 keeps cols == None everywhere, emitting byte-identical
    # names / attrs / sizes to the pre-2-D emitter (the degenerate path).
    if strips == 1:
        strip_iter: List[Tuple[Optional[int], Any, Any]] = [(None, None,
                                                             None)]
    else:
        w_final = _width(old, y)
        assert w_final is not None
        strip_iter = []
        for ca, cb in _strip_bounds(w_final, strips):
            cols_out, cols_ins = _backprop_cols(old, members, ca, cb)
            strip_iter.append((ca, cols_out, cols_ins))

    extracts: Dict[Tuple, str] = {}

    # Dedup is scoped PER STRIP (the key carries the strip tag): a window
    # shared across strips would stay live through the whole first strip —
    # co-resident with its rings and working set — which the cost model
    # never charges (``estimate_cascade`` prices windows only inside their
    # own strip).  Re-extracting per strip costs a copy and keeps the
    # estimate an upper bound.  strips == 1 has one tag, so the degenerate
    # path deduplicates (and names) exactly as the pre-2-D emitter.
    def extract(inp: str, lo: int, hi: int, phase: int,
                cols: Optional[Tuple[int, int]], seg_tag: str,
                sx: str) -> str:
        key = (inp, lo, hi, cols, sx)
        if key not in extracts:
            t_in = old.tensors[inp]
            attrs: Dict[str, Any] = {}
            if cols is None:
                tname = f"{inp}__cpex_{head}{sx}_{lo}_{hi}" if sx \
                    else f"{inp}__cpex_{head}_{lo}_{hi}"
                size = (hi - lo) * _row_bytes(old, inp)
                shape = ((hi - lo,) + tuple(t_in.shape[1:])
                         if t_in.shape else ())
                fn = _slice_fn(lo, hi) if executable else None
            else:
                clo, chi = cols
                tname = f"{inp}__cpex_{head}{sx}_{lo}_{hi}_{clo}_{chi}"
                size = (hi - lo) * _win_row_bytes(old, inp, cols)
                shape = (hi - lo, chi - clo) + tuple(t_in.shape[2:])
                fn = _slice_fn(lo, hi, clo, chi) if executable else None
                attrs["pex_cols"] = (clo, chi)
            new.add_tensor(tname, size, shape, t_in.dtype)
            new.add_operator(f"cpexsl__{head}_{len(extracts)}", [inp], tname,
                             kind="pex_slice", fn=fn,
                             pex_seg=seg_tag, pex_slice_idx=phase,
                             pex_rows=(lo, hi), **attrs)
            extracts[key] = tname
        return extracts[key]

    acc_prev: Optional[str] = None
    for j, (cstart, cols_out, cols_ins) in enumerate(strip_iter):
        sx = "" if strips == 1 else f"c{j}"
        seg_tag = head if strips == 1 else f"{head}@c{j}"
        ring_cur: List[Optional[str]] = [None] * (m - 1)
        for s, cs in enumerate(slices):
            # group index for the compiled executor's fori_loop rolling:
            # with a rate divisor the steady-state structure repeats every
            # rate_div iterations, so the super-period is one rollable group
            phase = s // casc.rate_div
            for i, seg in enumerate(segments):
                d_lo, d_hi = cs.deltas[i]
                if d_hi <= d_lo:
                    continue
                plan = cs.plans[i]
                assert plan is not None
                made = {m.output: m for m in seg}
                for d, op in enumerate(seg):
                    spec = spec_of(op)
                    assert spec is not None
                    oa, ob = plan.out[op.name]
                    oc = None if cols_out is None else cols_out[op.name]
                    pads = (0, 0)
                    wpads = (0, 0)
                    ins: List[str] = []
                    for idx, inp in enumerate(op.inputs):
                        rp = plan.ins[op.name][idx]
                        if rp is None:
                            ins.append(inp)            # consumed whole
                            continue
                        cc = (None if cols_ins is None
                              else cols_ins[op.name][idx])
                        lo, hi, top, bottom = rp
                        if top or bottom:
                            pads = (top, bottom)
                        if cc is not None and (cc[2] or cc[3]):
                            wpads = (cc[2], cc[3])
                        if inp in made:
                            # a member's rows of this iteration: all of them
                            # for its successor; a residual skip's join
                            # reads the part of the union it needs
                            part_in = f"{inp}__cpex{s}{sx}"
                            have = plan.out[made[inp].name]
                            if have != (lo, hi):
                                assert cc is None, "skips stream by rows"
                                part_in = _sub_rows(
                                    old, new, part_in, inp, have, (lo, hi),
                                    f"cpexss__{head}_{i}_{s}{sx}_{d}_{idx}",
                                    seg_tag, phase, executable)
                            ins.append(part_in)
                        elif (i > 0 and inp == segments[i - 1][-1].output):
                            # halo'd window out of the predecessor's ring (a
                            # second read where a residual skip's join in
                            # this segment reads the boundary too)
                            ring = ring_cur[i - 1]
                            assert ring is not None
                            ring_rows = casc.ring_rows[i - 1]
                            t_b = old.tensors[inp]
                            at = "" if d == 0 else f"_{d}"
                            rname = f"{inp}__rw{s}{sx}{at}"
                            if cc is None:
                                rbytes = (hi - lo) * _row_bytes(old, inp)
                                shape = ((hi - lo,) + tuple(t_b.shape[1:])
                                         if t_b.shape else ())
                            else:
                                rbytes = (hi - lo) * _win_row_bytes(
                                    old, inp, cc[:2])
                                shape = ((hi - lo, cc[1] - cc[0])
                                         + tuple(t_b.shape[2:]))
                            new.add_tensor(rname, rbytes, shape, t_b.dtype)
                            new.add_operator(
                                f"cpexrd__{head}_{i}_{s}{sx}{at}", [ring],
                                rname,
                                kind="pex_ring_read",
                                fn=(_ring_read_fn(lo, hi - lo, ring_rows)
                                    if executable else None),
                                pex_seg=seg_tag, pex_slice_idx=phase,
                                pex_ring_rows=ring_rows, pex_ring_src=lo)
                            ins.append(rname)
                        else:
                            ins.append(extract(inp, lo, hi, phase,
                                               None if cc is None
                                               else cc[:2], seg_tag, sx))
                    t_out = old.tensors[op.output]
                    oname = f"{op.output}__cpex{s}{sx}"
                    if oc is None:
                        obytes = (ob - oa) * _row_bytes(old, op.output)
                        shape = ((ob - oa,) + tuple(t_out.shape[1:])
                                 if t_out.shape else ())
                    else:
                        obytes = (ob - oa) * _win_row_bytes(old, op.output,
                                                            oc)
                        shape = ((ob - oa, oc[1] - oc[0])
                                 + tuple(t_out.shape[2:]))
                    new.add_tensor(oname, obytes, shape, t_out.dtype)
                    attrs = {a: v for a, v in op.attrs.items()
                             if a != PEX_ATTR}
                    attrs["pex_of"] = op.name
                    attrs["pex_seg"] = seg_tag
                    attrs["pex_slice_idx"] = phase
                    attrs["pex_pads"] = pads
                    if oc is None:
                        fn = (spec.make_fn(op, pads[0], pads[1])
                              if executable else None)  # type: ignore[misc]
                    else:
                        attrs["pex_wpads"] = wpads
                        fn = (spec.make_fn(op, pads[0], pads[1],  # type: ignore[call-arg]
                                           wpads[0], wpads[1])
                              if executable else None)  # type: ignore[misc]
                    new.add_operator(f"{op.name}__cpex{s}{sx}", ins, oname,
                                     kind=op.kind, fn=fn, **attrs)
                part = f"{seg[-1].output}__cpex{s}{sx}"
                if i < m - 1:
                    # rolling push of the delta rows into the boundary ring
                    boundary = seg[-1].output
                    bc = (None if cols_out is None
                          else cols_out[seg[-1].name])
                    ring_rows = casc.ring_rows[i]
                    t_b = old.tensors[boundary]
                    ring_name = f"{boundary}__ring{s}{sx}"
                    if bc is None:
                        rbytes = ring_rows * _row_bytes(old, boundary)
                        shape = ((ring_rows,) + tuple(t_b.shape[1:])
                                 if t_b.shape else ())
                    else:
                        rbytes = ring_rows * _win_row_bytes(old, boundary,
                                                            bc)
                        shape = ((ring_rows, bc[1] - bc[0])
                                 + tuple(t_b.shape[2:]))
                    new.add_tensor(ring_name, rbytes, shape, t_b.dtype)
                    first = ring_cur[i] is None
                    if first:
                        new.add_operator(
                            f"cpexpu__{head}_{i}_{s}{sx}", [part], ring_name,
                            kind="pex_ring_push",
                            fn=(_ring_push_fn(d_lo, ring_rows, True)
                                if executable else None),
                            pex_seg=seg_tag, pex_slice_idx=phase,
                            pex_ring_rows=ring_rows, pex_ring_dst=d_lo,
                            pex_first=True)
                    else:
                        new.add_operator(
                            f"cpexpu__{head}_{i}_{s}{sx}", [ring_cur[i],
                                                            part],
                            ring_name, kind="pex_ring_push",
                            fn=(_ring_push_fn(d_lo, ring_rows, False)
                                if executable else None),
                            inplace=True, inplace_input=ring_cur[i],
                            pex_seg=seg_tag, pex_slice_idx=phase,
                            pex_ring_rows=ring_rows, pex_ring_dst=d_lo,
                            pex_first=False)
                    ring_cur[i] = ring_name
                else:
                    start = d_lo
                    # the accumulator spans strips: only the very last
                    # delta of the very last strip completes the output
                    last = (s == len(slices) - 1
                            and j == len(strip_iter) - 1)
                    out_name = y if last else f"{y}__cpexacc{s}{sx}"
                    if not last:
                        new.add_tensor(out_name, ty.size, ty.shape,
                                       ty.dtype)
                    cat_attrs: Dict[str, Any] = {}
                    if cstart is not None:
                        cat_attrs["pex_cstart"] = cstart
                    if acc_prev is None:
                        new.add_operator(f"cpexcat__{head}_{s}{sx}", [part],
                                         out_name, kind="pex_concat",
                                         fn=(_concat_fn(start,
                                                        tuple(ty.shape),
                                                        True, cstart)
                                             if executable else None),
                                         pex_seg=seg_tag,
                                         pex_slice_idx=phase,
                                         pex_start=start, pex_first=True,
                                         **cat_attrs)
                    else:
                        new.add_operator(f"cpexcat__{head}_{s}{sx}",
                                         [acc_prev, part], out_name,
                                         kind="pex_concat",
                                         fn=(_concat_fn(start,
                                                        tuple(ty.shape),
                                                        False, cstart)
                                             if executable else None),
                                         inplace=True,
                                         inplace_input=acc_prev,
                                         pex_seg=seg_tag,
                                         pex_slice_idx=phase,
                                         pex_start=start, pex_first=False,
                                         **cat_attrs)
                    acc_prev = out_name


@dataclasses.dataclass
class CascadeResult:
    graph: Graph
    cascades: List[Cascade]
    total_macs: int = 0      # graph_macs of the ORIGINAL graph
    # runs the planner left unsearched, one line each (``plan_cascade``)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def extra_macs(self) -> int:
        """Absolute halo-recompute MACs over all cascades (disjoint ops)."""
        return sum(c.extra_macs for c in self.cascades)

    @property
    def extra_macs_frac(self) -> float:
        """Halo recompute overhead as a fraction of the whole graph's MACs
        (same whole-graph units as ``PartitionResult`` and the solver)."""
        return self.extra_macs / self.total_macs if self.total_macs else 0.0

    def __str__(self) -> str:
        return (f"cascade: {len(self.cascades)} cascades, "
                f"{sum(len(c.segments) for c in self.cascades)} segments, "
                f"halo overhead {self.extra_macs_frac:.1%} of graph MACs")


def apply_cascade(graph: Graph, cascades: Sequence[Cascade]) -> Graph:
    """Rewrite ``graph`` with every cascade streamed through ring buffers.
    Insertion order is the interleaved cascade execution order (slice 0
    through every segment, slice 1 through every segment, ...), so
    ``default_schedule`` of the result is already streaming-shaped."""
    heads = {c.segments[0][0].name: c for c in cascades}
    member = {op.name for c in cascades for op in c.ops}
    interior = {op.output for c in cascades for op in c.ops
                if op.output != c.segments[-1][-1].output}
    new = Graph()
    for name, t in graph.tensors.items():
        if name not in interior:
            new.add_tensor(name, t.size, t.shape, t.dtype)
    for op in graph.operators:
        if op.name in heads:
            _emit_cascade(graph, new, heads[op.name])
        elif op.name in member:
            continue
        else:
            new.add_operator(op.name, list(op.inputs), op.output,
                             kind=op.kind, fn=op.fn, **op.attrs)
    new.set_outputs(graph.outputs)
    return new


def cascade_graph(graph: Graph, budget: Optional[int] = None,
                  max_k: int = 16, overhead_cap: float = 0.25,
                  k_choices: Sequence[int] = (2, 3, 4, 6, 8, 12, 16),
                  strips_choices: Sequence[int] = (1,),
                  rf_redistribute: Optional[Tuple[str, str]] = None,
                  skips: bool = False) -> CascadeResult:
    """One-stop cascaded-streaming transform: plan cut sets / K against
    ``budget`` and rewrite the graph.  Returns the input graph unchanged
    (``result.graph is graph``) when no run can cascade.

    ``rf_redistribute`` is the MCUNetV2-style planner option: an explicit
    ``(shrink_op, grow_op)`` pair handed to
    ``graphs.cnn_ops.redistribute_receptive_field`` before planning —
    kernel reach moves from the early (halo-expensive) op to a later one,
    so 2-D tiling's per-axis halo bill shrinks while total network reach
    is conserved.  The shrink leg is a flagged model edit (see the
    transform's docstring), which is why it is opt-in per op pair and
    never chosen silently by the planner.  ``skips`` streams residual
    diamonds too (``plan_cascade``), and the result's ``notes`` name the
    runs whose search was over its cap."""
    if rf_redistribute is not None:
        from repro_torch.graphs.cnn_ops import redistribute_receptive_field
        graph = redistribute_receptive_field(graph, *rf_redistribute)
    notes: List[str] = []
    cascades = plan_cascade(graph, budget, max_k, overhead_cap, k_choices,
                            strips_choices=strips_choices, skips=skips,
                            notes=notes)
    if not cascades:
        return CascadeResult(graph, [], graph_macs(graph), notes)
    return CascadeResult(apply_cascade(graph, cascades), cascades,
                         graph_macs(graph), notes)
