"""Compiled arena executor on PyTorch: a scheduled graph and its arena plan
run as one straight sequence of operator calls over ONE uint8 byte arena.

The paper's offline artefacts — a schedule (the operator order) and an
``ArenaPlan`` (a byte offset per tensor) — fully determine the runtime.
``compile_schedule`` turns them into a program over a single device
buffer, the byte-addressed SRAM arena of TFLite-Micro:

* the arena is one ``torch.uint8`` tensor of ``[lanes, plan.arena_size]``
  bytes on the device (one lane per request; a one-shot ``run`` has one).
  Lanes are ``pitch`` bytes apart, where ``pitch`` is ``arena_size``
  rounded up to the graph's widest itemsize so that typed views stay
  views; on an int8 graph ``pitch == arena_size``;
* each tensor is a ``Tensor.view(dtype)`` of its ``Placement`` bytes
  (``[lanes, *shape]``; f32 tensors view 4 bytes per element, int8
  tensors 1).  The plan's disjointness invariant plus its alignment policy
  (offsets aligned to the itemsize, checked here) make this sound;
* each operator runs its lowering rule (registered per ``kind`` next to
  the semantics, ``graphs/cnn_ops.py``) and its output is written in place
  at its offset — the int8 conv kernels write straight into the arena
  view.  Inplace chains (``pex_concat``, ``pex_ring_push``) alias to one
  offset, so their read-modify-write at that offset is the shared buffer;
* ``pex_slice``/``pex_concat``/``pex_ring_push``/``pex_ring_read`` are
  lowered from the structured attrs the partition rewrite records; their
  ``op.fn`` (the partition simulator's numpy closures) is never called;
* a kind without a rule falls back to its ``op.fn``, as the reference's
  does: the fn runs once per lane on that lane's unbatched ``[*shape]``
  views (what the reference's ``vmap`` hands it), and each lane's result
  is copied into that lane's output view.  A kind with neither a rule nor
  an ``fn`` is refused when the program is compiled;
* ``pex_ring_read`` windows with a single integer-exact consumer are
  **zero-copy**: never written to the arena (``_zero_copy_reads``), the
  window is handed to the consumer as a ``RingWindow`` view of the ring,
  which K2 and K3 read in place on the card;
* runs of uniform Pex slices are grouped into rolled loops exactly as the
  reference groups them (``_plan_items``/``_build_loop``), so
  ``rolled_loops``/``rolled_ops`` match it.  In the reference, rolling is
  a code-size device of the XLA program; here a rolled loop is a Python
  loop over its iterations with offsets as Python ints, and has no speed
  meaning.

``execute`` is the eager program, the counterpart of the reference's
``raw_fn``: one Python call per operator, and what the CPU runs.  ``fn``
and ``batched_fn(lanes)`` are its compiled forms, the reference's
``jit(raw_fn)`` and ``jit(vmap(raw_fn))``: on the card, the whole program
over a static ``[lanes, pitch]`` arena that the executor owns, captured as
one CUDA graph at first call (``repro_torch.cuda_graphs``) and cached per
lane count.  Every dispatch stages the requests' inputs: each request's
bytes go into its row of a pinned host buffer, and the rows into a
device buffer in one upload.  The graph zeroes the arena, fills a
guard-byte plan's canaries in every lane, scatters those rows into each
lane's input slots, runs the program and gathers each lane's outputs
into a device buffer, which comes back in one download; the dispatch
returns the arena.  On the CPU the same steps run eagerly, with plain
host buffers.  Rolled loops, ring windows and the ``pending`` hand-offs
are Python-side, so they unroll into the graph.  An operator that runs its
``op.fn`` (host code) cannot be captured: ``fn``/``batched_fn`` refuse
such a program on the card with ``CaptureError``.

``replicated_fn(replicas, lanes)`` is the reference's
``pmap(vmap(raw_fn))``: one ``batched_fn(lanes)`` per device, each with its
own static arena (on ``cuda:i`` also its own copy of the constants and
its own captured graph).  A dispatch launches every replica on its own
device's stream before it waits for any of them; there are no
collectives.  On the CPU the host replicas (``device.force_host_devices``)
run one after another.  Both forms split a dispatch into ``launch`` and
``finish``, which waits on that dispatch's own events: a caller may launch
the next dispatch before it finishes the current one, into the program's
second pair of host staging buffers.

What the reference needed only for XLA is gone: the optimization barriers
between operators (eager PyTorch already materialises each output) and
the ``fuse`` and ``donate`` options.  Integer outputs are bit-identical to
the reference's; float outputs agree within accumulation tolerance.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.allocator import ArenaPlan, ArenaPlanner
from repro_torch.core.graph import Graph, Operator
from repro_torch.cuda_graphs import CapturedGraph, capture
from repro_torch.device import device_count, resolve_device
from repro_torch.errors import CaptureError, DeviceInitError, GuardViolation
from repro_torch.kernels.conv_quant.ops import RingWindow, ring_spans
from repro_torch.tracing import span

# Graph dtype name -> torch dtype of the typed arena views.
TORCH_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32, "float32": torch.float32,
}

# Guard-byte debug mode: never-placed arena gaps (``ArenaPlan.
# guard_regions``) are filled with this canary in every lane before the
# program runs and verified untouched after execution.  0xA5 = 1010_0101
# — asymmetric under bit rotation and distinct from 0x00/0xFF, so
# zero-fills, one-fills and shifted writes all trip it.
CANARY_BYTE = 0xA5

# What an executor counts where the work happens (``CompiledExecutor.
# counters``; they only ever grow): lanes written, host-to-device
# transfers made and the requests' bytes they carried, device-to-host
# transfers made and the bytes of the outputs read, graph replays and
# captures.  A program call given requests makes one upload and one
# download.
EXECUTOR_COUNTERS = ("lanes_written", "uploads", "upload_bytes",
                     "downloads", "download_bytes", "replays", "captures")


# ----------------------------------------------------------- lowering registry
class LoweringCtx:
    """What a lowering rule may ask about the graph being compiled, and the
    device copies of operator constants (made once, at first use)."""

    def __init__(self, graph: Graph, device: torch.device) -> None:
        self.graph = graph
        self.device = device
        # id(array) -> (array, device tensor): Pex clones share their
        # source op's weight array, so they share one device copy
        self._params: Dict[int, Tuple[Any, torch.Tensor]] = {}

    def shape(self, tensor: str) -> Tuple[int, ...]:
        t = self.graph.tensors[tensor]
        return tuple(t.shape) if t.shape else (t.elements,)

    def dtype(self, tensor: str) -> str:
        return self.graph.tensors[tensor].dtype

    def param(self, op: Operator, key: str) -> torch.Tensor:
        arr = op.attrs[key]
        hit = self._params.get(id(arr))
        if hit is None:
            hit = (arr, torch.as_tensor(np.asarray(arr), device=self.device))
            self._params[id(arr)] = hit
        return hit[1]


_RULES: Dict[str, Callable[..., Any]] = {}


def register_lowering(kind: str):
    """Register ``fn(ctx, op, *inputs, out) -> output`` as the lowering for
    operators of ``kind``.  Inputs are ``[lanes, *shape]`` tensors; ``out``
    is the output's arena view (None when the output stays off the arena).
    A rule may write into ``out`` and return it, or return a new tensor
    that the executor then copies there.  Rules live next to the op
    semantics."""
    def deco(fn):
        _RULES[kind] = fn
        return fn
    return deco


def _store(name: str, val: torch.Tensor, out: torch.Tensor) -> None:
    """Copy a lowered value into its arena view, refusing what would be
    silently cast or reshaped."""
    if val.dtype != out.dtype:
        raise ValueError(
            f"{name}: lowered output is {val.dtype}, graph declares "
            f"{out.dtype} — quantized semantics must requantize before "
            f"writing to the arena")
    if val.numel() != out.numel():
        raise ValueError(
            f"{name}: lowered output has {val.numel()} elements, the arena "
            f"view holds {out.numel()}")
    out.copy_(val.reshape(out.shape))


def _fallback(ctx: LoweringCtx, op: Operator, *args, out):
    """A kind without a rule: ``op.fn`` on each lane's unbatched inputs,
    each result copied into that lane's output view."""
    if op.fn is None:
        raise ValueError(
            f"operator {op.name!r} (kind={op.kind!r}) has neither a lowering "
            f"rule nor executable semantics")
    for lane in range(out.shape[0]):
        val = torch.as_tensor(op.fn(*[a[lane] for a in args]),
                              device=out.device)
        _store(op.output, val, out[lane])
    return out


def lower_op(ctx: LoweringCtx, op: Operator, *args, out=None):
    return _RULES.get(op.kind, _fallback)(ctx, op, *args, out=out)


def _carry(acc: torch.Tensor, out: torch.Tensor) -> None:
    """Make ``out`` hold ``acc``: nothing to do when the plan aliased the
    two (the inplace chain), a copy otherwise."""
    if acc.data_ptr() != out.data_ptr():
        out.copy_(acc)


@register_lowering("pex_slice")
def _lower_pex_slice(ctx: LoweringCtx, op: Operator, x, *, out):
    lo, hi = op.attrs["pex_rows"]
    x = x[:, lo:hi]
    cols = op.attrs.get("pex_cols")     # 2-D tile extract: columns too
    if cols is not None:
        x = x[:, :, cols[0]:cols[1]]
    return x


@register_lowering("pex_concat")
def _lower_pex_concat(ctx: LoweringCtx, op: Operator, *args, out):
    a = op.attrs
    part = args[-1]
    if a.get("pex_first"):
        out.zero_()
    else:
        _carry(args[0], out)
    # 2-D tiles write at (row, column) — pex_cstart is 0 for row cascades
    r0, c0 = a["pex_start"], a.get("pex_cstart", 0)
    if part.dim() == 2:
        out[:, r0:r0 + part.shape[1]] = part
    else:
        out[:, r0:r0 + part.shape[1], c0:c0 + part.shape[2]] = part
    return out


# Cascaded-streaming ring ops (core/partition.py cascade rewrite): row ``r``
# of a boundary tensor lives at ring position ``r % ring_rows``.  A push
# writes the producer's new rows at their ring positions (the chain of ring
# states aliases to one arena offset, so this is the rolling buffer); a read
# gathers the consumer's halo'd window back into row order, or, zero-copy,
# hands the consumer a ``RingWindow`` that names it where it lies.
@register_lowering("pex_ring_push")
def _lower_pex_ring_push(ctx: LoweringCtx, op: Operator, *args, out):
    a = op.attrs
    part = args[-1]
    if a.get("pex_first"):
        out.zero_()
    else:
        _carry(args[0], out)
    for pos, j, length in ring_spans(a["pex_ring_dst"], part.shape[1],
                                     a["pex_ring_rows"]):
        out[:, pos:pos + length] = part[:, j:j + length]
    return out


@register_lowering("pex_ring_read")
def _lower_pex_ring_read(ctx: LoweringCtx, op: Operator, ring, *, out):
    assert ring.shape[1] == op.attrs["pex_ring_rows"], op.name
    win = RingWindow(ring, op.attrs["pex_ring_src"],
                     ctx.shape(op.output)[0])
    if out is None:     # zero-copy: the window is handed to its consumer
        return win
    return win.gather(out)


# ------------------------------------------------------- zero-copy ring reads
# A ``pex_ring_read`` gathers a halo'd window out of the ring in row order.
# Writing that window into the arena is a pure copy the consumer never
# needs: the window is handed to the consumer as a ``RingWindow`` (the
# ring, the window's first ring row and its row count) instead, when that
# is provably bit-safe.  K2 and K3 read it where it lies on the card;
# every other consumer gathers it into a new tensor first.  Safe means:
#
# * the window is integer-typed and the consumer is an integer-exact kind;
# * the read's output has exactly one consumer, scheduled immediately after
#   it in the same Pex slice group (true by construction for the cascade
#   rewrite's ``cpexrd__*`` reads), and is not a graph output.
#
# The arena plan is untouched: the window keeps its placement (the memory
# model still charges it), the program just never writes it.
_ZERO_COPY_KINDS = frozenset({"qconv", "qdwconv", "qmaxpool"})
_INT_DTYPES = frozenset({"int8", "uint8", "int16", "int32"})


def _zero_copy_reads(graph: Graph, sched: Sequence[Operator]) -> set:
    """Tensor names of ring-read windows kept off the arena."""
    outs = set(graph.outputs)
    fused = set()
    for idx in range(len(sched) - 1):
        op, nxt = sched[idx], sched[idx + 1]
        if op.kind != "pex_ring_read" or "pex_ring_src" not in op.attrs:
            continue
        name = op.output
        if name in outs or graph.tensors[name].dtype not in _INT_DTYPES:
            continue
        cons = graph.consumers(name)
        if (len(cons) == 1 and cons[0].name == nxt.name
                and nxt.kind in _ZERO_COPY_KINDS
                and op.attrs.get("pex_seg") == nxt.attrs.get("pex_seg")
                and op.attrs.get("pex_slice_idx")
                == nxt.attrs.get("pex_slice_idx")):
            fused.add(name)
    return fused


# -------------------------------------------------------------- loop rolling
def _roll_key(ctx: LoweringCtx, op: Operator):
    """Hashable description of what an op *computes* (not where its tensors
    live).  Two ops with equal keys run the same program on same-shaped data,
    so consecutive slices whose keys match position-for-position roll into
    one loop.  ``None`` = not rollable."""
    ins = tuple((ctx.shape(i), ctx.dtype(i)) for i in op.inputs)
    outs = (ctx.shape(op.output), ctx.dtype(op.output))
    a = op.attrs
    if op.kind == "pex_slice":
        if "pex_rows" not in a:
            return None
        lo, hi = a["pex_rows"]
        return ("pex_slice", hi - lo, a.get("pex_cols"), ins, outs)
    if op.kind == "pex_concat":
        if "pex_start" not in a:
            return None
        return ("pex_concat", bool(a.get("pex_first")),
                a.get("pex_cstart"), ins, outs)
    if op.kind == "pex_ring_push":
        if "pex_ring_dst" not in a:
            return None
        return ("pex_ring_push", bool(a.get("pex_first")),
                a["pex_ring_rows"], ins, outs)
    if op.kind == "pex_ring_read":
        if "pex_ring_src" not in a:
            return None
        return ("pex_ring_read", a["pex_ring_rows"], ins, outs)
    if "pex_of" in a and "pex_pads" in a:
        wpads = a.get("pex_wpads")
        return (op.kind, a["pex_of"], tuple(a["pex_pads"]),
                None if wpads is None else tuple(wpads), ins, outs)
    return None


@dataclasses.dataclass
class _RolledLoop:
    run: List[List[Operator]]          # one slice group per iteration

    @property
    def n(self) -> int:
        return len(self.run)

    @property
    def width(self) -> int:
        return len(self.run[0])


def _slice_groups(sched: Sequence[Operator]):
    """Split the schedule into maximal runs of ops tagged with the same
    (segment, slice index); untagged ops stand alone."""
    groups: List[Tuple[Optional[str], Optional[int], List[Operator]]] = []
    for op in sched:
        seg = op.attrs.get("pex_seg")
        s = op.attrs.get("pex_slice_idx")
        if (seg is not None and groups and groups[-1][0] == seg
                and groups[-1][1] == s):
            groups[-1][2].append(op)
        else:
            groups.append((seg, s, [op]))
    return groups


def _build_loop(offsets: Dict[str, Tuple[int, int]],
                run: List[List[Operator]]) -> Optional[_RolledLoop]:
    """Merge ≥2 structurally-identical slice groups into one loop, or None
    when an operand's byte size differs across iterations (the reference's
    uniformity condition for a loop body with per-iteration offsets)."""
    for d in range(len(run[0])):
        ops = [g[d] for g in run]
        for j in range(len(ops[0].inputs)):
            if len({offsets[o.inputs[j]][1] for o in ops}) != 1:
                return None
        if len({offsets[o.output][1] for o in ops}) != 1:
            return None
    return _RolledLoop(run)


def _plan_items(ctx: LoweringCtx, offsets: Dict[str, Tuple[int, int]],
                sched: Sequence[Operator]) -> List[Any]:
    """The program structure: a list of Operators (straight-line steps)
    and _RolledLoops."""
    items: List[Any] = []
    groups = _slice_groups(sched)
    i = 0
    while i < len(groups):
        seg, s, ops = groups[i]
        key = (None if seg is None
               else tuple(_roll_key(ctx, op) for op in ops))
        if seg is None or key is None or any(k is None for k in key):
            items.extend(ops)
            i += 1
            continue
        run = [ops]
        j = i + 1
        while j < len(groups):
            seg2, s2, ops2 = groups[j]
            if (seg2 != seg or s2 != s + (j - i)
                    or len(ops2) != len(ops)
                    or tuple(_roll_key(ctx, op) for op in ops2) != key):
                break
            run.append(ops2)
            j += 1
        loop = _build_loop(offsets, run) if len(run) >= 2 else None
        if loop is None:
            items.extend(ops)
            i += 1
        else:
            items.append(loop)
            i = j
    return items


# ------------------------------------------------------------------- executor
@dataclasses.dataclass
class CompiledExecutor:
    """A scheduled graph lowered to one program over a uint8 byte arena.

    ``new_arena(lanes)`` makes a zeroed ``[lanes, pitch]`` arena on
    ``device``, ``write_inputs`` fills one lane, ``execute`` runs the
    program on every lane in place (one kernel launch per op for all
    lanes), ``outputs_from`` reads one lane's outputs.  ``fn`` and
    ``batched_fn(lanes)`` are the compiled forms (``ArenaProgram``);
    ``run`` is one request through ``fn``.  ``counters`` holds the
    ``EXECUTOR_COUNTERS`` of everything run on this executor; a replica's
    copy (``_on``) counts its own.
    """

    graph: Graph
    schedule: List[Operator]
    plan: ArenaPlan
    arena_size: int              # bytes of one lane (== plan.arena_size)
    pitch: int                   # bytes between lanes (>= arena_size)
    device: torch.device
    rolled_loops: int
    rolled_ops: int
    steps: int
    offsets: Dict[str, Tuple[int, int]]    # tensor -> (byte offset, bytes)
    zero_copy_reads: int = 0    # ring windows handed straight to consumers
    # guard-byte debug mode: (offset, size) arena ranges no placement ever
    # covers; () in production (guard_bytes=0 plans)
    guard_regions: Tuple[Tuple[int, int], ...] = ()
    _ctx: Optional[LoweringCtx] = dataclasses.field(
        default=None, repr=False, compare=False)
    _items: List[Any] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    _zc: frozenset = dataclasses.field(
        default=frozenset(), repr=False, compare=False)
    # the compiled forms, per lane count (the reference's ``_fn_cache``)
    _fn_cache: Dict[int, "ArenaProgram"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # replica index (>= 1) -> this program on that replica's device
    _replicas: Dict[int, "CompiledExecutor"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    counters: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(EXECUTOR_COUNTERS, 0),
        repr=False, compare=False)

    # ------------------------------------------------------------ arenas
    def new_arena(self, lanes: int = 1) -> torch.Tensor:
        """An all-zero ``[lanes, pitch]`` arena.  A lane no request is
        written to stays all zero: that is a serving pad lane."""
        return torch.zeros((lanes, self.pitch), dtype=torch.uint8,
                           device=self.device)

    def _view(self, arena: torch.Tensor, name: str) -> torch.Tensor:
        off, size = self.offsets[name]
        return self._typed(arena[:, off:off + size], name)

    def _typed(self, cols: torch.Tensor, name: str) -> torch.Tensor:
        """``[lanes, bytes]`` uint8 columns as tensor ``name``'s ``[lanes,
        *shape]`` of its dtype."""
        t = self.graph.tensors[name]
        shape = tuple(t.shape) if t.shape else (t.elements,)
        return cols.view(TORCH_DTYPES[t.dtype]).view(cols.shape[0], *shape)

    @functools.cached_property
    def arena_inputs(self) -> Tuple[str, ...]:
        """The graph inputs the plan keeps in the arena (those with a
        consumer), in arena order: what every request must give."""
        g = self.graph
        return tuple(sorted((c for c in g.constants() if g.consumers(c)),
                            key=lambda n: self.offsets[n][0]))

    def input_bytes(self, inputs: Dict[str, Any]
                    ) -> List[Tuple[str, torch.Tensor]]:
        """One request's arena-resident graph inputs as ``(name, uint8
        bytes)``, checked before any is written.  Values must already be
        in the tensor's declared dtype — an int8 graph takes quantized int8
        inputs."""
        g = self.graph
        missing = set(self.arena_inputs) - set(inputs)
        if missing:
            raise ValueError(f"missing graph inputs: {sorted(missing)}")
        out = []
        for name, value in inputs.items():
            if name not in g.tensors:
                raise ValueError(f"unknown tensor {name!r}")
            if g.producer(name) is not None:
                raise ValueError(f"{name!r} is not a graph input")
            if not g.consumers(name):
                continue       # unused input: not arena-resident in the plan
            t = g.tensors[name]
            val = torch.as_tensor(value)
            if val.dtype != TORCH_DTYPES[t.dtype]:
                raise ValueError(
                    f"input {name!r} is {val.dtype}, graph declares "
                    f"{t.dtype} (quantize inputs for int8 graphs)")
            if val.numel() != t.elements:
                raise ValueError(
                    f"input {name!r}: got {val.numel()} elements, plan "
                    f"expects {t.elements} ({self.offsets[name][1]} bytes "
                    f"as {t.dtype})")
            out.append((name, val.reshape(-1).view(torch.uint8)))
        return out

    def write_inputs(self, arena: torch.Tensor, lane: int,
                     inputs: Dict[str, Any]) -> None:
        """Write one request's graph inputs (as bytes, ``input_bytes``)
        into ``lane`` and its guard canaries: one upload per input."""
        values = self.input_bytes(inputs)
        row = arena[lane]
        self.fill_guards(row)
        for name, val in values:
            off, size = self.offsets[name]
            row[off:off + size] = val.to(self.device)
            self.counters["uploads"] += 1
            self.counters["upload_bytes"] += size

    def fill_guards(self, lanes: torch.Tensor) -> None:
        """Fill the guard regions of a ``[pitch]`` lane or a ``[lanes,
        pitch]`` arena with ``CANARY_BYTE``; nothing on a plan without
        guard regions."""
        for off, size in self.guard_regions:
            lanes[..., off:off + size] = CANARY_BYTE

    def pad_arena(self) -> torch.Tensor:
        """One ``[pitch]`` lane, all zero but for a guard-byte plan's
        canaries: what every lane past the admitted requests holds when
        a dispatch of ``batched_fn`` or ``replicated_fn`` starts (a
        serving pad lane: executed, never read back, visibly not a
        duplicated request)."""
        lane = torch.zeros(self.pitch, dtype=torch.uint8, device=self.device)
        self.fill_guards(lane)
        return lane

    def make_arena(self, inputs: Dict[str, Any]) -> torch.Tensor:
        """A fresh one-lane arena with ``inputs`` written."""
        arena = self.new_arena(1)
        self.write_inputs(arena, 0, inputs)
        return arena

    # --------------------------------------------------------- execution
    def _step(self, arena: torch.Tensor, op: Operator,
              pending: Dict[str, torch.Tensor]) -> None:
        try:
            args = [pending.pop(i) if i in pending
                    else self._view(arena, i) for i in op.inputs]
            if op.output in self._zc:   # zero-copy: straight to the consumer
                pending[op.output] = lower_op(self._ctx, op, *args,
                                              out=None)
                return
            out = self._view(arena, op.output)
            val = lower_op(self._ctx, op, *args, out=out)
            if val is not out:
                _store(op.output, val, out)
        except Exception as e:
            e.add_note(f"operator {op.name!r} (kind {op.kind!r})")
            raise

    def execute(self, arena: torch.Tensor) -> torch.Tensor:
        """Run the program in place on every lane of ``arena``."""
        if arena.dim() != 2 or arena.shape[1] != self.pitch \
                or arena.dtype != torch.uint8 or arena.device != self.device:
            raise ValueError(
                f"arena must be uint8 [lanes, {self.pitch}] on "
                f"{self.device}, got {arena.dtype} {tuple(arena.shape)} on "
                f"{arena.device}")
        pending: Dict[str, torch.Tensor] = {}
        for item in self._items:
            if isinstance(item, _RolledLoop):
                for group in item.run:          # one iteration per group
                    for op in group:
                        self._step(arena, op, pending)
            else:
                self._step(arena, item, pending)
        return arena

    # ----------------------------------------------------------- results
    def outputs_from(self, arena, lane: int = 0,
                     as_numpy: bool = True) -> Dict[str, Any]:
        """One lane's graph outputs, copied out of ``arena``: a ``[lanes,
        pitch]`` or ``[pitch]`` tensor or numpy array, or an
        ``ArenaProgram``, whose last finished dispatch's lane is read as
        numpy from its staged host rows where that dispatch admitted the
        lane (no transfer) and from its arena otherwise.  The compiled forms
        overwrite both at the next dispatch.  A tensor's read counts a
        download an output; a numpy array is already on the host."""
        if isinstance(arena, ArenaProgram):
            if as_numpy and lane < arena.staged_rows:
                return arena.staged_outputs(lane)
            arena = arena.arena
        on_host = isinstance(arena, np.ndarray)
        arena = torch.as_tensor(arena)
        if arena.dim() == 1:
            arena = arena[None]
        out: Dict[str, Any] = {}
        for o in self.graph.outputs:
            val = self._view(arena[lane:lane + 1], o)[0]
            if as_numpy:
                out[o] = val.to("cpu", copy=True).numpy()
                if not on_host:
                    self.counters["downloads"] += 1
                    self.counters["download_bytes"] += out[o].nbytes
            else:
                out[o] = val.clone()
        return out

    def verify_guards(self, arena) -> None:
        """Guard-byte debug mode: every canary region of every lane of
        ``arena`` must still hold ``CANARY_BYTE``; a stomped byte is an
        out-of-bounds write by a lowering or a planner bug and raises
        ``GuardViolation`` naming the first bad offset.  No-op when the
        plan carries no guard regions."""
        if not self.guard_regions:
            return
        a = torch.as_tensor(arena).cpu().numpy()
        for row in a.reshape(-1, a.shape[-1]):
            for off, size in self.guard_regions:
                bad = np.nonzero(row[off:off + size] != CANARY_BYTE)[0]
                if bad.size:
                    at = off + int(bad[0])
                    raise GuardViolation(
                        f"guard canary stomped at arena byte {at} (region "
                        f"[{off},{off + size}), found 0x{int(row[at]):02x}, "
                        f"expected 0x{CANARY_BYTE:02x}) — out-of-bounds "
                        f"write by a lowering or an arena-plan bug")

    def run(self, inputs: Dict[str, Any], as_numpy: bool = True
            ) -> Dict[str, Any]:
        """One request through ``fn``."""
        prog = self.fn
        self.verify_guards(prog([inputs]))
        return self.outputs_from(prog, 0, as_numpy)

    # ---------------------------------------------------- compiled forms
    def check_capturable(self) -> None:
        """Raise ``CaptureError`` naming the first operator that runs its
        ``op.fn`` (host code a CUDA graph cannot hold)."""
        for op in self.schedule:
            if op.kind not in _RULES:
                raise CaptureError(
                    f"operator {op.name!r} (kind {op.kind!r}) has no "
                    f"lowering rule and runs its op.fn on the host; a CUDA "
                    f"graph cannot hold it (execute runs such a program)")

    def batched_fn(self, lanes: int) -> "ArenaProgram":
        """The program over a static ``[lanes, pitch]`` arena, as one CUDA
        graph on the card (captured at its first call), cached per lane
        count."""
        prog = self._fn_cache.get(lanes)
        if prog is None:
            if lanes < 1:
                raise ValueError(f"lanes must be >= 1, got {lanes}")
            if self.device.type == "cuda":
                self.check_capturable()
            prog = self._fn_cache[lanes] = ArenaProgram(self, lanes)
        return prog

    @property
    def fn(self) -> "ArenaProgram":
        """The one-lane program (``batched_fn(1)``): what ``run`` and
        ``Deployment.run`` dispatch."""
        return self.batched_fn(1)

    def replicated_fn(self, replicas: int, lanes: int) -> "ReplicatedProgram":
        """``batched_fn(lanes)`` on each of ``replicas`` devices of this
        executor's kind: this device first, then the others in index
        order (on the CPU, host replicas).  Raises ``DeviceInitError``
        when there are fewer devices than ``replicas``."""
        have = device_count(self.device)
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if replicas > have:
            hint = (" (call repro_torch.serving.force_host_devices"
                    f"({replicas}) to offer more host replicas)"
                    if self.device.type == "cpu" else "")
            raise DeviceInitError(
                f"replicas={replicas} but only {have} {self.device.type} "
                f"device(s){hint}")
        if self.device.type == "cuda":
            devices = [self.device] + [
                torch.device("cuda", i) for i in range(have)
                if i != self.device.index]
        else:
            devices = [self.device] * replicas
        progs = [self.batched_fn(lanes)]
        for r in range(1, replicas):
            rex = self._replicas.get(r)
            if rex is None:
                rex = self._replicas[r] = self._on(devices[r])
            progs.append(rex.batched_fn(lanes))
        return ReplicatedProgram(progs)

    def _on(self, device: torch.device) -> "CompiledExecutor":
        """This program on ``device``: its own device copies of the
        constants (made at its first run) and its own compiled forms."""
        return dataclasses.replace(
            self, device=device, _ctx=LoweringCtx(self.graph, device),
            _fn_cache={}, _replicas={},
            counters=dict.fromkeys(EXECUTOR_COUNTERS, 0))


class Launched(NamedTuple):
    """One dispatch of an ``ArenaProgram``, launched and not yet waited
    for: the staging pair it used (0 or 1), its admitted rows, its number
    among the program's dispatches, and the event recorded after its
    download (None on the CPU, where the dispatch is complete when
    ``launch`` returns)."""

    pair: int
    rows: int
    seq: int
    done: Optional["torch.cuda.Event"]


class ArenaProgram:
    """``batched_fn(lanes)``: the arena program over ``arena``, a static
    ``[lanes, pitch]`` arena.  Calling it with up to ``lanes`` requests'
    input dicts runs one dispatch: request i in lane i, the other lanes
    pad lanes (``pad_arena``), and returns the arena, which the next call
    overwrites.  On the card the device work is a replay of ``graph``,
    captured at the first call; on the CPU it runs eagerly.

    Every dispatch is staged: each request's input bytes go into its row
    of ``host_in`` (pinned on the card), rows ``[0, n)`` into ``dev_in``
    in one upload, and ``device_work`` zeroes the arena, fills its guard
    canaries, scatters ``dev_in``'s rows into the lanes' input slots,
    runs ``execute`` and gathers the lanes' outputs into ``dev_out``,
    whose rows ``[0, n)`` come back into ``host_out`` in one download.

    A call is ``launch`` then ``finish``.  ``launch`` enqueues the
    dispatch and returns without waiting for the card; ``finish`` waits
    for that dispatch's own event and makes its rows the ones
    ``outputs_from(program, lane)`` reads (``staged_rows`` = n).  Two
    host pairs ``host_in[k]``/``host_out[k]`` are used in turn, so a
    second dispatch can be launched before the first is finished: its
    download lands in the other pair.  ``dev_in``, ``dev_out``, the arena
    and the graph stay single; the card's stream runs one dispatch's
    graph before the next one's upload.  At most two dispatches may be
    in flight: a third takes the first one's pair, and finishing the
    first then raises."""

    def __init__(self, executor: CompiledExecutor, lanes: int) -> None:
        self.executor = executor
        self.lanes = lanes
        self.arena = executor.new_arena(lanes)
        self.graph: Optional[CapturedGraph] = None
        self.staged_rows = 0
        self._stage_buffers()

    def _stage_buffers(self) -> None:
        """The staging buffers, ``[lanes, bytes]`` each, and the views the
        host and the device work copy through."""
        ex, arena, lanes = self.executor, self.arena, self.lanes
        on_card = ex.device.type == "cuda"

        def columns(names):
            """(name, column, (arena offset, bytes)) of each of ``names``
            in a row, each column aligned as the arena's offsets are, so
            that typed views stay views; the row's width."""
            isz, cols, at = ex.graph.max_itemsize(), [], 0
            for n in names:
                at = -(-at // isz) * isz
                cols.append((n, at, ex.offsets[n]))
                at += ex.offsets[n][1]
            return cols, -(-at // isz) * isz

        def buffers(width):
            """Two host buffers (pinned on the card) and one device
            buffer, ``[lanes, width]`` each."""
            host = [torch.zeros((lanes, width), dtype=torch.uint8,
                                pin_memory=on_card) for _ in range(2)]
            return host, torch.zeros((lanes, width), dtype=torch.uint8,
                                     device=ex.device)
        ins, width_in = columns(ex.arena_inputs)
        outs, width_out = columns(ex.graph.outputs)
        # a request's bytes and a lane's output bytes, as the counters take
        self.in_bytes = sum(size for *_, (_, size) in ins)
        self.out_bytes = sum(size for *_, (_, size) in outs)
        self.host_in, self.dev_in = buffers(width_in)
        self.host_out, self.dev_out = buffers(width_out)
        self._scatter = [(arena[:, off:off + size],
                          self.dev_in[:, at:at + size])
                         for _, at, (off, size) in ins]
        self._gather = [(self.dev_out[:, at:at + size],
                         arena[:, off:off + size])
                        for _, at, (off, size) in outs]
        self._host_rows = [[{n: host[lane, at:at + size]
                             for n, at, (_, size) in ins}
                            for lane in range(lanes)]
                           for host in self.host_in]
        self._out_views = [{n: ex._typed(host[:, at:at + size], n)
                            for n, at, (_, size) in outs}
                           for host in self.host_out]
        # recorded after each dispatch's download: that dispatch's
        # transfers of its pair and its device work are over once it has
        # passed
        self._done = ([torch.cuda.Event(), torch.cuda.Event()] if on_card
                      else [None, None])
        self._seq = [0, 0]      # the dispatch whose rows each pair holds
        self._launched = 0      # dispatches launched so far
        self._read = 0          # the pair of the last finished dispatch

    def device_work(self) -> torch.Tensor:
        """What a dispatch runs on the device, captured as one graph on
        the card; the arena holds the outputs after it."""
        ex, arena = self.executor, self.arena
        arena.zero_()
        ex.fill_guards(arena)
        for slot, rows in self._scatter:
            slot.copy_(rows)
        ex.execute(arena)
        for rows, slot in self._gather:
            rows.copy_(slot)
        return arena

    def capture(self) -> CapturedGraph:
        """Capture the program on the card, once."""
        if self.graph is None:
            ex = self.executor
            with span("capture"):
                self.graph = capture(
                    self.device_work, ex.device,
                    what=f"the arena program ({self.lanes} lanes, "
                         f"{ex.steps} ops)")
            ex.counters["captures"] += 1
        return self.graph

    def _upload(self, k: int, requests: Sequence[Dict[str, Any]]) -> None:
        """Stage the requests' bytes into ``host_in[k]`` and upload its
        rows; the device's pad rows are zeroed."""
        ex, n = self.executor, len(requests)
        if self._done[k] is not None:   # the pair's last upload read it
            self._done[k].synchronize()
        for rows, inputs in zip(self._host_rows[k], requests):
            for name, val in ex.input_bytes(inputs):
                rows[name].copy_(val)
        if n:
            self.dev_in[:n].copy_(self.host_in[k][:n], non_blocking=True)
            ex.counters["uploads"] += 1
            ex.counters["upload_bytes"] += n * self.in_bytes
        if n < self.lanes:
            self.dev_in[n:].zero_()

    def _download(self, k: int, n: int) -> None:
        """Download ``dev_out``'s rows ``[0, n)`` into ``host_out[k]``,
        then record the pair's event."""
        ex = self.executor
        if n:
            self.host_out[k][:n].copy_(self.dev_out[:n], non_blocking=True)
            ex.counters["downloads"] += 1
            ex.counters["download_bytes"] += n * self.out_bytes
        if self._done[k] is not None:
            self._done[k].record(torch.cuda.current_stream(ex.device))

    def staged_outputs(self, lane: int) -> Dict[str, np.ndarray]:
        """Lane ``lane``'s outputs of the last finished dispatch, numpy
        copies of its row of that dispatch's ``host_out`` (the dispatch
        after the next overwrites the row)."""
        return {n: v[lane].numpy().copy()
                for n, v in self._out_views[self._read].items()}

    def launch(self, requests: Sequence[Dict[str, Any]]) -> Launched:
        """Stage, upload, replay and download one dispatch, and return
        without waiting for the card."""
        if len(requests) > self.lanes:
            raise ValueError(f"{len(requests)} requests for {self.lanes} "
                             f"lanes")
        ex, n = self.executor, len(requests)
        if ex.device.type == "cuda":
            self.capture()
        k = self._launched % 2
        self.staged_rows = 0
        with span("write_inputs"):
            self._upload(k, requests)
        ex.counters["lanes_written"] += n
        with span("run"):
            if self.graph is not None:
                self.graph.replay()
                ex.counters["replays"] += 1
            else:
                self.device_work()
            self._download(k, n)
        self._launched += 1
        self._seq[k] = self._launched
        return Launched(k, n, self._launched, self._done[k])

    def finish(self, launched: Launched) -> torch.Tensor:
        """Wait for ``launched``'s event (not for the device), make its
        rows the ones ``outputs_from(program, lane)`` reads, and return
        the arena (a dispatch launched since may be overwriting it)."""
        if self._seq[launched.pair] != launched.seq:
            raise RuntimeError(
                f"dispatch {launched.seq}'s staging rows were taken by "
                f"dispatch {self._seq[launched.pair]}: at most two "
                f"dispatches of a program may be in flight")
        if launched.done is not None:
            launched.done.synchronize()
        self.staged_rows, self._read = launched.rows, launched.pair
        return self.arena

    def __call__(self, requests: Sequence[Dict[str, Any]]) -> torch.Tensor:
        return self.finish(self.launch(requests))


class ReplicatedProgram:
    """``replicated_fn(replicas, lanes)``: one ``ArenaProgram`` of ``lanes``
    lanes per replica.  Calling it with up to ``capacity`` requests' input
    dicts hands request i to replica ``i // lanes``, lane ``i % lanes``,
    launches every replica on its own device's current stream, then waits
    for all of them, and returns the replicas' ``[lanes, pitch]`` arenas
    in replica order (each overwritten by the next call).  A call is
    ``launch`` then ``finish``, as on each replica's program."""

    def __init__(self, programs: Sequence[ArenaProgram]) -> None:
        self.programs = list(programs)
        self.lanes = self.programs[0].lanes

    @property
    def capacity(self) -> int:
        return len(self.programs) * self.lanes

    def launch(self, requests: Sequence[Dict[str, Any]]) -> List[Launched]:
        """Launch one dispatch on every replica without waiting; its
        ``Launched`` on each, in replica order."""
        if len(requests) > self.capacity:
            raise ValueError(f"{len(requests)} requests for {self.capacity} "
                             f"lanes")
        launched = []
        for r, prog in enumerate(self.programs):
            chunk = requests[r * self.lanes:(r + 1) * self.lanes]
            dev = prog.executor.device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                launched.append(prog.launch(chunk))
        return launched

    def finish(self, launched: Sequence[Launched]) -> List[torch.Tensor]:
        """Wait for the dispatch ``launched`` names, on each replica's own
        event (``rt.wait``), and return the replicas' arenas."""
        waits = any(h.done is not None for h in launched)
        with (span("wait") if waits else contextlib.nullcontext()):
            return [prog.finish(h)
                    for prog, h in zip(self.programs, launched)]

    def __call__(self, requests: Sequence[Dict[str, Any]]
                 ) -> List[torch.Tensor]:
        return self.finish(self.launch(requests))


def compile_schedule(graph: Graph,
                     schedule: Optional[Sequence[Operator]] = None,
                     plan: Optional[ArenaPlan] = None, *,
                     device=None) -> CompiledExecutor:
    """Lower ``schedule`` (default: the graph's embedded order) against
    ``plan`` (default: ``ArenaPlanner.plan``) into one program over a
    uint8 byte arena on ``device`` (None: the card; ``"cpu"`` for the
    plain path on the host).  See the module docstring for the model."""
    dev = resolve_device(device)
    # the CNN lowering rules register themselves when cnn_ops is imported
    from repro_torch.graphs import cnn_ops  # noqa: F401
    sched = list(schedule) if schedule is not None else graph.default_schedule()
    if not graph.is_valid_schedule(sched):
        raise ValueError("invalid schedule for this graph")
    if plan is None:
        plan = ArenaPlanner.plan(graph, sched)
    offsets = {p.tensor: (p.offset, p.size) for p in plan.placements}
    for op in sched:
        for t in list(op.inputs) + [op.output]:
            if t not in offsets:
                raise KeyError(f"tensor {t!r} missing from the arena plan")
            isz = graph.itemsize(t)
            if offsets[t][0] % isz:
                raise ValueError(
                    f"tensor {t!r} ({graph.tensors[t].dtype}) placed at "
                    f"misaligned byte offset {offsets[t][0]}; plan with "
                    f"ArenaPlanner.plan(..., alignment=None) so offsets "
                    f"are aligned to the widest itemsize")
        if op.kind not in _RULES and op.fn is None:
            raise ValueError(
                f"operator {op.name!r} (kind={op.kind!r}) has neither a "
                f"lowering rule nor executable semantics")
    ctx = LoweringCtx(graph, dev)
    zc = frozenset(_zero_copy_reads(graph, sched))
    items = _plan_items(ctx, offsets, sched)
    loops = [it for it in items if isinstance(it, _RolledLoop)]
    arena_size = int(plan.arena_size)
    isz = graph.max_itemsize()
    return CompiledExecutor(
        graph=graph, schedule=sched, plan=plan, arena_size=arena_size,
        pitch=max(-(-arena_size // isz) * isz, isz), device=dev,
        rolled_loops=len(loops),
        rolled_ops=sum(lp.n * lp.width for lp in loops),
        steps=len(sched), offsets=offsets, zero_copy_reads=len(zc),
        guard_regions=tuple(plan.guard_regions())
        if getattr(plan, "guard_bytes", 0) else (),
        _ctx=ctx, _items=items, _zc=zc)


__all__ = ["ArenaProgram", "CANARY_BYTE", "CompiledExecutor",
           "EXECUTOR_COUNTERS", "Launched", "LoweringCtx",
           "ReplicatedProgram", "TORCH_DTYPES", "compile_schedule",
           "lower_op", "register_lowering"]
