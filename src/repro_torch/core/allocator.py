"""Tensor-buffer memory allocators.

``DynamicAllocator`` reproduces the paper's §4 runtime strategy: tensors live
in contiguous blocks of one arena; memory is reclaimed as soon as a tensor's
last consumer has run; after every operator, all live buffers are compacted to
the start of the region ("moving all tensor buffers to the start of the memory
region as much as possible after the execution of every operator").  It
reports the peak arena high-water mark and the total bytes memmoved — the
proxy for the paper's measured <1 % latency/energy overhead.

``ArenaPlanner`` is the §6 extension ("when the execution schedule is known in
advance, optimal tensor buffer placement in memory may be precomputed"): an
offline offset assignment over tensor lifetimes, greedy best-fit by decreasing
size — the strategy used by TFLite's arena planner.  Invariant (property
tested): tensors with overlapping lifetimes occupy disjoint address ranges.

Both allocators are **byte-granular**: sizes are bytes
(``elements * itemsize``, see ``graph.DTYPE_ITEMSIZE``) and offsets are byte
offsets.  Alignment policy: every offset is rounded up to ``alignment``
bytes; ``ArenaPlanner.plan(alignment=None)`` picks the graph's widest
element type (4 for any graph containing f32 tensors, 1 for pure int8), so
a bitcast view of the arena at any placement is always naturally aligned —
the precondition the compiled executor (and a real MCU pointer cast)
relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import Graph, Operator, inplace_candidates


@dataclasses.dataclass
class Block:
    tensor: str
    offset: int
    size: int


@dataclasses.dataclass
class AllocatorStats:
    peak_bytes: int = 0
    bytes_moved: int = 0
    allocations: int = 0
    frees: int = 0
    defrag_passes: int = 0


class DynamicAllocator:
    """First-fit allocation + compact-to-front defragmentation (paper §4).

    ``alignment`` > 1 rounds every block offset up to that many bytes
    (mixed-dtype arenas need at least the widest itemsize so live buffers
    stay dereferenceable after compaction)."""

    def __init__(self, capacity: Optional[int] = None,
                 alignment: int = 1) -> None:
        if alignment < 1:
            raise ValueError(f"alignment must be >= 1, got {alignment}")
        self.capacity = capacity
        self.alignment = alignment
        self.blocks: List[Block] = []          # sorted by offset
        self.addresses: Dict[str, int] = {}    # tensor -> offset
        self.stats = AllocatorStats()

    def _align(self, x: int) -> int:
        a = self.alignment
        return (x + a - 1) // a * a

    # ------------------------------------------------------------------ api
    def alloc(self, tensor: str, size: int) -> int:
        if tensor in self.addresses:
            raise ValueError(f"{tensor!r} already allocated")
        offset = self._first_fit(size)
        if self.capacity is not None and offset + size > self.capacity:
            raise MemoryError(
                f"arena overflow allocating {tensor!r} ({size}B) at {offset}"
                f" with capacity {self.capacity}")
        blk = Block(tensor, offset, size)
        self._insert(blk)
        self.addresses[tensor] = offset
        self.stats.allocations += 1
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.high_water())
        return offset

    def free(self, tensor: str) -> None:
        for k, b in enumerate(self.blocks):
            if b.tensor == tensor:
                del self.blocks[k]
                del self.addresses[tensor]
                self.stats.frees += 1
                return
        raise KeyError(tensor)

    def rename(self, old: str, new: str) -> int:
        """Hand ``old``'s block to ``new`` without moving memory — an
        operator that wrote its output in place over a dead input (partial
        execution's shared output buffer does this every slice)."""
        if new in self.addresses:
            raise ValueError(f"{new!r} already allocated")
        for b in self.blocks:
            if b.tensor == old:
                b.tensor = new
                self.addresses[new] = self.addresses.pop(old)
                return b.offset
        raise KeyError(old)

    def defragment(self) -> int:
        """Compact all live blocks to the start of the arena, preserving
        order (offsets stay aligned).  Returns bytes moved (cost proxy)."""
        moved = 0
        cursor = 0
        for b in self.blocks:
            if b.offset != cursor:
                moved += b.size
                b.offset = cursor
                self.addresses[b.tensor] = cursor
            cursor = self._align(cursor + b.size)
        self.stats.bytes_moved += moved
        self.stats.defrag_passes += 1
        return moved

    def high_water(self) -> int:
        return max((b.offset + b.size for b in self.blocks), default=0)

    def live_bytes(self) -> int:
        return sum(b.size for b in self.blocks)

    # ------------------------------------------------------------- internals
    def _first_fit(self, size: int) -> int:
        cursor = 0
        for b in self.blocks:
            if b.offset - cursor >= size:
                return cursor
            cursor = self._align(max(cursor, b.offset + b.size))
        return cursor

    def _insert(self, blk: Block) -> None:
        for k, b in enumerate(self.blocks):
            if b.offset > blk.offset:
                self.blocks.insert(k, blk)
                return
        self.blocks.append(blk)


# --------------------------------------------------------------------- plans
@dataclasses.dataclass
class Placement:
    tensor: str
    offset: int
    size: int
    start: int   # first step live (op index; -1 for graph inputs)
    end: int     # last step live (inclusive)
    alias: Optional[str] = None   # shared-buffer group (inplace chains)


@dataclasses.dataclass
class ArenaPlan:
    placements: List[Placement]
    arena_size: int
    guard_bytes: int = 0   # planned inter-placement guard width (0 = none)

    def offset_of(self, tensor: str) -> int:
        for p in self.placements:
            if p.tensor == tensor:
                return p.offset
        raise KeyError(tensor)

    def guard_regions(self) -> List[Tuple[int, int]]:
        """``(offset, size)`` byte ranges of the arena that **no** placement
        ever covers.  The compiled executor fills these with canary bytes
        and verifies them untouched after execution (guard-byte debug mode,
        DESIGN.md §12).

        Defined as the complement of the union of all placements — not "the
        ``guard_bytes`` after each placement" — because temporal reuse lets
        a time-disjoint tensor legitimately occupy another tensor's trailing
        pad.  The complement is provably never written by a correct program,
        so a stomped canary is always a genuine out-of-bounds write, never a
        false positive.  Empty when ``guard_bytes == 0`` (placements tile
        the arena up to alignment slack, which we deliberately do not treat
        as guarded in production plans — they must stay byte-identical)."""
        if self.guard_bytes <= 0:
            return []
        spans = sorted((p.offset, p.offset + p.size)
                       for p in self.placements if p.size > 0)
        merged: List[List[int]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        out: List[Tuple[int, int]] = []
        cursor = 0
        for lo, hi in merged:
            if lo > cursor:
                out.append((cursor, lo - cursor))
            cursor = hi
        if cursor < self.arena_size:
            out.append((cursor, self.arena_size - cursor))
        return out


def tensor_lifetimes(graph: Graph, schedule: Sequence[Operator],
                     include_constants: bool = True
                     ) -> List[Tuple[str, int, int]]:
    """(tensor, first_step, last_step) for every SRAM-resident tensor under
    ``schedule``.  Graph outputs live to the end; constants (inputs) from -1
    until their last use."""
    n = len(schedule)
    first: Dict[str, int] = {}
    last: Dict[str, int] = {}
    for t, op in enumerate(schedule):
        first[op.output] = t
        for i in op.inputs:
            last[i] = t
    for o in graph.outputs:
        last[o] = n - 1
    out = []
    for name in graph.tensors:
        if name in first:
            out.append((name, first[name], last.get(name, first[name])))
        elif include_constants and name in last:
            out.append((name, -1, last[name]))
    return out


def inplace_alias_groups(graph: Graph, schedule: Sequence[Operator]
                         ) -> Dict[str, str]:
    """tensor -> representative for buffers shared through ``inplace``
    operators (partial execution's incremental concat writes slice ``s`` into
    the buffer that already holds slices ``0..s-1``).  Mirrors the condition
    ``Graph.live_sets`` uses to charge the output buffer zero bytes: the
    consumed input must die at that step and match the output size."""
    n = len(schedule)
    last_use: Dict[str, int] = {}
    for t, op in enumerate(schedule):
        for i in op.inputs:
            last_use[i] = t
    for o in graph.outputs:
        last_use[o] = n            # pinned, never overwritten in place
    parent: Dict[str, str] = {}

    def find(x: str) -> str:
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    for t, op in enumerate(schedule):
        if not op.attrs.get("inplace"):
            continue
        for i in inplace_candidates(op):
            if (graph.producer(i) is not None
                    and graph.size(i) == graph.size(op.output)
                    and last_use.get(i, -1) == t):
                parent[find(op.output)] = find(i)
                break
    members = set(parent) | set(parent.values())
    return {t: find(t) for t in members}


class ArenaPlanner:
    """Offline best-fit offset assignment (greedy over candidate orders).

    Tensors chained through ``inplace`` operators are planned as one
    shared buffer (same offset, union of lifetimes) — without this, a
    partial-execution concat chain would be charged K copies of the
    output tensor and the sliced schedule's savings would vanish.

    Greedy best-fit is order-sensitive: by-decreasing-size (TFLite's
    order) is optimal on conventional layer-by-layer lifetimes, but a
    cascade's ring buffers have long, irregular, *interleaved* lifetimes
    where placing a mid-sized long-lived ring after a large short-lived
    activation can strand an alignment-rounded gap that no later tensor
    fills.  ``plan`` therefore runs the same greedy under a small fixed
    set of orderings (decreasing size, increasing birth, decreasing
    lifetime length — each size-tie-broken) and keeps the smallest arena,
    preferring the earliest ordering on ties so conventional graphs keep
    their historical (by-size) placements.

    ``alignment=None`` (default) aligns offsets to the graph's widest
    element type, so every placement can be bitcast-viewed at its natural
    alignment (pure-int8 graphs plan at byte granularity, any graph with
    f32 tensors at 4 bytes)."""

    @staticmethod
    def plan(graph: Graph, schedule: Sequence[Operator],
             include_constants: bool = True,
             alignment: Optional[int] = None,
             guard_bytes: int = 0) -> ArenaPlan:
        """``guard_bytes > 0`` is the guarded-arena debug mode: every
        tensor's *footprint* is inflated by ``guard_bytes`` during greedy
        placement (and the arena gets a trailing band), so unplaced gaps —
        ``ArenaPlan.guard_regions()`` — exist next to every placement for
        the executor to fill with canaries.  Placements keep their true
        sizes; ``guard_bytes=0`` (production) is byte-identical to the
        historical planner."""
        if guard_bytes < 0:
            raise ValueError(f"guard_bytes must be >= 0, got {guard_bytes}")
        if alignment is None:
            alignment = graph.max_itemsize()
        lifetimes = tensor_lifetimes(graph, schedule, include_constants)
        alias = inplace_alias_groups(graph, schedule)
        # fold alias groups into one pseudo-tensor spanning all members
        by_rep: Dict[str, List[Tuple[str, int, int]]] = {}
        for name, s, e in lifetimes:
            by_rep.setdefault(alias.get(name, name), []).append((name, s, e))
        groups = [(rep, min(s for _, s, _ in members),
                   max(e for _, _, e in members), members)
                  for rep, members in by_rep.items()]

        def align(x: int) -> int:
            return (x + alignment - 1) // alignment * alignment

        def greedy(items: List[Tuple[str, int, int, list]]
                   ) -> Tuple[int, List[Placement]]:
            placed: List[Placement] = []
            for rep, s, e, _members in items:
                size = graph.size(rep)
                if size == 0:
                    placed.append(Placement(rep, 0, 0, s, e))
                    continue
                overlapping = [p for p in placed
                               if not (p.end < s or e < p.start)
                               and p.size > 0]
                overlapping.sort(key=lambda p: p.offset)
                # guard mode: fit against inflated footprints so every
                # placement keeps >= guard_bytes of never-placed slack
                # around it among its temporal neighbours
                foot = size + guard_bytes
                best_off, best_gap = None, None
                cursor = 0
                for p in overlapping:
                    gap = p.offset - cursor
                    if gap >= foot and (best_gap is None or gap < best_gap):
                        best_off, best_gap = cursor, gap
                    cursor = max(cursor,
                                 align(p.offset + p.size + guard_bytes))
                offset = best_off if best_off is not None else cursor
                placed.append(Placement(rep, offset, size, s, e))
            arena = max((p.offset + p.size for p in placed), default=0)
            return arena + guard_bytes if arena else arena, placed

        orders = (
            lambda it: (-graph.size(it[0]), it[1]),          # by size
            lambda it: (it[1], -graph.size(it[0])),          # by birth
            lambda it: (it[1] - it[2], -graph.size(it[0])),  # by lifetime
        )
        best_arena, best_placed = None, None
        for key in orders:
            arena, placed = greedy(sorted(groups, key=key))
            if best_arena is None or arena < best_arena:
                best_arena, best_placed = arena, placed

        offsets = {p.tensor: p.offset for p in best_placed}
        expanded: List[Placement] = []
        for rep, _s, _e, members in groups:
            shared = rep if len(members) > 1 else None
            for name, ms, me in members:
                expanded.append(Placement(name, offsets[rep],
                                          graph.size(name), ms, me,
                                          alias=shared))
        return ArenaPlan(expanded, best_arena, guard_bytes=guard_bytes)

    @staticmethod
    def validate(plan: ArenaPlan, graph: Optional[Graph] = None) -> None:
        """Overlapping lifetimes ⇒ disjoint address ranges (tensors sharing
        a buffer through an inplace chain are exempt by construction).
        With ``graph``, additionally checks every placement is aligned to
        its tensor's itemsize — the bitcast-view precondition."""
        if graph is not None:
            for p in plan.placements:
                isz = graph.itemsize(p.tensor)
                if p.offset % isz:
                    raise AssertionError(
                        f"misaligned placement: {p.tensor} "
                        f"({graph.tensors[p.tensor].dtype}, itemsize {isz}) "
                        f"at byte offset {p.offset}")
        ps = [p for p in plan.placements if p.size > 0]
        for i, a in enumerate(ps):
            for b in ps[i + 1:]:
                if a.alias is not None and a.alias == b.alias:
                    continue
                time_overlap = not (a.end < b.start or b.end < a.start)
                addr_overlap = not (a.offset + a.size <= b.offset
                                    or b.offset + b.size <= a.offset)
                if time_overlap and addr_overlap:
                    raise AssertionError(
                        f"overlap: {a.tensor} [{a.offset},{a.offset+a.size})"
                        f" steps [{a.start},{a.end}] vs {b.tensor}"
                        f" [{b.offset},{b.offset+b.size}) steps"
                        f" [{b.start},{b.end}]")


def static_plan_size(graph: Graph) -> int:
    """Footprint of the *static* strategy the paper compares against in
    Table 1 (MobileNet column): every activation tensor gets its own slot for
    the whole run — no reuse."""
    consts = set(graph.constants())
    return sum(t.size for n, t in graph.tensors.items() if n not in consts)
