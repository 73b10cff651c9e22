"""Micro-interpreter simulator (paper §4), on PyTorch tensors.

Executes a scheduled computation graph the way the paper's modified
TensorFlow-Lite-Micro interpreter does:

* tensors live in one contiguous SRAM arena managed by the paper's
  ``DynamicAllocator`` (first-fit + compact-to-front defrag after every op);
* a tensor's buffer is reclaimed as soon as its last consumer has executed;
* C/C++-style "no stale pointers" is modelled by resolving every tensor's
  arena offset immediately before each operator runs;
* numerics are the operator ``fn``s, so we can assert bit-identical outputs
  across schedules — the paper's property that reordering "does not change
  the architecture or the output of a neural network".

Two extensions support partial-execution (Pex-style) sliced schedules:

* operators marked ``inplace`` (the incremental ``pex_concat`` that writes a
  slice into the shared output buffer) reuse the dying input's block via
  ``DynamicAllocator.rename`` instead of allocating a second copy of the
  output — matching ``Graph.live_sets``'s accounting;
* ``run(..., plan=ArenaPlan)`` executes against precomputed offsets (the §6
  offline planner) instead of the dynamic allocator, reporting the plan's
  high-water mark so callers can cross-check it against ``plan.arena_size``.

The report carries the paper's measurables: peak SRAM usage (arena
high-water), defrag traffic (latency/energy-overhead proxy), and whether the
model fits a given SRAM capacity.  The memory model is numpy, copied from
the reference, so these are the reference's numbers to the byte.

Where the numerics run: ``device`` (None = the card; without CUDA that is
``DeviceInitError``, ``"cpu"`` runs on the host).  Inputs are moved there
and each ``fn`` runs on device tensors — on the card the int8 convs are the
Hopper kernels K1–K3.  The Pex rewrite's own ops (``pex_slice``,
``pex_concat``, ``pex_ring_push``, ``pex_ring_read``) have numpy closures
(``core/partition.py``): for those kinds only, the interpreter hands the
``fn`` host arrays and moves its result back to the device.  ``outputs``
come back as numpy arrays, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.allocator import ArenaPlan, DynamicAllocator
from repro_torch.core.graph import Graph, Operator, inplace_candidates
from repro_torch.device import resolve_device
from repro_torch.mcu.compile import TORCH_DTYPES

# kinds whose fn is a numpy closure of the partition rewrite
HOST_KINDS = frozenset({"pex_slice", "pex_concat", "pex_ring_push",
                        "pex_ring_read"})


@dataclasses.dataclass
class InterpreterReport:
    peak_sram: int
    bytes_moved: int
    defrag_passes: int
    steps: int
    wall_time_s: float
    fits: Optional[bool] = None
    outputs: Optional[Dict[str, Any]] = None


class MicroInterpreter:
    def __init__(self, graph: Graph, capacity: Optional[int] = None,
                 defragment: bool = True, device=None):
        self.graph = graph
        self.capacity = capacity
        self.defragment = defragment
        self.device = resolve_device(device)

    def _call(self, op: Operator, args):
        if op.kind in HOST_KINDS:
            out = op.fn(*[a.cpu().numpy() for a in args])
            return torch.from_numpy(np.ascontiguousarray(out)).to(self.device)
        return op.fn(*args)

    def run(self, inputs: Dict[str, Any],
            schedule: Optional[Sequence[Operator]] = None,
            keep_outputs: bool = True,
            plan: Optional[ArenaPlan] = None) -> InterpreterReport:
        g = self.graph
        sched = list(schedule) if schedule is not None else g.default_schedule()
        if not g.is_valid_schedule(sched):
            raise ValueError("invalid schedule")
        # the dynamic allocator compacts buffers, so mixed-dtype graphs
        # need offsets aligned to the widest itemsize to stay
        # dereferenceable (pure-int8/f32 graphs are unaffected: every
        # size is already a multiple of the single itemsize)
        alloc = (DynamicAllocator(self.capacity,
                                  alignment=g.max_itemsize())
                 if plan is None else None)
        offsets: Dict[str, tuple] = {}
        if plan is not None:
            offsets = {p.tensor: (p.offset, p.size) for p in plan.placements}
        live_planned: Dict[str, int] = {}   # tensor -> offset+size
        planned_peak = 0
        buffers: Dict[str, Any] = {}

        # reference counts: uses of each tensor by the remaining schedule,
        # graph outputs pinned
        uses: Dict[str, int] = {}
        for op in sched:
            for i in op.inputs:
                uses[i] = uses.get(i, 0) + 1
        for o in g.outputs:
            uses[o] = uses.get(o, 0) + 1

        def planned_alloc(name: str) -> None:
            nonlocal planned_peak
            if name not in offsets:
                raise KeyError(f"{name!r} missing from the arena plan")
            off, size = offsets[name]
            live_planned[name] = off + size
            planned_peak = max(planned_peak, max(live_planned.values()))
            if self.capacity is not None and planned_peak > self.capacity:
                raise MemoryError(
                    f"arena overflow at {name!r}: planned high water "
                    f"{planned_peak} exceeds capacity {self.capacity}")

        # network inputs occupy SRAM from the start (paper Fig. 2: tensor 0)
        for name, value in inputs.items():
            if g.producer(name) is not None:
                raise ValueError(f"{name!r} is not a graph input")
            declared = g.tensors[name].dtype
            value = torch.as_tensor(value)
            if value.dtype != TORCH_DTYPES[declared]:
                raise ValueError(
                    f"input {name!r} is {value.dtype}, graph declares "
                    f"{declared} (quantize inputs for int8 graphs)")
            if alloc is not None:
                alloc.alloc(name, g.size(name))
            else:
                planned_alloc(name)
            buffers[name] = value.to(self.device)

        t0 = time.perf_counter()
        for op in sched:
            # resolve current addresses (no stale pointers across defrags)
            args = [buffers[i] for i in op.inputs]
            # an inplace op whose dying, size-matched input can donate its
            # buffer (partial execution's shared output buffer)
            donor: Optional[str] = None
            if op.attrs.get("inplace"):
                for i in inplace_candidates(op):
                    if (g.producer(i) is not None
                            and g.size(i) == g.size(op.output)
                            and uses[i] - op.inputs.count(i) <= 0):
                        donor = i
                        break
            if alloc is not None:
                if donor is None:
                    alloc.alloc(op.output, g.size(op.output))
            else:
                planned_alloc(op.output)
            if op.fn is None:
                raise ValueError(f"operator {op.name!r} has no semantics")
            buffers[op.output] = self._call(op, args)
            # reclaim inputs whose last consumer just ran
            for i in set(op.inputs):
                uses[i] -= op.inputs.count(i)
                if uses[i] <= 0:
                    if alloc is not None:
                        if i == donor:
                            alloc.rename(i, op.output)
                        else:
                            alloc.free(i)
                    else:
                        live_planned.pop(i, None)
                    del buffers[i]
            if uses.get(op.output, 0) <= 0:   # dead output (shouldn't happen)
                if alloc is not None:
                    alloc.free(op.output)
                else:
                    live_planned.pop(op.output, None)
                del buffers[op.output]
            if alloc is not None and self.defragment:
                alloc.defragment()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0

        outs = {o: buffers[o].cpu().numpy() for o in g.outputs} \
            if keep_outputs else None
        peak = alloc.stats.peak_bytes if alloc is not None else planned_peak
        fits = (peak <= self.capacity
                if self.capacity is not None else None)
        return InterpreterReport(
            peak_sram=peak,
            bytes_moved=alloc.stats.bytes_moved if alloc is not None else 0,
            defrag_passes=(alloc.stats.defrag_passes
                           if alloc is not None else 0),
            steps=len(sched),
            wall_time_s=wall,
            fits=fits,
            outputs=outs,
        )


__all__ = ["HOST_KINDS", "InterpreterReport", "MicroInterpreter"]
