"""A CNN with squeeze-and-excite blocks (MobileNetV3-Large's) deployed as
the port's arena program and served.

Everything but three things is ``cnn_residual``'s (and so ``cnn_arena``'s):
the set-up, the closed backlog, the trace, the adds and the check against
the reference.  The three:

* the layer matcher takes the channel scale too: the port's ``mul`` is
  the reference's ``mul`` layer, which reads the map and its gate.  The
  matcher reads ``cnn_residual``'s module-level ``KINDS``, so this system
  runs a copy of that module of its own (``_own_residual``), with the
  scale in its copy's ``KINDS``, and the residual cell's matcher is left
  as it is;
* the executed schedule's channel scales are counted
  (``harness/scales.py``) for the ``scale_*`` metrics, and the launches of
  K10 (``qscale``, their kernel) over the traced stretch are kept apart
  from the other kernels' (``scale_launches``), as K9's are:
  ``data/kernel_kinds.json`` names neither ``qadd_kernel`` nor
  ``qscale_kernel``, so ``launches_per_dispatch`` holds the others against
  the trace, and ``scale_launches_per_dispatch`` holds K10's against the
  trace itself;
* the notes add the table activations, channel scales and 5x5 depthwise
  convolutions of a dispatch, and the launches of K1–K3 with the table
  epilogue a dispatch (``table_launches``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
import time

import torch

from portbench.harness import scales, spec, traffic


def _own_residual():
    """``systems/cnn_residual.py`` loaded again under a name of this
    system's, its layer matcher's kinds widened with the channel scale in
    the copy alone."""
    key = "portbench.systems.cnn_se_residual"
    if key not in sys.modules:
        s = importlib.util.spec_from_file_location(
            key, spec.ROOT / "systems" / "cnn_residual.py")
        mod = importlib.util.module_from_spec(s)
        sys.modules[key] = mod
        try:
            s.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
        mod.KINDS = {**mod.KINDS, "mul": ("mul",)}
    return sys.modules[key]


residual = _own_residual()
arena = spec.load_module("systems", "cnn_arena")

TABLE_WRAPPERS = ("qconv1x1", "qdwconv", "qconv")


@dataclasses.dataclass
class SERecord(residual.ResidualRecord):
    scale_count: int = 0         # channel scales of one dispatch
    scale_bytes: int = 0         # bytes they move over every lane
    scale_bound_s: float = 0.0   # their bound on the card, a dispatch
    scale_launches: int = 0      # K10 launches over the traced stretch


def _table_launches():
    from repro_torch.cuda_graphs import kernel_wrappers
    w = kernel_wrappers()
    return {n: w[n].table_launches for n in TABLE_WRAPPERS}


def _note(dep) -> str:
    sched, net = dep.schedule, dep.graph.operators
    tables = sum("table" in op.attrs for op in sched)
    fives = sum(op.kind == "qdwconv" and op.attrs["k"] == 5 for op in sched)
    return (f"squeeze-and-excite: {sum(op.kind == 'qmul' for op in sched)} "
            f"channel scales, {tables} table-activated convs (the network's "
            f"{sum('table' in op.attrs for op in net)}), {fives} 5x5 "
            f"depthwise convs a lane")


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, clock=time.perf_counter) -> SERecord:
    """One run of the cell: set-up, the window, the check."""
    d = residual.Deployed(cell, seed, trace, device, clock)
    rec = d.rec = SERecord(**{f.name: getattr(d.rec, f.name)
                              for f in dataclasses.fields(d.rec)})
    s = scales.executed_scales(d.dep.exec_graph, d.dep.schedule, rec.lanes,
                               rec.peaks)
    rec.scale_count, rec.scale_bytes, rec.scale_bound_s = \
        s.count, s.bytes, s.bound_s
    rec.notes.append(_note(d.dep))
    sched = traffic.schedule(cell.traffic, seed, seconds)
    trace_s = min(arena.TRACE_SECONDS, seconds / 2) if trace else 0.0
    rec.setup_s = clock() - t_process
    tables = _table_launches()
    served = d.serve(sched, seconds, trace_s)
    moved = _table_launches()
    rec.notes.append("table epilogue launches a dispatch: " + ", ".join(
        f"{n} {(moved[n] - tables[n]) / max(len(served.steps), 1):.2f}"
        for n in TABLE_WRAPPERS))
    rec.add_launches = rec.traced_launches.pop("qadd", 0)
    rec.scale_launches = rec.traced_launches.pop("qscale", 0)
    if device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    d.check(served)
    return rec


__all__ = ["SERecord", "run"]
