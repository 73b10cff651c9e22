"""A CNN with branches and joins (MobileNetV2's residual adds) deployed as
the port's arena program and served.

Everything but two things is ``cnn_arena``'s: the set-up, the closed
backlog, the trace and the check against the reference.  The two:

* the port's graph is matched to the reference's layers by what each
  layer reads as well as by its kind, activation and weight shape (the
  reference's layers name their inputs: a block's input is read again by
  its add);
* the executed schedule's adds are counted (``harness/adds.py``) for the
  ``add_*`` metrics, and the launches of K9 (``qadd``, the adds' kernel)
  over the traced stretch are kept apart from the other kernels'
  (``add_launches``): ``launches_per_dispatch`` holds the kernels that
  ``data/kernel_kinds.json`` names against the trace, and that file does
  not name ``qadd_kernel``, so ``add_launches_per_dispatch`` holds K9's
  launches against the trace itself.

The notes name the scheduler's rung and arena beside the configuration's
expected ones, the adds and ring operators of a dispatch, and how many
ReLU6 tensors' calibration ranges reached 6.0 (where the ceiling binds).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, List

import torch

from portbench.harness import adds, spec, traffic, work
from portbench.harness import inputs as inputs_mod
from portbench.harness.record import Record
from portbench.harness.trace import Tracer

arena = spec.load_module("systems", "cnn_arena")

# the port's operator kind -> the reference's layer kinds it may be
KINDS = {"conv": ("conv", "pw"), "dwconv": ("dw",), "add": ("add",),
         "avgpool": ("avgpool",), "fc": ("fc",)}


@dataclasses.dataclass
class ResidualRecord(Record):
    add_count: int = 0         # adds of one dispatch of the executed schedule
    add_bytes: int = 0         # bytes they move over every lane
    add_bound_s: float = 0.0   # their bound on the card, a dispatch
    add_launches: int = 0      # K9 launches over the traced stretch


def _layers_of(graph, net) -> List[Any]:
    """The port graph's operators, one per reference layer, checked to be
    the same layers reading the same tensors."""
    ops = graph.default_schedule()
    if len(ops) != len(net):
        raise ValueError(f"the port's graph has {len(ops)} operators, the "
                         f"reference {len(net)} layers")
    index = {"input": 0}          # tensor name -> the reference's index
    for i, (op, layer) in enumerate(zip(ops, net)):
        w = op.attrs.get("weight")
        reads = tuple(index.get(t, -1) for t in op.inputs)
        if (layer.kind not in KINDS.get(op.kind, ())
                or reads != layer.inputs
                or op.attrs.get("act", "") != layer.act
                or (w is not None
                    and tuple(w.shape) != layer.weight_shape)):
            raise ValueError(f"operator {op.name} ({op.kind}) is not the "
                             f"reference's layer {layer}")
        index[op.output] = i + 1
    return ops


class Deployed(arena.Deployed):
    """``cnn_arena.Deployed`` with the residual network's layer matching
    and the adds' work and readings."""

    def __init__(self, cell, seed: int, trace: bool, device: torch.device,
                 clock=time.perf_counter) -> None:
        cfg = cell.config
        self.cell, self.device, self.clock = cell, device, clock
        self.rec = ResidualRecord(cell=cell, seed=seed, device_kind=(
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu"), lanes=int(cfg["lanes"]))
        rec = self.rec
        self.ref = spec.load_module("reference", cfg["reference"])
        from repro_torch import deploy
        from repro_torch.params import apply_params
        from repro_torch.serving import ShardedServingEngine

        self.net = self.ref.layers(cfg["alpha"], cfg["resolution"],
                                   cfg["num_classes"])
        self.pool = int(cell.traffic["pool"])
        made = inputs_mod.make(
            seed, [layer.weight_shape for layer in self.net],
            [self.ref.he_std(layer) for layer in self.net], self.pool,
            cfg["resolution"], device)
        self.images = made.images.cpu().numpy()
        self.weights = made.weights_np()
        del made                           # the reference uploads again

        graph = spec.load_module("graphs", cfg["graph"]).build(
            cfg["alpha"], cfg["resolution"], cfg["num_classes"])
        ops = _layers_of(graph, self.net)
        apply_params(graph, {op.name: {"weight": w}
                             for op, w in zip(ops, self.weights) if w.size})
        calibration = [{"input": self.images[i]}
                       for i in range(int(cfg["calibration_images"]))]
        t0 = clock()
        self.dep = deploy.build(
            graph, arena_budget=int(cfg["arena_budget_bytes"]),
            quantize=True, calibration=calibration, device=device)
        rec.build_s = clock() - t0
        rec.arena_bytes = self.dep.arena_bytes
        self.engine = ShardedServingEngine(
            self.dep, replicas=int(cfg["replicas"]), lanes=rec.lanes)
        self.tracer = Tracer()
        warm = arena._Served(self.dep, self.engine, self.images,
                             range(self.pool), self.tracer, clock)
        for _ in range(arena.WARM_DISPATCHES):
            self._fill_one(warm)
        if trace:
            self.tracer.warm(lambda: self._fill_one(warm))
        self.engine.drain()
        self.sync()

        peaks = work.card_peaks(spec.data("peaks"), rec.device_kind)
        rec.peaks = peaks
        sched, exec_graph = self.dep.schedule, self.dep.exec_graph
        if peaks is not None:
            rec.work = work.executed_work(exec_graph, sched, rec.lanes, peaks)
        a = adds.executed_adds(exec_graph, sched, rec.lanes, peaks)
        rec.add_count, rec.add_bytes, rec.add_bound_s = \
            a.count, a.bytes, a.bound_s
        rec.executed_macs = work.graph_macs(exec_graph, sched)
        rec.model_macs = work.graph_macs(self.dep.graph)
        rec.notes.append(self._schedule_note(cfg))
        gc.collect()

    def _schedule_note(self, cfg) -> str:
        dep = self.dep
        kinds = [op.kind for op in dep.schedule]
        six = sum(1 for op in dep.graph.operators
                  if op.attrs.get("act") == "relu6"
                  and dep.qmodel.qparams[op.output].scale == 6.0 / 255)
        six_of = sum(1 for op in dep.graph.operators
                     if op.attrs.get("act") == "relu6")
        return (f"schedule: rung {dep.schedule_result.method} (expected "
                f"{cfg.get('schedule_rung_expected')}), arena "
                f"{dep.arena_bytes} B (expected "
                f"{cfg.get('arena_bytes_expected')}), {len(kinds)} operators"
                f" a lane: {kinds.count('qadd')} qadd, "
                f"{kinds.count('pex_ring_push')} ring pushes, "
                f"{kinds.count('pex_ring_read')} ring reads; ReLU6 ranges "
                f"that reached 6.0: {six} of {six_of}")


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, clock=time.perf_counter) -> ResidualRecord:
    """One run of the cell: set-up, the window, the check."""
    d = Deployed(cell, seed, trace, device, clock)
    sched = traffic.schedule(cell.traffic, seed, seconds)
    trace_s = min(arena.TRACE_SECONDS, seconds / 2) if trace else 0.0
    d.rec.setup_s = clock() - t_process
    served = d.serve(sched, seconds, trace_s)
    d.rec.add_launches = d.rec.traced_launches.pop("qadd", 0)
    if device.type == "cuda":
        d.rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    d.check(served)
    return d.rec


__all__ = ["Deployed", "ResidualRecord", "run"]
