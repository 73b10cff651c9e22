"""A CNN deployed as the port's arena program and served.

Set-up: the configuration's network is built as a port graph
(``graphs/<graph>.py``, through the port's graph API) and the benchmark's
weights (from the seed) go into it (``repro_torch.params.apply_params``,
which rebuilds each operator's semantics with ``op_semantics``);
``repro_torch.deploy.
build`` quantizes it on seeded calibration images, schedules it into the
configuration's arena budget, plans and compiles it; a
``ShardedServingEngine`` serves it over ``replicas x lanes``.  A few full
dispatches then capture and warm the one CUDA graph the window replays.

The window: a closed backlog.  Each request is one float32 image,
quantized by the deployment's ``quantize_inputs`` as the client submits
it, admitted by the engine at a dispatch boundary (``step``) and taken
back (``take``).

Afterwards the program's state is freed and the reference computes every
answer again from the same weights and images (``harness/judge.py``).
"""
from __future__ import annotations

import collections
import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.harness import inputs as inputs_mod
from portbench.harness import judge, spec, traffic, work
from portbench.harness.record import Record
from portbench.harness.trace import Tracer

WARM_DISPATCHES = 3
TRACE_SECONDS = 1.5           # the traced stretch closes the window
ANSWER_ROWS = 4096            # answers are kept in blocks of this many


def _layers_of(graph, net) -> List[Any]:
    """The port graph's operators, one per reference layer, checked to be
    the same layers."""
    ops = graph.default_schedule()
    kinds = {"conv": ("conv", "pw"), "dwconv": ("dw",),
             "avgpool": ("avgpool",), "fc": ("fc",)}
    if len(ops) != len(net):
        raise ValueError(f"the port's graph has {len(ops)} operators, the "
                         f"reference {len(net)} layers")
    for op, layer in zip(ops, net):
        w = op.attrs.get("weight")
        if layer.kind not in kinds.get(op.kind, ()) or (
                w is not None and tuple(w.shape) != layer.weight_shape):
            raise ValueError(f"operator {op.name} ({op.kind}) is not the "
                             f"reference's layer {layer}")
    return ops


class _Served:
    """The client and the engine: submits, dispatches and takes, with the
    benchmark's spans."""

    def __init__(self, dep, engine, images: np.ndarray, order,
                 tracer: Tracer, clock) -> None:
        self.dep, self.engine, self.images = dep, engine, images
        self.order, self.tracer, self.clock = order, tracer, clock
        self.out_name = dep.graph.outputs[0]
        self.fifo: collections.deque = collections.deque()
        self.sent = 0
        # per request, in flat lists and blocks of rows: the benchmark's own
        # bookkeeping adds no object a request for the collector to trace
        self.image_of: List[int] = []
        self.done: List[int] = []       # requests answered
        self._blocks: List[np.ndarray] = []
        self.steps: List[tuple] = []   # (start, end, requests admitted)
        self.client_s = self.take_s = 0.0

    def submit(self) -> int:
        i = self.sent
        img = self.order[i]
        t0 = self.clock()
        with self.tracer.span("client"):
            x = self.dep.quantize_inputs({"input": self.images[img]})
            rid = self.engine.submit(x)
        self.client_s += self.clock() - t0
        self.fifo.append((rid, i))
        self.image_of.append(img)
        self.sent += 1
        return i

    def step(self) -> int:
        """One dispatch; every request it admitted is taken back."""
        eng = self.engine
        before = eng.pending
        t0 = self.clock()
        with self.tracer.span("step"):
            eng.step()
        t1 = self.clock()
        admitted = before - eng.pending
        with self.tracer.span("take"):
            for _ in range(admitted):
                rid, i = self.fifo.popleft()
                try:
                    result = eng.take(rid)
                except KeyError:             # never answered
                    continue
                if isinstance(result, dict):     # else a RequestError
                    self._store(i, result[self.out_name])
        self.take_s += self.clock() - t1
        self.steps.append((t0, t1, admitted))
        return admitted

    def _store(self, i: int, value) -> None:
        """Answer ``i`` into its block; blocks are added, never copied, so
        keeping answers costs the window the same at every request."""
        value = np.asarray(value).reshape(-1)
        block, row = divmod(i, ANSWER_ROWS)
        while block >= len(self._blocks):
            self._blocks.append(np.zeros((ANSWER_ROWS, value.size),
                                         value.dtype))
        self._blocks[block][row] = value
        self.done.append(i)

    def answered(self):
        """(request indices answered, their answers), in request order."""
        idx = np.sort(np.asarray(self.done, np.int64))
        if not idx.size:
            return idx, np.zeros((0, 0), np.int8)
        return idx, np.concatenate(self._blocks)[idx]

    def rate_note(self, t0: float) -> str:
        """Requests completed in each whole second after ``t0``."""
        per: Dict[int, int] = {}
        for _, end, n in self.steps:
            per[int(end - t0)] = per.get(int(end - t0), 0) + n
        return "per second: " + " ".join(
            str(per.get(i, 0)) for i in range(max(per, default=-1) + 1))

    def host_note(self) -> str:
        n = max(len(self.steps), 1)
        return (f"host: client {1e3 * self.client_s / max(self.sent, 1):.4f}"
                f" ms a request, step "
                f"{1e3 * sum(e - s for s, e, _ in self.steps) / n:.4f} ms "
                f"and take {1e3 * self.take_s / n:.4f} ms a dispatch, "
                f"{len(self.steps)} dispatches")


def _launches() -> Dict[str, int]:
    from repro_torch.cuda_graphs import kernel_wrappers
    return {n: f.launches for n, f in kernel_wrappers().items()}


class Deployed:
    """Everything set-up made: the deployment, its engine, the inputs and
    the reference they are checked against."""

    def __init__(self, cell, seed: int, trace: bool, device: torch.device,
                 clock=time.perf_counter) -> None:
        cfg = cell.config
        self.cell, self.device, self.clock = cell, device, clock
        self.rec = Record(cell=cell, seed=seed, device_kind=(
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
        warm = _Served(self.dep, self.engine, self.images, range(self.pool),
                       self.tracer, clock)
        for _ in range(WARM_DISPATCHES):
            self._fill_one(warm)
        if trace:
            self.tracer.warm(lambda: self._fill_one(warm))
        self.engine.drain()
        self.sync()

        peaks = work.card_peaks(spec.data("peaks"), rec.device_kind)
        rec.peaks = peaks
        if peaks is not None:
            rec.work = work.executed_work(self.dep.exec_graph,
                                          self.dep.schedule, rec.lanes, peaks)
        rec.executed_macs = work.graph_macs(self.dep.exec_graph,
                                            self.dep.schedule)
        rec.model_macs = work.graph_macs(self.dep.graph)
        # what set-up left for the collector is collected in set-up, not
        # in the window's first seconds
        gc.collect()

    def _fill_one(self, served: "_Served") -> None:
        while self.engine.pending < self.engine.capacity:
            served.submit()
        served.step()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, sched, seconds: float, trace_s: float) -> "_Served":
        """One window of ``sched``; its spans and counts go to ``rec``."""
        if sched.kind != "backlog":
            raise ValueError(f"cnn_arena serves a backlog only, not "
                             f"{sched.kind!r}")
        served = _Served(self.dep, self.engine, self.images, sched.images,
                         self.tracer, self.clock)
        pauses: List[float] = []
        started: List[float] = []

        def timed(phase, info):
            if info["generation"] == 2:
                if phase == "start":
                    started.append(time.perf_counter())
                elif started:
                    pauses.append(time.perf_counter() - started.pop())
        gc.callbacks.append(timed)
        try:
            _backlog(served, sched, seconds, trace_s, self.rec)
        finally:
            gc.callbacks.remove(timed)
        self.sync()
        self.rec.notes.append(served.host_note())
        self.rec.notes.append(
            f"full collections: {len(pauses)}, longest "
            f"{1e3 * max(pauses, default=0.0):.4f} ms")
        return served

    def check(self, served: "_Served") -> None:
        """Free the program's state, then judge every answer of
        ``served`` against the reference's (``rec.checks``)."""
        cfg, rec, dep = self.cell.config, self.rec, self.dep
        answered, answers = served.answered()
        shown = np.asarray(served.image_of, np.int64)[answered]
        rec.attempted = served.sent
        rec.failed = served.sent - len(answered)
        names = ["input"] + [op.output
                             for op in dep.graph.default_schedule()]
        program_q = [(dep.qmodel.qparams[n].scale,
                      dep.qmodel.qparams[n].zero_point) for n in names]
        lane_bytes = int(dep.executor.batched_fn(rec.lanes).arena.shape[1])
        self.dep = self.engine = dep = None
        served.dep = served.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        ref, dev = self.ref, self.device
        w_dev = [torch.as_tensor(w, device=dev) for w in self.weights]
        img_dev = torch.as_tensor(self.images, device=dev)
        ranges = ref.calibrate(img_dev[:int(cfg["calibration_images"])],
                               self.net, w_dev)
        qn = ref.quantize(self.net, w_dev, ranges, bits=8)
        reference = ref.outputs(img_dev, qn).cpu().numpy()
        rec.checks = judge.checks(
            answers=answers, images=shown, unanswered=rec.failed,
            reference=reference, program_q=program_q,
            reference_q=[(q.scale, q.zero_point) for q in qn.act],
            arena_bytes=rec.arena_bytes,
            budget=int(cfg["arena_budget_bytes"]), lane_bytes=lane_bytes,
            limits=cfg["limits"])


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, clock=time.perf_counter) -> Record:
    """One run of the cell: set-up, the window, the check."""
    d = Deployed(cell, seed, trace, device, clock)
    sched = traffic.schedule(cell.traffic, seed, seconds)
    trace_s = min(TRACE_SECONDS, seconds / 2) if trace else 0.0
    d.rec.setup_s = clock() - t_process
    served = d.serve(sched, seconds, trace_s)
    if device.type == "cuda":
        d.rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    d.check(served)
    return d.rec


def _trace_on(served: _Served, rec: Record) -> None:
    served.tracer.start()
    rec.notes.append(f"traced from request {served.sent}")
    rec.traced_dispatches = len(served.steps)
    rec.traced_launches = _launches()


def _trace_off(served: _Served, rec: Record) -> None:
    served.tracer.stop()
    moved = _launches()
    rec.traced_launches = {n: moved[n] - rec.traced_launches.get(n, 0)
                           for n in moved}
    rec.traced_dispatches = len(served.steps) - rec.traced_dispatches
    rec.trace = served.tracer.summary


def _backlog(served: _Served, sched, seconds: float, trace_s: float,
             rec: Record) -> None:
    """A closed backlog: the queue is topped up to ``queue_dispatches``
    dispatches' worth before every dispatch, until the window closes."""
    eng, clock = served.engine, served.clock
    keep = sched.queue_dispatches * eng.capacity
    t0 = clock()
    t_end, t_trace = t0 + seconds, t0 + seconds - trace_s
    quiet_end = None
    while True:
        while eng.pending < keep:
            served.submit()
        now = clock()
        if now >= t_end:
            break
        if trace_s and quiet_end is None and now >= t_trace:
            quiet_end = (now, len(served.steps))
            _trace_on(served, rec)
        served.step()
    if quiet_end is not None:
        _trace_off(served, rec)
    steps = served.steps
    rec.window_s = steps[-1][1] - t0
    rec.completed = sum(n for *_, n in steps)
    rec.notes.append(served.rate_note(t0))
    q_time, q_steps = quiet_end or (steps[-1][1], len(steps))
    rec.quiet_s = q_time - t0
    rec.quiet_dispatches = q_steps
    rec.quiet_requests = sum(n for *_, n in steps[:q_steps])
    while eng.pending:                 # left queued at the close: answered
        served.step()                  # and judged, outside the window


__all__ = ["run"]
