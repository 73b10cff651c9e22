"""``repro_torch.deploy`` — the one-call deployment facade.

``build()`` is the chain schedule → plan → validate → compile as one call
returning a ``Deployment``::

    import repro_torch.deploy as deploy

    d = deploy.build(graph, quantize=True, arena_budget=512 * 1024)
    out = d.run(d.quantize_inputs(x))     # one request, on the card
    outs = d.serve(requests)              # micro-batched engine
    eng = d.engine(micro_batch=4, replicas=0)   # sharded, every device
    d.stats.arena_bytes                   # typed, not stringly-keyed

``device=None`` means the card; without CUDA that raises
``DeviceInitError`` unless the caller passes ``device="cpu"``.  There is
no ``use_pallas`` knob: on the card the int8 convolutions always run on
the Hopper kernels, on the CPU on their plain versions.

``quantize=True`` accepts a *float* graph and post-training-quantizes it
first (``graphs/quantize.py``); the deployment carries the
``QuantizedModel`` so callers can ``d.quantize_inputs(...)`` /
``d.dequantize_outputs(...)`` at the edges while ``run``/``serve`` keep
the int8 dtype contract inside.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ArenaPlanner, schedule as _schedule
from repro_torch.core.allocator import ArenaPlan
from repro_torch.core.graph import Graph, Operator
from repro_torch.core.scheduler import ScheduleResult
from repro_torch.device import resolve_device
from repro_torch.errors import (BudgetUnreachableError, DeploymentError,
                                InputValidationError, NaNActivationError)
from repro_torch.mcu.compile import CompiledExecutor, compile_schedule

# Graph dtype name -> the numpy dtype a request must carry (bfloat16 has
# no numpy dtype and is not checked here).
_NP_DTYPES = {
    "int8": np.int8, "uint8": np.uint8, "int16": np.int16,
    "float16": np.float16, "int32": np.int32, "float32": np.float32,
}

# Graceful-degradation ladder (strict=False): each entry is the rung set
# handed to ``core.schedule(rungs=...)``; ``None`` = the full ladder.  When
# a rung set fails (a rewrite crashes, a plan fails validation, a lowering
# refuses to compile), build() drops to the next entry — progressively
# disabling the most intricate rewrites first (2-D tiles, then ring
# cascades, then whole-externals Pex) until only plain reordering is left.
_FALLBACK_RUNGS: Tuple[Optional[Tuple[str, ...]], ...] = (
    None,
    ("reorder", "pex", "cascade", "solver"),
    ("reorder", "pex", "solver"),
    ("reorder",),
)


@dataclasses.dataclass
class Deployment:
    """A graph scheduled, planned, validated and compiled — ready to run.

    ``graph`` is the graph the caller handed in; ``exec_graph`` is the one
    the schedule's operators belong to (a Pex/cascade rewrite, or the int8
    rewrite under ``quantize=True``).  ``plan`` is the validated arena
    plan the executor runs against, on ``executor.device``.
    """

    graph: Graph
    exec_graph: Graph
    schedule_result: ScheduleResult
    plan: ArenaPlan
    executor: CompiledExecutor
    qmodel: Optional[object] = None       # QuantizedModel when quantize=True
    # what build(strict=False) gave up on — [] means nothing degraded
    degraded: List[str] = dataclasses.field(default_factory=list)
    guard_bytes: int = 0                  # canary width planned (0 = off)

    @property
    def schedule(self) -> List[Operator]:
        return self.schedule_result.schedule

    @property
    def arena_bytes(self) -> int:
        return int(self.plan.arena_size)

    # ------------------------------------------------------------ validation
    def validate_inputs(self, inputs: Dict[str, Any]) -> None:
        """Reject malformed request inputs with a typed
        ``InputValidationError`` before they reach the arena: name, shape,
        dtype and finiteness (a float64 image is refused, not cast; a
        right-sized wrong shape is refused, not flattened)."""
        g = self.executor.graph
        if not isinstance(inputs, dict):
            raise InputValidationError(
                f"inputs must be a dict of tensor name -> array, got "
                f"{type(inputs).__name__}")
        needed = {c for c in g.constants() if g.consumers(c)}
        missing = needed - set(inputs)
        if missing:
            raise InputValidationError(
                f"missing graph inputs: {sorted(missing)}")
        for name, value in inputs.items():
            if name not in g.tensors:
                raise InputValidationError(
                    f"unknown input tensor {name!r}; graph inputs are "
                    f"{sorted(needed)}")
            if g.producer(name) is not None:
                raise InputValidationError(
                    f"{name!r} is produced by operator "
                    f"{g.producer(name).name!r}, not a graph input")
            t = g.tensors[name]
            val = np.asarray(value)
            want = _NP_DTYPES.get(t.dtype)
            if want is not None and val.dtype != np.dtype(want):
                hint = ""
                if t.dtype == "int8":
                    hint = (" — int8 graphs take quantized inputs in "
                            "[-128, 127]; use d.quantize_inputs(...) at "
                            "the float edge")
                raise InputValidationError(
                    f"input {name!r} is {val.dtype}, graph declares "
                    f"{t.dtype}{hint}")
            shape = tuple(t.shape) if t.shape else (t.elements,)
            if tuple(val.shape) != shape and val.size == t.elements:
                raise InputValidationError(
                    f"input {name!r} has shape {tuple(val.shape)}, graph "
                    f"declares {shape} (same element count — refusing the "
                    f"silent flatten)")
            if val.size != t.elements:
                raise InputValidationError(
                    f"input {name!r} has {val.size} elements, graph "
                    f"declares {t.elements} (shape {shape})")
            if val.dtype.kind == "f" and not np.isfinite(val).all():
                raise InputValidationError(
                    f"input {name!r} contains non-finite values (NaN/Inf "
                    f"poison every downstream activation)")

    # ------------------------------------------------------------- running
    def run(self, inputs: Dict[str, Any], as_numpy: bool = True, *,
            validate: bool = True, faults=None) -> Dict[str, Any]:
        """One request through the arena program's compiled form ``fn``
        (a CUDA graph on the card, ``execute`` on the CPU).

        ``validate=True`` (default) runs ``validate_inputs`` first.
        ``faults`` (a ``serving.FaultPlan`` or ``FaultInjector``; test-only)
        exercises the one-shot path under the engines' fault taxonomy:
        transient device errors are retried, corruption is surfaced by the
        guard canaries (``GuardViolation``) and NaN poison by a genuine
        output scan (``NaNActivationError``) — never returned as an
        answer."""
        if validate:
            self.validate_inputs(inputs)
        ex = self.executor
        if faults is None:
            return ex.run(inputs, as_numpy=as_numpy)
        from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                                dispatch_with_retry)
        inj = FaultInjector(faults) if isinstance(faults, FaultPlan) \
            else faults
        arena, _retried, _trips = dispatch_with_retry(
            lambda: ex.fn([inputs]), faults=inj)
        a = arena[0].cpu().numpy().copy()   # faults touch a host copy only
        if inj.corrupt_lanes(1):
            inj.corrupt_arena(a, ex.guard_regions)
        ex.verify_guards(a)                    # raises GuardViolation
        if inj.nan_lanes(1):
            inj.inject_nan(a, ex)
        out = ex.outputs_from(a, as_numpy=True)
        for name, val in out.items():
            if val.dtype.kind == "f" and np.isnan(val).any():
                raise NaNActivationError(
                    f"output {name!r} contains NaN activations")
        return out

    def serve(self, requests: Sequence[Dict[str, Any]], *,
              micro_batch: int = 8) -> List[Dict[str, Any]]:
        """Micro-batched one-shot serve on the deployment's device."""
        return self.engine(micro_batch=micro_batch).serve(requests)

    def engine(self, *, micro_batch: int = 8, replicas: Optional[int] = None,
               **kw):
        """A serving engine over this deployment.  ``replicas=None`` gives
        the single-device micro-batching ``GraphServingEngine``
        (dispatching through ``batched_fn(micro_batch)``); any other value
        the sharded continuous-batching ``ShardedServingEngine`` with
        ``micro_batch`` lanes a replica (``replicas=0`` = one replica per
        device of the deployment's kind)."""
        if replicas is None:
            from repro_torch.serving.engine import GraphServingEngine
            return GraphServingEngine(deployment=self,
                                      micro_batch=micro_batch, **kw)
        from repro_torch.serving.sharded import ShardedServingEngine
        return ShardedServingEngine(self, replicas=replicas or None,
                                    lanes=micro_batch, **kw)

    # ------------------------------------------------------------- stats
    @property
    def stats(self):
        """Deployment-level ``EngineStats`` (schedule/arena fields; the
        serve-level fields belong to an engine's ``.stats``)."""
        from repro_torch.serving.stats import EngineStats
        return EngineStats(
            arena_bytes=self.arena_bytes,
            schedule_peak_bytes=int(self.schedule_result.peak),
            schedule_method=self.schedule_result.method)

    # --------------------------------------------------- quantized edges
    def quantize_inputs(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        if self.qmodel is None:
            return inputs
        return self.qmodel.quantize_inputs(inputs)

    def dequantize_outputs(self, outputs: Dict[str, Any]) -> Dict[str, Any]:
        if self.qmodel is None:
            return outputs
        return self.qmodel.dequantize_outputs(outputs)


def build(graph: Graph, *, arena_budget: Optional[int] = None,
          quantize: bool = False, calibration=None,
          objective: str = "memory", partition: bool = False,
          macs_cap: Optional[float] = None, strict: bool = True,
          guard_bytes: int = 0, device=None,
          **schedule_opts) -> Deployment:
    """schedule → plan → validate → compile, one call.

    * ``device`` — where the arena program runs: None (default) is the
      card, ``"cpu"`` the plain path.  Without CUDA, None raises
      ``DeviceInitError`` before any work.
    * ``arena_budget`` — target arena bytes; the scheduler escalates
      reorder → Pex → cascaded streaming until it fits.  ``strict=True``
      (default) raises ``BudgetUnreachableError`` on a miss;
      ``strict=False`` deploys best-effort with the miss recorded in
      ``Deployment.degraded``.
    * ``quantize`` — post-training-quantize a float graph to int8 first
      (``calibration``: input dict(s); default = deterministic synthetic),
      calibrating on ``device``.
    * ``objective`` — ``"memory"`` (lowest peak) or ``"latency"``
      (cheapest in-budget schedule; needs ``arena_budget``).
    * ``macs_cap`` — max halo-recompute extra-MACs fraction.
    * ``strict=False`` — graceful degradation down ``_FALLBACK_RUNGS``
      (cascade2d → cascade → pex → reorder) instead of raising; only when
      every rung set fails does ``DeploymentError`` escape.
    * ``guard_bytes`` — debug mode: plan canary-filled slack around every
      placement and verify it after each run (``GuardViolation``).
    * extra keyword arguments are forwarded to ``core.schedule()``.
    """
    dev = resolve_device(device)
    qmodel = None
    if quantize:
        from repro_torch.graphs import quantize_graph
        qmodel = quantize_graph(graph, calibration, device=dev)
        graph = qmodel.graph

    # one attempt = the full schedule → plan → validate → compile chain for
    # one rung set; any failure inside is that rung set's failure
    def attempt(rungs):
        res = _schedule(graph, arena_budget=arena_budget,
                        partition=partition, objective=objective,
                        macs_cap=macs_cap,
                        **(schedule_opts if rungs is None
                           else {**schedule_opts, "rungs": rungs}))
        eg = res.graph if res.graph is not None else graph
        plan = ArenaPlanner.plan(eg, res.schedule, guard_bytes=guard_bytes)
        ArenaPlanner.validate(plan, eg)
        ex = compile_schedule(eg, res.schedule, plan, device=dev)
        return res, eg, plan, ex

    ladder = (_FALLBACK_RUNGS if "rungs" not in schedule_opts
              else (schedule_opts.pop("rungs"),))
    degraded: List[str] = []
    res = None
    if strict:
        res, exec_graph, plan, executor = attempt(ladder[0])
    else:
        for rungs in ladder:
            try:
                res, exec_graph, plan, executor = attempt(rungs)
                break
            except Exception as e:       # noqa: BLE001 — each rung may fail
                tag = "full ladder" if rungs is None else "+".join(rungs)
                degraded.append(f"rung set [{tag}] failed: "
                                f"{type(e).__name__}: {e}")
        if res is None:
            raise DeploymentError(
                "every scheduler rung set failed — nothing left to degrade "
                "to:\n  " + "\n  ".join(degraded))
    if arena_budget is not None and plan.arena_size > arena_budget:
        miss = (f"arena budget missed: need {int(plan.arena_size)} B > "
                f"budget {int(arena_budget)} B (best rung: {res.method})")
        if strict:
            raise BudgetUnreachableError(
                miss + " — pass strict=False to deploy best-effort")
        degraded.append(miss)
    return Deployment(graph=graph, exec_graph=exec_graph,
                      schedule_result=res, plan=plan, executor=executor,
                      qmodel=qmodel, degraded=degraded,
                      guard_bytes=guard_bytes)


__all__ = ["Deployment", "build"]
