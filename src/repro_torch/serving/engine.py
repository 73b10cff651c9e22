"""Serving engines on one device: micro-batched CNN graphs, and LLM
prefill + greedy decode.

``GraphServingEngine`` is ``ShardedServingEngine`` at one replica of
``micro_batch`` lanes: each micro-batch is one dispatch of the executor's
``batched_fn(micro_batch)``, staged as every dispatch is, and each answer
a copy of its lane's staged output row.  A ragged final batch's unused
lanes are pad lanes, executed but counted apart (``stats.padded_lanes``)
and never read back.  Its ``serve`` keeps the one-shot contract: one
outputs dict per request, or an exception.

``ServingEngine`` runs prefill + greedy decode over batches of LLM
requests (the reference's ``serving/engine.py:170-270``), on the card
unless ``device="cpu"``: prompts of a batch are left-padded with token 0
to the longest, a VLM gets zero patch embeddings and Whisper zero frames
beside them (``modality_stubs``, as the reference feeds its stubs), and
each admitted request owns a KV block of
``kv_block_bytes`` in an arena kept by the paper's §4 dynamic allocator
(first-fit + defragment, the L2 level of DESIGN.md §2), so the arena
statistics come out equal to the reference's.  Prefill runs eagerly.
The decode step (embedding through ``argmax``) is the counterpart of the
reference's ``jax.jit``: a ``DecodeStep`` over static buffers, one per
batch size, captured as a CUDA graph on the card and run eagerly on the
CPU; each step's tokens stay on the device until the batch ends.

The L1 level, ``analyse_decode_schedule``, is the paper's reordering of
the decode step: the step's traced form (``Model.decode_step(...,
traced=True)``: the layer stack as one operator, as the reference's scan
is one jaxpr equation) is traced by ``make_fx(functionalize(...),
tracing_mode="fake")`` — shapes only: no cache is allocated and no
kernel launched — and its aten nodes reordered by ``core.fx_reorder``.
The engine keeps the report and the reordered step.  The layer body is
not reordered, as the reference does not reorder inside its scan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import DynamicAllocator
from repro_torch.core.fx_reorder import ReorderReport, reorder_graph_module
from repro_torch.core.graph import Graph
from repro_torch.cuda_graphs import CapturedGraph, capture
from repro_torch.device import resolve_device
from repro_torch.errors import DispatchFailedError
from repro_torch.models.model import (Model, UnsupportedConfigError,
                                      init_cache)
from repro_torch.models.sharding import full
from repro_torch.serving.admission import RequestError
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.sharded import ShardedServingEngine
from repro_torch.serving.stats import EngineStats


class GraphServingEngine(ShardedServingEngine):
    """Micro-batched single-device serving of a deployed CNN graph.

    Construct from a graph (the facade runs schedule→plan→compile on
    ``device``, None = the card) or pass an existing ``deployment=``.
    ``serve`` runs micro-batches of ``micro_batch`` lanes; ``stats`` is a
    typed ``EngineStats``.  ``faults`` (a ``FaultPlan``; test-only)
    injects device faults only, each dispatch retried up to
    ``max_retries``; a plan with lane faults (``corrupt_rate``,
    ``nan_rate``) is refused.
    """

    def __init__(self, graph: Optional[Graph] = None, *,
                 deployment=None, arena_budget: Optional[int] = None,
                 partition: bool = False, micro_batch: int = 8,
                 faults=None, max_retries: int = 2,
                 dispatch_timeout: Optional[float] = None, device=None):
        if deployment is None:
            if graph is None:
                raise ValueError("need a graph or a deployment")
            from repro_torch.deploy import build
            deployment = build(graph, arena_budget=arena_budget,
                               partition=partition, device=device)
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        plan = faults.plan if isinstance(faults, FaultInjector) else faults
        if plan is not None and plan.any_lane_faults():
            raise ValueError(
                "GraphServingEngine injects device faults only; serve a "
                "plan with corrupt_rate or nan_rate through "
                "ShardedServingEngine")
        super().__init__(deployment, replicas=1, lanes=micro_batch,
                         faults=faults, max_retries=max_retries,
                         dispatch_timeout=dispatch_timeout)
        self.micro_batch = micro_batch
        self.result = deployment.schedule_result
        self.exec_graph = deployment.exec_graph
        self.plan = deployment.plan

    def serve(self, requests: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Run every request's input dict through the deployed graph;
        returns one output dict per request, in order.  Raises
        ``DispatchFailedError`` when a request ends as a ``RequestError``
        (a dispatch spent its retry budget)."""
        outs = super().serve(requests)
        for out in outs:
            if isinstance(out, RequestError):
                raise DispatchFailedError(
                    f"request {out.rid}: {out.code} ({out.detail})")
        return outs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 16


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: List[int]
    prefill_ms: float
    decode_ms: float


def kv_block_bytes(cfg: ModelConfig, cache_len: int) -> int:
    """Per-request KV/state bytes at full cache length (batch=1): the
    bytes of every entry of ``init_cache``, as the reference counts them."""
    c = init_cache(cfg, 1, cache_len, device="meta")
    return sum(t.numel() * t.element_size() for t in c.values())


def modality_stubs(cfg: ModelConfig, batch: int,
                   device) -> Dict[str, torch.Tensor]:
    """The inputs the reference's engine feeds a VLM and Whisper beside
    the tokens (``serving/engine.py:245-250``): zero ``patches`` [B,
    num_patch_tokens, frontend_dim] and zero ``frames`` [B, encoder_seq,
    frontend_dim], float32, made on ``device``."""
    stubs = {}
    if cfg.num_patch_tokens:
        stubs["patches"] = torch.zeros(
            (batch, cfg.num_patch_tokens, cfg.frontend_dim),
            dtype=torch.float32, device=device)
    if cfg.arch_type == "audio":
        stubs["frames"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.frontend_dim), dtype=torch.float32,
            device=device)
    return stubs


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeStep:
    """One greedy decode step over static buffers: ``tok`` [B] (this
    step's tokens, overwritten with the next ones) and ``cache``, the
    model's decode cache at ``cache_len`` (``pos``, and the layout's K/V
    slots, conv windows and recurrent states), updated in place.
    ``logits`` holds the last step's.  On the card the step is a CUDA
    graph, captured by ``capture()``; on the CPU it runs eagerly, and so
    it does on a mesh (the cache then placed by ``cache_specs``, the
    logits gathered on every rank: the collectives go through the host
    under gloo, which a graph cannot hold)."""

    def __init__(self, model: Model, params, batch: int, cache_len: int,
                 device: torch.device) -> None:
        self.model, self.params, self.device = model, params, device
        self.cache_len = cache_len
        self.cache = init_cache(model.cfg, batch, cache_len, device=device,
                                mesh=model.mesh)
        self.tok = torch.zeros((batch,), dtype=torch.int64, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[CapturedGraph] = None

    def _run(self) -> torch.Tensor:
        logits, _ = self.model.decode_step(self.params, self.cache,
                                           self.tok)
        logits = full(logits)
        self.tok.copy_(torch.argmax(logits, -1))
        return logits

    def capture(self) -> CapturedGraph:
        """Capture the step on the card, once (its warm-up runs scribble
        on the buffers: ``load`` them afterwards)."""
        if self.graph is None:
            B = self.tok.shape[0]
            self.graph = capture(
                self._run, self.device,
                what=f"the decode step (B {B}, cache_len "
                     f"{self.cache_len})")
            self.logits = self.graph.output
        return self.graph

    def load(self, cache, tok: torch.Tensor) -> None:
        """Copy a prefill's cache and the first tokens into the buffers
        (Whisper's cross cache too: 983 MB at B 4 for Whisper-large-v3)."""
        for name, buf in self.cache.items():
            buf.copy_(cache[name])
        self.tok.copy_(tok)

    def __call__(self) -> None:
        if self.device.type == "cuda" and self.model.mesh is None:
            self.capture().replay()
        else:
            self.logits = self._run()


class ReorderedStep:
    """The decode step's traced form with its nodes in the order the
    paper's scheduler chose: called like ``Model.decode_step(params,
    cache, tokens)``, it returns ``(logits, cache)``, ``cache`` a new dict
    with new tensors for the names in ``state`` (the model's
    ``stack_state``: ``k``/``v``, or a recurrent layout's states too;
    ``kv_pos`` and ``pos`` are updated in place)."""

    def __init__(self, gm: torch.fx.GraphModule, spec,
                 state: Tuple[str, ...]) -> None:
        self.gm, self.spec, self.state = gm, spec, state

    def __call__(self, params, cache, tokens):
        leaves, spec = pytree.tree_flatten((params, cache, tokens))
        if spec != self.spec:
            raise ValueError("the step was traced for other arguments")
        logits, *new = self.gm(*leaves)
        return logits, dict(cache, **dict(zip(self.state, new)))


def reorder_decode_step(model: Model, params, batch_size: int,
                        cache_len: int
                        ) -> Tuple[ReorderedStep, ReorderReport]:
    """Trace ``model``'s decode step (traced form) over ``params`` (on any
    device, ``"meta"`` included), a cache of ``cache_len`` slots and
    ``[batch_size]`` int64 tokens, all fake tensors on the parameters'
    device, and reorder its nodes for minimal peak liveness."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    dev = params["embed"].device
    with FakeTensorMode():
        cache = init_cache(model.cfg, batch_size, cache_len, device=dev)
        tokens = torch.zeros((batch_size,), dtype=torch.int64, device=dev)
    leaves, spec = pytree.tree_flatten((params, cache, tokens))

    def step(*xs):
        p, c, t = pytree.tree_unflatten(list(xs), spec)
        logits, new = model.decode_step(p, c, t, traced=True)
        return (logits,) + tuple(new[n] for n in model.stack_state)

    gm = make_fx(torch.func.functionalize(step),
                 tracing_mode="fake")(*leaves)
    gm, report = reorder_graph_module(gm)
    return ReorderedStep(gm, spec, model.stack_state), report


class ServingEngine:
    """Batch-mode LLM serving: prefill + greedy decode of up to
    ``max_batch`` requests at a time, with a KV block per admitted request
    in a ``DynamicAllocator`` arena (``hbm_budget`` its capacity, None =
    unbounded).  ``params`` must lie on ``device`` (None: the card).
    ``execute_reordered`` is stored and not read, as in the reference:
    serving runs the in-place step; ``analyse_decode_schedule`` keeps the
    reordered one in ``reordered_step``.

    ``mesh`` (``launch.mesh.make_local_mesh``): every rank runs the engine
    SPMD over its pieces of ``params`` (``init_params(..., mesh=)``) and
    the same requests, as the reference's engine passes its mesh to its
    model (``serving/engine.py:172-176``); the decode step runs eagerly
    and every rank gets every token.  The KV arena plans the whole
    block a request, as the reference's does."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 cache_len: int = 128, execute_reordered: bool = False,
                 hbm_budget: Optional[int] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.cfg = cfg
        self.model = Model(cfg, mesh)
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.execute_reordered = execute_reordered
        # ---- L2: KV arena (virtual device-memory bookkeeping)
        self.block_bytes = kv_block_bytes(cfg, cache_len)
        self.arena = DynamicAllocator(capacity=hbm_budget)
        self.reorder_report: Optional[ReorderReport] = None
        self.reordered_step: Optional[ReorderedStep] = None
        self.stats = EngineStats(lanes=max_batch)
        self._steps: Dict[int, DecodeStep] = {}

    # --------------------------------------------------------- L1 reorder
    def analyse_decode_schedule(self, batch_size: int) -> ReorderReport:
        """Trace the decode step of ``batch_size`` sequences at the engine's
        ``cache_len`` (shapes only), apply the paper's scheduler to its
        nodes, keep and return the liveness report; the reordered step
        goes to ``reordered_step``.  One device only: the traced step on
        a mesh is the dry-run's."""
        if self.model.mesh is not None:
            raise UnsupportedConfigError(
                "analyse_decode_schedule traces the step of one device; "
                "the engine has a mesh")
        self.reordered_step, self.reorder_report = reorder_decode_step(
            self.model, self.params, batch_size, self.cache_len)
        return self.reorder_report

    def decode_step(self, batch: int) -> DecodeStep:
        """The engine's ``DecodeStep`` for ``batch`` sequences, made (and on
        the card captured) at first use."""
        step = self._steps.get(batch)
        if step is None:
            step = DecodeStep(self.model, self.params, batch,
                              self.cache_len, self.device)
            if self.device.type == "cuda" and self.model.mesh is None:
                step.capture()
            self._steps[batch] = step
        return step

    def serve(self, requests: Sequence[Request]) -> List[RequestResult]:
        """Batch-mode serving: admit up to max_batch requests at a time.
        All prompts in a batch are right-aligned to the longest one."""
        results: List[RequestResult] = []
        pending = list(requests)
        peak_concurrent = 0
        t_start = time.perf_counter()
        latencies: List[float] = []
        n_batches = 0
        while pending:
            batch = pending[:self.max_batch]
            pending = pending[self.max_batch:]
            # L2: allocate a KV block per admitted request
            for r in batch:
                self.arena.alloc(f"req{r.rid}", self.block_bytes)
            peak_concurrent = max(peak_concurrent, len(batch))
            results.extend(self._run_batch(batch))
            n_batches += 1
            t_done = time.perf_counter()
            latencies.extend([t_done - t_start] * len(batch))
            for r in batch:
                self.arena.free(f"req{r.rid}")
            self.arena.defragment()
        wall = time.perf_counter() - t_start
        self.stats.record_serve(requests=len(requests), padded_lanes=0,
                                dispatches=n_batches, wall_s=wall,
                                latencies_s=latencies)
        self.stats.kv_arena_peak_bytes = self.arena.stats.peak_bytes
        self.stats.kv_static_bytes = self.block_bytes * len(requests)
        self.stats.peak_concurrent = peak_concurrent
        return results

    def _run_batch(self, batch: Sequence[Request]) -> List[RequestResult]:
        B = len(batch)
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(batch):       # left-pad with token 0
            toks[i, S - len(r.prompt):] = r.prompt
        feed = {"tokens": torch.as_tensor(toks, device=self.device)}
        feed.update(modality_stubs(self.cfg, B, self.device))
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, feed,
                                           cache_len=self.cache_len)
        logits = full(logits)
        _synchronize(self.device)
        t_pre = (time.perf_counter() - t0) * 1e3

        max_new = max(r.max_new_tokens for r in batch)
        step = self.decode_step(B)
        t0 = time.perf_counter()
        # the prefill's cache is copied into the step's static buffers
        step.load(cache, torch.argmax(logits, -1))
        del cache
        tokens = torch.empty((max_new, B), dtype=torch.int64,
                             device=self.device)
        tokens[0] = step.tok
        for i in range(1, max_new):
            step()
            tokens[i] = step.tok
        host = tokens.t().tolist()      # the batch's one read of tokens
        t_dec = (time.perf_counter() - t0) * 1e3
        return [RequestResult(r.rid, host[i][:r.max_new_tokens], t_pre,
                              t_dec) for i, r in enumerate(batch)]


__all__ = ["DecodeStep", "GraphServingEngine", "ReorderedStep", "Request",
           "RequestResult", "ServingEngine", "kv_block_bytes",
           "modality_stubs", "reorder_decode_step"]
