"""The train step as one captured CUDA graph: the counterpart of the
reference's ``jax.jit(make_train_step(...))`` (``launch/train.py:57``,
``examples/train_small.py:36``).

``GraphedTrainStep(step_fn, device)`` is called as the step it wraps,
``(state, batch) -> (state, metrics)``:

* **Static batch buffers.**  The first call makes one device buffer per
  batch key (``tokens``; Whisper's ``frames``; InternVL2's ``patches``);
  every call copies its batch into them.  One graph holds one shape: a
  later batch with other keys, shapes or dtypes raises ``ValueError``
  (``jit`` would retrace), and so does a batch that is not on the step's
  device (``Model.loss_fn``'s ``torch.as_tensor`` would put a copy from
  host memory into the graph).
* **Warm-ups are real steps.**  The step updates the parameters, moments
  and ``step`` in place, so it cannot be run for nothing before the
  capture: the first ``cuda_graphs.WARMUP_RUNS`` calls each run one
  eager step with that call's batch on a side stream; the next call
  records the step into a private memory pool and replays it once; every
  later call replays it.  After every call ``state.opt.step`` has
  counted it.
* **State in place.**  The graph reads and writes the first call's state
  tensors; the returned ``TrainState`` is that state, and a call with
  other tensors raises ``ValueError``.
* **Metrics copied out.**  A replay rewrites the graph's output tensors,
  so each call returns copies of ``ce``, ``aux``, ``grad_norm``,
  ``loss`` and ``lr`` (0-d tensors on the device; no host read).
* **No fallback.**  The CPU and a mesh (whose collectives go through the
  host under gloo) raise ``CaptureError`` at construction; a failed
  warm-up, capture or replay raises ``CaptureError`` naming the step
  (arch, B x S, microbatches), and nothing runs eagerly in its place.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import cuda_graphs
from repro_torch.errors import CaptureError
from repro_torch.models.sharding import is_dtensor
from .optimizer import tree_leaves
from .train import TrainState


def _capturable(device: torch.device) -> bool:
    return device.type == "cuda"


def _state_leaves(state: TrainState) -> List[torch.Tensor]:
    opt = state.opt
    return (tree_leaves(state.params) + [opt.step] + tree_leaves(opt.mu)
            + tree_leaves(opt.nu))


def _signature(batch: Dict[str, torch.Tensor]):
    return {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}


class GraphedTrainStep:
    """``step_fn`` (a ``make_train_step`` step) captured on ``device``;
    ``calls`` counts the calls, ``warmup_ms`` is the wall time of the
    warm-up calls (the card synchronised), ``capture_ms`` that of the
    recording and instantiation (None before the capture)."""

    def __init__(self, step_fn: Callable[..., Any], device) -> None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        model = getattr(step_fn, "model", None)
        self.arch = model.cfg.name if model is not None else "?"
        self.microbatches = getattr(step_fn, "microbatches", 1)
        self.what = f"the train step ({self.arch})"
        if not _capturable(device):
            raise CaptureError(f"{self.what} is captured on the card only; "
                               f"on {device} it runs eagerly "
                               f"(make_train_step)")
        if model is not None and model.mesh is not None:
            raise CaptureError(f"{self.what} on a mesh runs eagerly: its "
                               f"collectives go through the host, which a "
                               f"graph cannot hold")
        self.step_fn, self.device = step_fn, device
        self.calls = 0
        self.warmup_ms = 0.0
        self.graph: Optional[cuda_graphs.CapturedGraph] = None
        self._batch: Optional[Dict[str, torch.Tensor]] = None
        self._state: Optional[TrainState] = None
        self._leaves: Optional[List[torch.Tensor]] = None
        self._failed: Optional[str] = None

    @property
    def capture_ms(self) -> Optional[float]:
        return self.graph.capture_ms if self.graph is not None else None

    def _load(self, batch: Dict[str, Any]) -> None:
        """Copy ``batch`` into the static buffers (made at the first
        call)."""
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor) or v.device != self.device:
                where = v.device if isinstance(v, torch.Tensor) \
                    else type(v).__name__
                raise ValueError(f"{self.what}: batch[{k!r}] is on {where}; "
                                 f"the graph reads its batch on "
                                 f"{self.device}: copy it there first")
        if self._batch is None:
            B, S = batch["tokens"].shape
            self.what = (f"the train step ({self.arch}, B {B} x S {S}, "
                         f"microbatches {self.microbatches})")
            self._batch = {k: torch.empty_like(v) for k, v in batch.items()}
        elif _signature(batch) != _signature(self._batch):
            raise ValueError(f"{self.what} was captured for batch "
                             f"{_signature(self._batch)}, not "
                             f"{_signature(batch)}: one graph holds one "
                             f"shape (jit would retrace); make another "
                             f"GraphedTrainStep")
        for k, v in batch.items():
            self._batch[k].copy_(v)

    def _hold(self, state: TrainState) -> None:
        """Keep the first call's state; later calls must pass it again."""
        leaves = _state_leaves(state)
        if self._leaves is None:
            if any(is_dtensor(t) for t in leaves):
                raise CaptureError(f"{self.what}: the state holds DTensors "
                                   f"(a mesh); a sharded step runs eagerly")
            self._state, self._leaves = state, leaves
        elif len(leaves) != len(self._leaves) or any(
                a is not b for a, b in zip(leaves, self._leaves)):
            raise ValueError(f"{self.what} updates the state it was first "
                             f"called with in place; pass the state it "
                             f"returned, not other tensors")

    def _step(self):
        state, metrics = self.step_fn(self._state, self._batch)
        if any(a is not b for a, b in zip(_state_leaves(state),
                                          self._leaves)):
            raise CaptureError(f"{self.what} returned new state tensors: a "
                               f"captured step must update its state in "
                               f"place")
        return state, metrics

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        if self._failed:
            raise CaptureError(f"{self.what} could not be captured earlier "
                               f"({self._failed}); nothing runs eagerly "
                               f"in its place")
        self._load(batch)
        self._hold(state)
        if self.calls < cuda_graphs.WARMUP_RUNS:
            t0 = time.perf_counter()
            _, metrics = cuda_graphs.warm_up(self._step, self.device,
                                             what=self.what, runs=1)
            self._sync()
            self.warmup_ms += (time.perf_counter() - t0) * 1e3
        else:
            if self.graph is None:      # (torch.cuda.graph frees the
                try:                        # warm-ups' cached blocks)
                    self.graph = cuda_graphs.capture(
                        self._step, self.device, what=self.what,
                        warmup_runs=0)
                except CaptureError as e:
                    self._failed = str(e)
                    raise
            self.graph.replay()
            metrics = self.graph.output[1]
        self.calls += 1
        return self._state, {k: v.clone() for k, v in metrics.items()}


__all__ = ["GraphedTrainStep"]
