"""CUDA-graph capture of the port's compiled forms, with launch accounting.

The reference compiles its main path with ``jax.jit``: the arena program
(``fn``, ``batched_fn``), the LLM decode step and the train step are each
one XLA executable.  On the card the counterpart is one captured CUDA
graph: ``capture(fn, device, what=...)`` runs ``fn`` twice on a side
stream, then records one run of it into a ``torch.cuda.CUDAGraph`` with
a memory pool of its own, and ``CapturedGraph.replay()`` launches every
kernel of that run again without the Python that issued them.  The train
step (``training/graphed.py``) cannot be run twice for nothing — each run
updates the parameters, moments and step in place — so it warms up on
its own calls (``warm_up``, one run each, with that call's batch) and
captures with ``warmup_runs=0``.

The two warm-up runs make every one-time call happen outside the capture:
the executor's host-to-device copies of operator constants, the kernels'
``cudaFuncSetAttribute`` calls and ``lru_cache``d launch plans, and the
library handles and workspaces.  ``fn`` must be replayable: it reads and
writes only tensors that outlive the graph (a static arena, a static KV
cache) and makes no host read of the card's data.

**Launch accounting.**  Every kernel wrapper counts its launches in
``<wrapper>.launches``, in Python.  A replay runs no Python, so
``capture`` records how far each counter moved while the run was
recorded, sets the counters back (recording launches nothing on the
card), and every ``replay()`` adds those amounts: a counter still means
"launches on the card".  The same holds for a wrapper's
``table_launches`` (K1–K3's launches with a table epilogue).

**No fallback.**  A failed capture or replay raises ``CaptureError``
naming ``what`` and the operator or layer that was running (the notes the
caller attached to the exception); nothing retries eagerly.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.errors import CaptureError

# warm-up runs before the capture (torch.cuda.graph's documentation asks
# for a few on a side stream)
WARMUP_RUNS = 2
# "global", torch's default: any call that is unsafe under capture, in any
# thread, fails it.  The kernels' cudaSetDevice, cudaFuncSetAttribute and
# cudaGetLastError run under it (H100 chip runs, chip_smoke.py).
CAPTURE_MODE = "global"


def kernel_wrappers() -> Dict[str, Any]:
    """Every kernel wrapper of the port by name, each with its
    ``launches`` counter."""
    from repro_torch.kernels.conv_pointwise import ops as pw_ops
    from repro_torch.kernels.conv_quant import ops as cq_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return {**cq_ops.KERNEL_WRAPPERS, **pw_ops.KERNEL_WRAPPERS,
            **fa_ops.KERNEL_WRAPPERS, **dec_ops.KERNEL_WRAPPERS}


def _where(e: BaseException) -> str:
    notes = getattr(e, "__notes__", None)
    return f" ({'; '.join(notes)})" if notes else ""


class CapturedGraph:
    """One captured run of ``fn``: ``output`` is what that run returned
    (tensors in the graph's memory, rewritten by every replay),
    ``launches`` the kernel launches each replay adds per wrapper,
    ``capture_ms`` the host time of the capture and instantiation,
    ``warmup_ms`` that of the warm-up runs."""

    def __init__(self, graph, output, launches: Dict[str, int],
                 capture_ms: float, warmup_ms: float, what: str,
                 table_launches: Optional[Dict[str, int]] = None) -> None:
        self.graph = graph
        self.output = output
        self.launches = launches
        self.table_launches = dict(table_launches or {})
        self.capture_ms = capture_ms
        self.warmup_ms = warmup_ms
        self.what = what
        wrappers = kernel_wrappers()
        self._bumps: List[Tuple[Any, str, int]] = [
            (wrappers[n], counter, k)
            for counter, moved in (("launches", launches),
                                   ("table_launches", self.table_launches))
            for n, k in moved.items() if k]

    def replay(self) -> None:
        try:
            self.graph.replay()
        except Exception as e:
            raise CaptureError(f"replay of {self.what} failed: "
                               f"{type(e).__name__}: {e}") from e
        for wrapper, counter, k in self._bumps:
            setattr(wrapper, counter, getattr(wrapper, counter) + k)


def _warm_up(fn: Callable[[], Any], device: torch.device,
             runs: int = WARMUP_RUNS) -> Any:
    """``runs`` runs of ``fn`` on a side stream; the last one's output."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    out = None
    with torch.cuda.stream(side):
        for _ in range(runs):
            out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def _record(fn: Callable[[], Any], device: torch.device):
    """(graph, fn's output) of one run of ``fn`` recorded on the card,
    into a private memory pool (``torch.cuda.graph`` empties the
    allocator's cache first)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                              capture_error_mode=CAPTURE_MODE):
            out = fn()
    return graph, out


def warm_up(fn: Callable[[], Any], device: torch.device, *, what: str,
            runs: int = WARMUP_RUNS) -> Any:
    """``runs`` warm-up runs of ``fn`` on a side stream of ``device``
    (the one-time calls happen there, outside any capture); returns the
    last run's output.  ``what`` names the program in errors."""
    try:
        return _warm_up(fn, device, runs)
    except Exception as e:
        raise CaptureError(f"warm-up of {what} failed{_where(e)}: "
                           f"{type(e).__name__}: {e}") from e


def capture(fn: Callable[[], Any], device: torch.device, *,
            what: str, warmup_runs: int = WARMUP_RUNS) -> CapturedGraph:
    """Warm ``fn`` up (``warmup_runs`` runs; 0 where the caller did) and
    capture one run of it on ``device`` as a CUDA graph; ``what`` names
    the program in errors."""
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    if warmup_runs:
        warm_up(fn, device, what=what, runs=warmup_runs)
    t1 = time.perf_counter()
    before = _counters(wrappers)
    try:
        graph, out = _record(fn, device)
    except Exception as e:
        raise CaptureError(f"capture of {what} failed{_where(e)}: "
                           f"{type(e).__name__}: {e}") from e
    finally:
        moved = {key: v - before[key]
                 for key, v in _counters(wrappers).items()}
        for (n, counter), v in before.items():
            setattr(wrappers[n], counter, v)
    t2 = time.perf_counter()
    return CapturedGraph(
        graph, out, {n: k for (n, c), k in moved.items() if c == "launches"},
        (t2 - t1) * 1e3, (t1 - t0) * 1e3, what,
        table_launches={n: k for (n, c), k in moved.items()
                        if c == "table_launches"})


def _counters(wrappers) -> Dict[Tuple[str, str], int]:
    """Every launch counter of the wrappers: ``launches``, and
    ``table_launches`` where a wrapper keeps one."""
    return {(n, c): getattr(f, c) for n, f in wrappers.items()
            for c in ("launches", "table_launches") if hasattr(f, c)}


__all__ = ["CAPTURE_MODE", "CapturedGraph", "WARMUP_RUNS", "capture",
           "kernel_wrappers", "warm_up"]
