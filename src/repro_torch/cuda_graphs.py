"""CUDA-graph capture of the port's compiled forms, with launch accounting.

The reference compiles its main path with ``jax.jit``: the arena program
(``fn``, ``batched_fn``) and the LLM decode step are each one XLA
executable.  On the card the counterpart is one captured CUDA graph:
``capture(fn, device, what=...)`` runs ``fn`` twice on a side stream,
then records one run of it into a ``torch.cuda.CUDAGraph``, and
``CapturedGraph.replay()`` launches every kernel of that run again
without the Python that issued them.

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
"launches on the card".

**No fallback.**  A failed capture or replay raises ``CaptureError``
naming ``what`` and the operator or layer that was running (the notes the
caller attached to the exception); nothing retries eagerly.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

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
                 capture_ms: float, warmup_ms: float, what: str) -> None:
        self.graph = graph
        self.output = output
        self.launches = launches
        self.capture_ms = capture_ms
        self.warmup_ms = warmup_ms
        self.what = what
        wrappers = kernel_wrappers()
        self._bumps: List[Tuple[Any, int]] = [
            (wrappers[n], k) for n, k in launches.items() if k]

    def replay(self) -> None:
        try:
            self.graph.replay()
        except Exception as e:
            raise CaptureError(f"replay of {self.what} failed: "
                               f"{type(e).__name__}: {e}") from e
        for wrapper, k in self._bumps:
            wrapper.launches += k


def _warm_up(fn: Callable[[], Any], device: torch.device) -> None:
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)


def _record(fn: Callable[[], Any], device: torch.device):
    """(graph, fn's output) of one run of ``fn`` recorded on the card."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
            out = fn()
    return graph, out


def capture(fn: Callable[[], Any], device: torch.device, *,
            what: str) -> CapturedGraph:
    """Warm ``fn`` up and capture one run of it on ``device`` as a CUDA
    graph; ``what`` names the program in errors."""
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    try:
        _warm_up(fn, device)
    except Exception as e:
        raise CaptureError(f"warm-up of {what} failed{_where(e)}: "
                           f"{type(e).__name__}: {e}") from e
    t1 = time.perf_counter()
    before = {n: f.launches for n, f in wrappers.items()}
    try:
        graph, out = _record(fn, device)
    except Exception as e:
        raise CaptureError(f"capture of {what} failed{_where(e)}: "
                           f"{type(e).__name__}: {e}") from e
    finally:
        moved = {n: f.launches - before[n] for n, f in wrappers.items()}
        for n, f in wrappers.items():
            f.launches = before[n]
    t2 = time.perf_counter()
    return CapturedGraph(graph, out, moved, (t2 - t1) * 1e3,
                         (t1 - t0) * 1e3, what)


__all__ = ["CAPTURE_MODE", "CapturedGraph", "WARMUP_RUNS", "capture",
           "kernel_wrappers"]
