"""The port's own spans: where the host time of a build and of a dispatch
goes, on the profiler's clock.

``span(name)`` opens ``torch.profiler.record_function("rt." + name)``
while ``enable()`` is in force, and otherwise returns one shared no-op
context after a single global check.  A ``record_function`` costs
microseconds even when no profiler runs (~9 us on a CPU host with torch
2.13, against ~0.4 us for the check), so the serving path pays for
spans only while someone traces it.  The spans are ``record_function``
ranges, so they land in the same ``torch.profiler`` trace as the card's
activities, on the same clock: an idle gap of the card can be put down to
the span the host was in.  Spans nest; a span's parent is the span that
encloses it.

Spans the port opens (``rt.`` + name):

* serving, once a dispatch: ``dispatch`` (``ShardedServingEngine.step``,
  also under ``GraphServingEngine``) around ``admit``, ``write_inputs``
  (``ArenaProgram``: staging the lanes' rows and their one upload),
  ``run`` (the replay and the one download), ``wait``
  (``ReplicatedProgram.finish``, on the card: the wait on the finished
  dispatch's own events) and ``read_outputs``; a step that runs ahead
  holds a second ``admit``, ``write_inputs`` and ``run``, those of the
  dispatch it launches before it waits;
  once a request, ``quantize_inputs`` (``Deployment.quantize_inputs``);
* the build: ``build`` around ``calibrate``, ``schedule`` (around one
  ``rung.<name>`` per scheduler rung that runs), ``plan`` and
  ``compile`` (``deploy.build``); ``capture`` (``ArenaProgram.capture``).

``phase(name, times)`` is a span that also adds its host seconds to
``times[name]`` whether or not spans are on: the build's phases run once,
so ``Deployment.phase_s`` keeps them always.

Counts live beside the work they count, as the kernel wrappers'
``launches`` do: ``CompiledExecutor.counters`` and the engine's own
(retries, failures and watchdog trips among them, and ``run_ahead``:
dispatches launched while an earlier one was still in flight, so
``run_ahead / dispatches`` is the share run-ahead engaged on), read
together through ``ShardedServingEngine.counters``; and the client
edge's host quantize (``kernels/host_quant``), ``quantize_int8.calls``
and ``quantize_int8.elements``, one call and the image's elements a
request ``Deployment.quantize_inputs`` quantizes (none for a float32
deployment).  Read each as a difference between two reads.  The host
quantize is not among ``cuda_graphs.kernel_wrappers()``: their launches
are the card's.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "rt."
_NO_SPAN = contextlib.nullcontext()
_enabled = False


def enable() -> None:
    """Open the port's spans from now on (until ``disable()``)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def span(name: str):
    """``record_function("rt." + name)`` while enabled, else a no-op."""
    if not _enabled:
        return _NO_SPAN
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def phase(name: str, times: Optional[Dict[str, float]]) -> Iterator[None]:
    """``span(name)``, and its host seconds added to ``times[name]``
    (always; ``times=None`` keeps no time)."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        if times is not None:
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0


__all__ = ["PREFIX", "disable", "enable", "phase", "span"]
