"""Typed error hierarchy for the deploy/serving failure layer.

On a microcontroller the failure modes this repo's pipeline can hit — an
out-of-bounds arena write, an unserviceable memory budget, a dispatch that
never returns — are bricked products, not stack traces.  Every failure the
runtime can *detect* therefore maps to a named exception below (or to a
typed ``serving.RequestError`` result for per-request failures that must
not tear down the engine), so callers can branch on the class instead of
parsing message strings, and the chaos suite (tests/test_chaos.py) can
assert that each injected fault resolves to exactly one of these — never a
hang, never a silent wrong answer.  DESIGN.md §12 is the policy document.

This module must stay import-light (no jax, no numpy): ``benchmarks`` and
``serving.force_host_devices`` import before jax initialises.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base class for every typed failure this package raises."""


class InputValidationError(ReproError, ValueError):
    """A request's inputs are malformed: wrong dtype (would be silently
    cast), wrong shape (would be silently flattened), non-finite values,
    out of the int8 quantization domain, or unknown/missing tensors.
    Subclasses ValueError so pre-existing ``except ValueError`` callers
    keep working."""


class BudgetUnreachableError(ReproError):
    """``deploy.build(strict=True)``: the scheduler ladder exhausted every
    rung and the best arena still exceeds ``arena_budget``.  Pass
    ``strict=False`` to deploy best-effort with the miss recorded in
    ``Deployment.degraded``."""


class DeploymentError(ReproError):
    """``deploy.build(strict=False)``: every fallback rung of the scheduler
    ladder failed — there is nothing left to degrade to."""


class GuardViolation(ReproError):
    """A canary byte between arena placements was overwritten — an
    out-of-bounds write by a lowering or a planner placement bug
    (``guard_bytes`` debug mode, DESIGN.md §12)."""


class TransientDeviceError(ReproError):
    """A dispatch failed in a way worth retrying (injected by the fault
    layer; the slot a flaky DMA/bus error would occupy on hardware)."""


class DeviceInitError(ReproError):
    """Replica-mesh/device initialisation failed.  The sharded engine
    degrades to single-device serving instead of propagating this when
    ``fallback_single_device=True`` (the default)."""


class DispatchFailedError(ReproError):
    """A dispatch kept failing after the bounded retry budget
    (``max_retries``) was spent; per-request results become typed
    ``RequestError("dispatch_failed")`` entries."""


class NaNActivationError(ReproError):
    """A float output came back NaN under fault checking — numerically
    poisoned results must never be returned as answers."""


class CaptureError(ReproError):
    """A compiled form (the arena program's ``fn``/``batched_fn``, the LLM
    engine's decode step) could not be captured as a CUDA graph or
    replayed, or holds an operator that runs host code.  The message names
    the program and the operator or layer that was running.  Nothing runs
    eagerly in its place."""


__all__ = [
    "ReproError", "InputValidationError", "BudgetUnreachableError",
    "DeploymentError", "GuardViolation", "TransientDeviceError",
    "DeviceInitError", "DispatchFailedError", "NaNActivationError",
    "CaptureError",
]
