"""Arithmetic the metric readers share.  Each returns None where the run
has nothing to read (no trace, no peaks for this card, no dispatch)."""
from __future__ import annotations

from typing import Optional

from . import spec
from .trace import is_copy


def idle_share(rec) -> Optional[float]:
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s


def copy_share(rec) -> Optional[float]:
    t = rec.trace
    if t is None or t.busy_s <= 0:
        return None
    return t.seconds(is_copy) / t.busy_s


def roofline(rec, kind: str) -> Optional[float]:
    """The kind's convolutions' bound over the time the kernels that run
    them took in the trace, in percent."""
    t, w = rec.trace, rec.work.get(kind)
    if t is None or w is None or not rec.traced_dispatches:
        return None
    kinds = spec.data("kernel_kinds")
    took = t.seconds(lambda name: kinds.get(name) == kind)
    if took <= 0:
        return None
    return 100.0 * w.bound_s * rec.traced_dispatches / took


def mfu(rec) -> Optional[float]:
    """The model's own operations (two per multiply-accumulate of the
    unsliced network) at the images per second of the untraced stretch,
    over the card's int8 peak, in percent."""
    if rec.peaks is None or rec.quiet_s <= 0 or not rec.quiet_requests:
        return None
    rate = rec.quiet_requests / rec.quiet_s
    return 100.0 * 2 * rec.model_macs * rate / rec.peaks["int8_ops_per_s"]


__all__ = ["copy_share", "idle_share", "mfu", "roofline"]
