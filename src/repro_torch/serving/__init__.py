"""Serving on the port: the single-device micro-batching engine, typed
stats and the seeded fault layer."""
from .engine import GraphServingEngine
from .faults import FaultInjector, FaultPlan, dispatch_with_retry
from .stats import EngineStats, percentile_ms

__all__ = ["GraphServingEngine", "FaultInjector", "FaultPlan",
           "dispatch_with_retry", "EngineStats", "percentile_ms"]
