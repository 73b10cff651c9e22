"""Serving on the port: the single-device micro-batching engine for CNN
graphs, the LLM prefill + greedy-decode engine, typed stats and the seeded
fault layer."""
from .engine import (GraphServingEngine, Request, RequestResult,
                     ServingEngine, kv_block_bytes)
from .faults import FaultInjector, FaultPlan, dispatch_with_retry
from .stats import EngineStats, percentile_ms

__all__ = ["GraphServingEngine", "Request", "RequestResult", "ServingEngine",
           "kv_block_bytes", "FaultInjector", "FaultPlan",
           "dispatch_with_retry", "EngineStats", "percentile_ms"]
