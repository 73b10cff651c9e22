"""Serving on the port: the single-device micro-batching engine for CNN
graphs, the sharded continuous-batching engine with deadline/priority
admission, the LLM prefill + greedy-decode engine, typed stats and the
seeded fault layer.

``force_host_devices(n)`` sets how many host replicas the CPU offers to
``ShardedServingEngine`` (1 unless set), the port's counterpart of the
reference's forced host-device mesh::

    from repro_torch.serving import ShardedServingEngine, force_host_devices
    force_host_devices(3)
    eng = ShardedServingEngine(d, replicas=3, lanes=2)   # d on the CPU
"""
from repro_torch.device import force_host_devices

from .admission import AdmissionQueue, QueuedRequest, RequestError
from .engine import (GraphServingEngine, Request, RequestResult,
                     ServingEngine, kv_block_bytes)
from .faults import FaultInjector, FaultPlan, dispatch_with_retry
from .sharded import ShardedServingEngine
from .stats import EngineStats, percentile_ms

__all__ = ["AdmissionQueue", "EngineStats", "FaultInjector", "FaultPlan",
           "GraphServingEngine", "QueuedRequest", "Request", "RequestError",
           "RequestResult", "ServingEngine", "ShardedServingEngine",
           "dispatch_with_retry", "force_host_devices", "kv_block_bytes",
           "percentile_ms"]
