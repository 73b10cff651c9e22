# The paper's primary contribution: peak-memory-minimal operator scheduling
# (Liberis & Lane 2019) plus the runtime substrates built around it, and the
# same reordering over traced PyTorch programs (fx_reorder, fx_partial).
from .graph import Graph, Operator, Tensor, linear_chains
from .scheduler import ScheduleResult, minimise_peak_memory
from .heuristics import (beam_schedule, build_chains, greedy_schedule,
                         minimise_peak_memory_contracted, schedule)
from .allocator import (ArenaPlan, ArenaPlanner, DynamicAllocator, Placement,
                        inplace_alias_groups, static_plan_size,
                        tensor_lifetimes)
from .partition import (PEX_ATTR, Cascade, CascadeResult, PartitionResult,
                        Segment, SliceSpec, apply_cascade, apply_partition,
                        cascade_graph, partition_graph, plan_cascade,
                        plan_partition, sliceable_runs)
from .solver import (ParetoPoint, SolverResult, branch_and_bound_order,
                     enumerate_pex_configs, graph_macs, pareto_front,
                     segment_extra_macs, solve)
from .fx_reorder import (ReorderReport, fx_to_graph, node_bytes,
                         peak_liveness, reorder, reorder_graph_module)
from .fx_partial import partial_execute_graph_module
from . import profile

__all__ = [
    "Graph", "Operator", "Tensor", "linear_chains",
    "ScheduleResult", "minimise_peak_memory",
    "beam_schedule", "build_chains", "greedy_schedule",
    "minimise_peak_memory_contracted", "schedule",
    "ArenaPlan", "ArenaPlanner", "DynamicAllocator", "Placement",
    "inplace_alias_groups", "static_plan_size", "tensor_lifetimes",
    "PEX_ATTR", "Cascade", "CascadeResult", "PartitionResult", "Segment",
    "SliceSpec", "apply_cascade", "apply_partition", "cascade_graph",
    "partition_graph", "plan_cascade", "plan_partition",
    "sliceable_runs", "profile",
    "ParetoPoint", "SolverResult", "branch_and_bound_order",
    "enumerate_pex_configs", "graph_macs", "pareto_front",
    "segment_extra_macs", "solve",
    "ReorderReport", "fx_to_graph", "node_bytes", "partial_execute_graph_module",
    "peak_liveness", "reorder", "reorder_graph_module",
]
