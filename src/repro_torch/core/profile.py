"""Appendix-A style memory-usage reporting: per-operator working-set tables
and an ASCII usage plot, as produced by the paper's tflite-tools."""
from __future__ import annotations

from typing import Sequence

from .graph import Graph, Operator


def usage_table(graph: Graph, schedule: Sequence[Operator],
                include_constants: bool = True) -> str:
    sets = graph.live_sets(schedule, include_constants)
    rows = []
    width_op = max([len(op.name) for op in schedule] + [8])
    header = f"{'Operator':<{width_op}} | {'Tensors in RAM':<32} | Usage (B)"
    rows.append(header)
    rows.append("-" * len(header))
    peak = 0
    for op, live in zip(schedule, sets):
        usage = sum(graph.size(t) for t in live)
        peak = max(peak, usage)
        names = "{" + ", ".join(sorted(live)) + "}"
        rows.append(f"{op.name:<{width_op}} | {names:<32} | {usage:>9,}")
    rows.append("-" * len(header))
    rows.append(f"{'Peak:':<{width_op}} | {'':<32} | {peak:>9,}")
    return "\n".join(rows)


def usage_plot(graph: Graph, schedule: Sequence[Operator],
               include_constants: bool = True, width: int = 50) -> str:
    profile = graph.usage_profile(schedule, include_constants)
    peak = max(profile) if profile else 1
    lines = []
    for op, u in zip(schedule, profile):
        bar = "#" * max(1, round(u / peak * width))
        lines.append(f"{op.name:>12} |{bar:<{width}}| {u:,}")
    return "\n".join(lines)


def compare(graph: Graph, default: Sequence[Operator],
            optimised: Sequence[Operator],
            include_constants: bool = True) -> str:
    pd = graph.peak_usage(default, include_constants)
    po = graph.peak_usage(optimised, include_constants)
    saving = pd - po
    return (f"default-order peak : {pd:,} B\n"
            f"optimised peak     : {po:,} B\n"
            f"saving             : {saving:,} B ({saving / pd * 100:.1f}%)")
