"""Three-term roofline model: a copy of ``src/repro/analysis/roofline.py``
(which imports no JAX) with the port's card beside the reference's TPU.

    compute    = HLO_FLOPs_per_device   / peak_FLOP/s
    memory     = HLO_bytes_per_device   / HBM_bw
    collective = collective_bytes_per_device / link_bw

All three counts are per device.  The reference reads FLOPs and bytes
from ``compiled.cost_analysis()`` of a GSPMD-partitioned module (the
per-device program); a torch program's come from a count over its trace
(``launch/dryrun.py``'s, on each rank's local shards) or, for one kernel
or one step, from its shapes.  Collective bytes are not in cost_analysis
— they are summed from the operand shapes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute in the optimized HLO text,
which is likewise the per-device program; the port's come from a census
of the collectives one rank issues (``collective_bytes_from_census``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per ICI link
    hbm_bytes: float


TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9, hbm_bytes=16e9)
# NVIDIA's H100 SXM5 data sheet: dense bf16 tensor-core peak, HBM3 rate and
# size.  NVLink 4 is 900 GB/s a card, the sum of both directions over its
# 18 links; link_bw is the 450 GB/s a card sends in one direction, what a
# ring collective's per-device bytes are timed against.
H100 = HardwareSpec("h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9, hbm_bytes=80e9)

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*(.*?)\s?"
    r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?(?:\.\d+)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_V1_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _tensor_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:                        # iota format [G,S]<=...: S devices/group
        return max(int(m.group(2)), 1)
    m = _GROUPS_V1_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    return 1


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, int]:
    """Per-device link traffic per collective kind, from the optimized HLO
    (a per-device program after SPMD partitioning).

    Post-scheduling HLO prints operands as bare names, so sizes come from
    each collective's RESULT shape(s), converted to traffic with the
    standard ring-algorithm cost models (g = replica-group size):

      all-gather          result*(g-1)/g      (bytes received per device)
      all-reduce          2*result*(g-1)/g    (reduce-scatter + all-gather)
      reduce-scatter      result*(g-1)        (operand = result*g)
      all-to-all          result*(g-1)/g
      collective-permute  result
    """
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        kind, suffix = m.group(2), m.group(3)
        if suffix == "-done":
            continue        # async pair: counted at the -start
        sizes = [_tensor_bytes(dm.group(1), dm.group(2))
                 for dm in _SHAPE_RE.finditer(m.group(1))]
        if not sizes:
            continue
        # -start ops return (operand, result[, scratch]) tuples: the logical
        # result is the largest element; plain ops may return tuples too
        # (combined collectives) -> sum, but for starts take the max.
        result_bytes = max(sizes) if suffix == "-start" else sum(sizes)
        g = _group_size(line)
        if kind == "all-gather":
            traffic = result_bytes * (g - 1) // max(g, 1)
        elif kind == "all-reduce":
            traffic = 2 * result_bytes * (g - 1) // max(g, 1)
        elif kind == "reduce-scatter":
            traffic = result_bytes * (g - 1)
        elif kind == "all-to-all":
            traffic = result_bytes * (g - 1) // max(g, 1)
        else:                                  # collective-permute
            traffic = result_bytes
        out[kind] += traffic
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


# the functional collectives a torch program issues (DTensor's
# redistributions, a mapped body's own) and the HLO kind each counts as
FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_bytes_from_census(census: Iterable[Tuple[str, int, int]]
                                 ) -> Dict[str, int]:
    """Per-device link traffic per collective kind from a census of one
    device's collectives, ``(kind, result bytes, group size)`` each (the
    port's counterpart of ``collective_bytes_from_hlo``: a dispatch mode
    takes the census as ``CommDebugMode`` counts, under DTensor's local
    ops; ``kind`` an HLO name of ``COLLECTIVES`` or a functional op's of
    ``FUNCTIONAL_KINDS``).  The same ring-algorithm rules as the HLO
    census, g the group size:

      all-gather          result*(g-1)/g
      all-reduce          2*result*(g-1)/g
      reduce-scatter      result*(g-1)
      all-to-all          result*(g-1)/g
      collective-permute  result
    """
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for kind, result_bytes, g in census:
        kind = FUNCTIONAL_KINDS.get(kind, kind)
        g = max(int(g), 1)
        if kind == "all-gather":
            traffic = result_bytes * (g - 1) // g
        elif kind == "all-reduce":
            traffic = 2 * result_bytes * (g - 1) // g
        elif kind == "reduce-scatter":
            traffic = result_bytes * (g - 1)
        elif kind == "all-to-all":
            traffic = result_bytes * (g - 1) // g
        elif kind == "collective-permute":
            traffic = result_bytes
        else:
            raise ValueError(f"not a collective: {kind!r}")
        out[kind] += traffic
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def roofline_report(*, flops: float, bytes_accessed: float,
                    collective_bytes: float,
                    hw: HardwareSpec = TPU_V5E,
                    model_flops_global: Optional[float] = None,
                    chips: int = 1) -> Dict[str, float]:
    """All inputs are per-device quantities except model_flops_global."""
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_collective = collective_bytes / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_collective)
    report = dict(terms)
    report["dominant"] = dom
    report["step_time_lb_s"] = bound
    if model_flops_global is not None:
        useful = model_flops_global / max(chips, 1)
        report["model_flops_per_device"] = useful
        report["useful_flop_fraction"] = useful / flops if flops else 0.0
        # MFU lower bound implied by the dominant term
        report["mfu_bound"] = (useful / hw.peak_flops) / bound \
            if bound > 0 else 0.0
    return report


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D (training) / 2·N·D (inference) with N = active params."""
    n = cfg.active_param_count()
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens


__all__ = ["COLLECTIVES", "FUNCTIONAL_KINDS", "H100", "HardwareSpec",
           "TPU_V5E", "collective_bytes_from_census",
           "collective_bytes_from_hlo", "model_flops", "roofline_report"]
