"""Whether a run is correct: each number compared beside its limit.

Every answer the window produced is held against the reference's answer
for the same image; the program's quantization parameters against the
ones the reference works out from the same calibration images; the arena
the program ran on against the configuration's budget and its own plan.
The limits live in the configuration's file (``limits``) and were set
from readings of the program and of the control (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)

    def line(self) -> str:
        return (f"check {self.name} {self.value!r} <= {self.limit!r} "
                f"{'ok' if self.ok else 'FAILED'}")


def answer_gap(answers: np.ndarray, images: np.ndarray,
               reference: np.ndarray) -> float:
    """The widest gap between an answer and the reference's answer for its
    image, in units of the output's integer grid (0 with no answers)."""
    if answers.size == 0:
        return 0.0
    return float(np.abs(answers.astype(np.int64)
                        - reference[images].astype(np.int64)).max())


def answer_mean_gap(answers: np.ndarray, images: np.ndarray,
                    reference: np.ndarray) -> float:
    """The mean gap over every value of every answer (0 with no answers):
    steadier from seed to seed than the widest."""
    if answers.size == 0:
        return 0.0
    return float(np.abs(answers.astype(np.int64)
                        - reference[images].astype(np.int64)).mean())


def qparam_gaps(program: Sequence[Tuple[float, int]],
                reference: Sequence[Tuple[float, int]]) -> Tuple[float, float]:
    """(largest relative gap of a scale, largest gap of a zero point) over
    the tensors, in the same order on both sides."""
    if len(program) != len(reference):
        return float("inf"), float("inf")
    s = max(abs(p[0] - r[0]) / r[0] for p, r in zip(program, reference))
    z = max(abs(p[1] - r[1]) for p, r in zip(program, reference))
    return float(s), float(z)


def checks(*, answers: np.ndarray, images: np.ndarray, unanswered: int,
           reference: np.ndarray, program_q, reference_q, arena_bytes: int,
           budget: int, lane_bytes: int, limits: Dict[str, float]
           ) -> List[Check]:
    scale_gap, zp_gap = qparam_gaps(program_q, reference_q)
    values = {
        "answer_gap": answer_gap(answers, images, reference),
        "answer_mean_gap": answer_mean_gap(answers, images, reference),
        "unanswered": float(unanswered),
        "scale_gap": scale_gap,
        "zp_gap": zp_gap,
        "arena_over_budget": float(max(0, arena_bytes - budget)),
        "arena_lane_gap": float(abs(lane_bytes - arena_bytes)),
    }
    return [Check(name, value, float(limits[name]))
            for name, value in values.items()]


__all__ = ["Check", "answer_gap", "answer_mean_gap", "checks", "qparam_gaps"]
