"""A run is judged by what its timed path produced: a sound run is
correct, and one whose timed path is broken underneath is not — half the
batch left out, an answer altered where it is produced — nor is the
4-bit control put in the program's place."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import spec
from portbench_tiny import tiny_cell

cnn = spec.load_module("systems", "cnn_arena")
CPU = torch.device("cpu")


def _run(config="mnv1_int8_512k", traffic="backlog", seconds=0.6,
         **params):
    import time
    return cnn.run(tiny_cell(config, traffic, **params), 2**31 + 9, seconds,
                   False, CPU, time.perf_counter())


def _bad(rec):
    return sorted(c.name for c in rec.checks if not c.ok)


def test_a_sound_run_is_correct():
    rec = _run()
    assert _bad(rec) == [] and rec.failed == 0 and rec.attempted > 8
    assert rec.arena_bytes <= 46000
    assert cnn.Deployed  # the engine served with Pex slices and rings


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.mcu.compile import ArenaProgram
    call = ArenaProgram.__call__

    def half(self, requests):
        return call(self, list(requests)[:max(1, len(requests) // 2)])
    monkeypatch.setattr(ArenaProgram, "__call__", half)
    assert "answer_gap" in _bad(_run())


def test_an_answer_altered_where_produced(monkeypatch):
    from repro_torch.mcu.compile import CompiledExecutor
    read = CompiledExecutor.outputs_from

    def altered(self, arena, lane=0, as_numpy=True):
        out = read(self, arena, lane, as_numpy)
        if lane == 1:
            out = {k: v ^ np.int8(0x40) for k, v in out.items()}
        return out
    monkeypatch.setattr(CompiledExecutor, "outputs_from", altered)
    assert "answer_gap" in _bad(_run())


def test_one_value_altered_in_one_lane_of_each_ring_window(monkeypatch):
    """A fault confined to one lane of the cascade's ring windows, by one
    step of the int8 grid, still shows in the answers."""
    from repro_torch.kernels.conv_quant.ops import RingWindow
    gather = RingWindow.gather
    seen = []

    def off_by_one(self, out=None):
        out = gather(self, out)
        out[0, -1, 0, 0] = out[0, -1, 0, 0] ^ 1
        seen.append(self.n)
        return out
    monkeypatch.setattr(RingWindow, "gather", off_by_one)
    bad = _bad(_run())
    assert seen and "answer_gap" in bad


def test_an_arena_over_budget_is_not_correct():
    import time
    cell = tiny_cell("mnv1_int8_512k")
    cell.config = {**cell.config,
                   "limits": {**cell.config["limits"]}}
    rec = cnn.run(cell, 5, 0.3, False, CPU, time.perf_counter())
    assert _bad(rec) == []
    from portbench.harness import judge
    over = judge.checks(answers=np.zeros((0, 2)), images=np.zeros(0, int),
                        unanswered=0, reference=np.zeros((1, 2)),
                        program_q=[(1.0, 0)], reference_q=[(1.0, 0)],
                        arena_bytes=46001, budget=46000, lane_bytes=46001,
                        limits=cell.config["limits"])
    assert [c.name for c in over if not c.ok] == ["arena_over_budget"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(seed):
    path = Path(__file__).resolve().parents[1] / "readings.py"
    s = importlib.util.spec_from_file_location("pb_readings", path)
    readings = importlib.util.module_from_spec(s)
    s.loader.exec_module(readings)
    checks = readings.control_checks(tiny_cell("mnv1_int8_512k"),
                                     seed, CPU)
    bad = {c.name for c in checks if not c.ok}
    assert {"answer_gap", "answer_mean_gap", "scale_gap", "zp_gap"} <= bad
