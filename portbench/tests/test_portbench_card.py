"""The benchmark end to end on the card: one short run of each cell, its
result line and its checks.  Skips without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["mnv1_int8_512k.backlog",
                                      "mnv1_int8_224k.backlog"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483713", "--seconds", "3", "--trace", str(trace)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]
