"""The port's examples (``examples_torch/``) run end to end on the plain
CPU path (``--device cpu``) and print what their reference twins in
``examples/`` print: Figure 1's tables and a torch.fx reordering that
lowers the branchy program's peak; SwiftNet's int8 deployment that fits
312 KB only when reordered, bit-identical across schedules and through
the deploy facade, and the 243 KB MobileNet cascade; LLM serving with
its KV arena and the reordering of the decode step; training with
AdamW, remat and a checkpoint, through the example and through
``python -m repro_torch.launch.train``."""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"


def _run(name, capsys):
    main = runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]
    main(["--device", "cpu"])
    return capsys.readouterr().out


def test_quickstart_on_the_cpu(capsys):
    out = _run("quickstart", capsys)
    assert "default-order peak : 5,216 B" in out
    assert "optimised peak     : 4,960 B" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("fx reorder:"))
    assert "peak 3,145,728 -> 2,099,200 B" in line
    assert "torch.fx operator reordering (cpu)" in out


def test_mcu_deploy_on_the_cpu(capsys):
    out = _run("mcu_deploy", capsys)
    assert "default order fits: False" in out
    assert "optimal order fits: True" in out
    assert "outputs identical across schedules: True" in out
    assert "deploy.build(g).run(x) bit-identical: True" in out
    assert "'arena_bytes': 313344" in out
    assert "(arena plan 243.0 KB)" in out and "fits 256 KB: True" in out


def test_serve_llm_on_the_cpu(capsys):
    """The reference example's traffic and lines: the KV arena bytes of
    ``examples/serve_llm.py`` and the decode step's reordering, whose
    peak is the port's at B 4, cache 96 (the reference's 6,829,836 B
    within 32 B: tests/test_torch_decode_reorder.py)."""
    out = _run("serve_llm", capsys)
    assert "served 10 requests / 160 tokens" in out
    assert "per-request block : 0.20 MB" in out
    assert "peak arena        : 0.79 MB (4 concurrent)" in out
    assert "static (all 10)   : 1.97 MB" in out
    line = next(ln for ln in out.splitlines()
                if ln.strip().startswith("fx reorder:"))
    assert "25 ops, peak 6,829,804 -> 6,829,804 B" in line


def test_train_small_on_the_cpu(capsys, tmp_path):
    """Three steps of the reference example's model (Llama smoke at 4
    layers, d 256): its lines — parameters, steps 0 and 2 with loss,
    learning rate and gradient norm — and its checkpoint at step 3."""
    main = runpy.run_path(str(EXAMPLES / "train_small.py"))["main"]
    losses = main(["--device", "cpu", "--steps", "3", "--ckpt-dir",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b@smoke  params=2.6M" in out
    steps = re.findall(r"step +(\d+)  loss=([\d.]+)  lr=([\d.e+-]+)  "
                       r"gnorm=([\d.]+)", out)
    assert [int(s[0]) for s in steps] == [0, 2]
    assert float(steps[0][2]) == 0.0           # warm-up from lr 0
    assert len(losses) == 3 and np.isfinite(losses).all()
    f = tmp_path / "ckpt_00000003.npz"
    assert f"checkpoint: {f}" in out
    with np.load(f) as data:
        assert data["blocks/wq"].shape == (4, 256, 4, 64)


def test_the_training_launcher_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: the reference
    launcher's lines (``arch=... params=...M mesh=None``, steps 0 and 2
    with loss and gradient norm, ``saved:``) and the checkpoint it
    names."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b@smoke", "--steps", "3", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "arch=llama3.2-3b@smoke params=1.4M mesh=None"
    assert [ln.split()[1] for ln in lines[1:3]] == ["0", "2"]
    assert all(re.fullmatch(r"step +\d+ loss=[\d.]+ gnorm=[\d.]+", ln)
               for ln in lines[1:3])
    f = tmp_path / "ckpt_00000003.npz"
    assert lines[3] == f"saved: {f}" and f.exists()
