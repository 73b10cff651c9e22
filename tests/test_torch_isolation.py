"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no file of it (nor ``chip_smoke.py``) imports either, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.deploy as deploy
from repro_torch.configs import get_config
from repro_torch.errors import DeviceInitError
from repro_torch.graphs import mobilenet_v1_graph, quantize_graph
from repro_torch.launch import serve as launch_serve
from repro_torch.mcu import MicroInterpreter
from repro_torch.mcu.compile import compile_schedule
from repro_torch.models import init_params
from repro_torch.serving import GraphServingEngine, ServingEngine

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_the_reference_out():
    code = ("import sys, repro_torch, repro_torch.deploy, "
            "repro_torch.mcu.compile, repro_torch.params, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.launch.serve\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = mobilenet_v1_graph(0.25, 96)
    with pytest.raises(DeviceInitError, match="device='cpu'"):
        deploy.build(g)
    with pytest.raises(DeviceInitError):
        deploy.build(g, device="cuda")
    with pytest.raises(DeviceInitError):
        compile_schedule(g)
    with pytest.raises(DeviceInitError):
        quantize_graph(g)
    with pytest.raises(DeviceInitError):
        GraphServingEngine(g)
    with pytest.raises(DeviceInitError, match="device='cpu'"):
        MicroInterpreter(g)
    cfg = get_config("llama3.2-3b@smoke")
    with pytest.raises(DeviceInitError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(DeviceInitError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(DeviceInitError, match="device='cpu'"):
        launch_serve.main(["--arch", "llama3.2-3b@smoke", "--requests", "1"])
