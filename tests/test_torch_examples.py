"""The port's examples (``examples_torch/``) run end to end on the plain
CPU path (``--device cpu``) and print what their reference twins in
``examples/`` print: Figure 1's tables and a torch.fx reordering that
lowers the branchy program's peak; SwiftNet's int8 deployment that fits
312 KB only when reordered, bit-identical across schedules and through
the deploy facade, and the 243 KB MobileNet cascade."""
import runpy
from pathlib import Path

import torch

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


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
