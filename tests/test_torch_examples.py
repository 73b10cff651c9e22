"""The port's examples (``examples_torch/``) run end to end on the plain
CPU path (``--device cpu``) and print what their reference twins in
``examples/`` print: Figure 1's tables and a torch.fx reordering that
lowers the branchy program's peak; SwiftNet's int8 deployment that fits
312 KB only when reordered, bit-identical across schedules and through
the deploy facade, and the 243 KB MobileNet cascade; LLM serving with
its KV arena and the reordering of the decode step."""
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
