"""What the benchmark imports: never JAX or the JAX package (by top-level
name compared whole: the port's ``repro_torch`` begins with ``repro``),
and in the reference nothing of the port either."""
import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = FORBIDDEN & set(_imports(f))
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for f in sorted((ROOT / "reference").rglob("*.py")):
        names = set(_imports(f))
        assert not {"repro_torch", "portbench"} & names, (f, names)


def test_run_refuses_a_process_holding_the_jax_package(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location("pb_run", ROOT / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in run.forbidden_modules()
