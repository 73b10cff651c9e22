"""The benchmark is driven by data: a cell, a mix, a configuration and a
metric are files found by name; and BENCHMARK.json keeps to its
contract."""
import json
import re
from pathlib import Path

from portbench.harness import spec

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "dummy_cfg.json").write_text(
        json.dumps({"system": "cnn_arena", "lanes": 2}))
    (root / "traffic" / "trickle.json").write_text(
        json.dumps({"kind": "poisson", "pool": 4, "rate_per_s": 7.0}))
    (root / "metrics" / "dummy_share.x.py").write_text(
        "def read(rec):\n    return 0.5\n")
    bench = {
        "workloads": [{"name": "dummy_cfg.trickle", "config": "dummy_cfg",
                       "traffic": "trickle", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "dummy_share.x", "unit": "ratio",
                       "better": "lower", "source": "program_counter",
                       "layer": "x", "moves": "setup_s",
                       "workloads": ["dummy_cfg.trickle"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.load_spec(root) == bench
    cell = spec.find_cell("dummy_cfg.trickle", bench, root)
    assert cell.config["lanes"] == 2
    assert cell.traffic == {"kind": "poisson", "pool": 4, "rate_per_s": 7.0}
    assert [m.name for m in cell.per_layer] == ["dummy_share.x"]
    assert spec.load_module("metrics", "dummy_share.x", root).read(None) \
        == 0.5


def test_benchmark_json_keeps_its_contract():
    bench = spec.load_spec()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    checkout = ROOT.parent
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((checkout / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert (checkout / "portbench" / "reference"
                / f"{cfg['reference']}.py").exists()
        assert (checkout / "portbench" / "graphs"
                / f"{cfg['graph']}.py").exists()
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["per_layer"]:
        assert m["workloads"], m["name"]
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for name in cells:
        cell = spec.find_cell(name, bench)
        reported = {m.name for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    assert len(json.dumps(bench)) < 64 * 1024


def test_files_under_paths_are_named_from_name_characters():
    for f in ROOT.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
