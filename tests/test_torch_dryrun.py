"""The port's dry-run (``repro_torch.launch.dryrun``), the intents of
``tests/test_dryrun.py`` (its shape policy is ``test_torch_shapes.py``'s):

* the reference's slow-test combo, ``xlstm-350m × decode_32k × single
  --no-unroll``, through the CLI in a subprocess: one JSON with the
  reference's keys, 256 chips, a positive peak and a dominant term;
* what ``LocalCost`` counts, in one subprocess with a fake world of 4
  ranks on a (2, 2) mesh (a process group is started once a process):
  the decode step's layers, seen only when unrolled; the collective
  census of a hand-built redistribution; and the FLOPs of a prefill
  on each rank's shards, times the chips, against the analytic count
  and ``model_flops``;
* ``collective_bytes_from_census``' traffic rules, directly."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.roofline import (COLLECTIVES,
                                           collective_bytes_from_census)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _reference_record_keys():
    """The keys of the record the reference's ``run_combo`` writes, read
    from its source (importing it would set 512 host devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "rec":
            return {k.value for k in node.value.keys}
    raise LookupError("rec")


def test_the_slow_test_combo_writes_the_references_record(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
         "--no-unroll", "--out", str(tmp_path)], env=ENV,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == \
        ["xlstm-350m__decode_32k__single.json"]
    rec = json.loads(files[0].read_text())
    assert set(rec) == _reference_record_keys() | {"roofline_h100"}
    assert rec["chips"] == 256
    assert rec["analysis_mode"] == "scan"
    mem = rec["memory_analysis"]
    assert mem["peak_memory_in_bytes"] > 0
    assert mem["peak_memory_in_bytes"] == mem["argument_size_in_bytes"] \
        + mem["output_size_in_bytes"] + mem["temp_size_in_bytes"]
    for hw in ("roofline", "roofline_h100"):
        assert rec[hw]["dominant"] in ("compute_s", "memory_s",
                                       "collective_s")
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in COLLECTIVES)


# one rank of a fake world of 4 on a (2, 2) ("data", "model") mesh
FAKE_WORLD = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import start_fake_world
from repro_torch.models import runtime
from repro_torch.models.sharding import P, distribute
start_fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
arch = "llama3.2-3b@smoke"
for layers in (1, 2):
    for unroll in (False, True):
        runtime.UNROLL_SCANS = unroll
        _, c = dryrun.measure(arch, "decode_32k", mesh,
                              {"num_layers": layers})
        out[f"decode L{layers} {'unrolled' if unroll else 'rolled'}"] = \
            c["flops"]
runtime.UNROLL_SCANS = True
cfg, c = dryrun.measure(arch, "prefill_32k", mesh)
out["prefill"] = c["flops"]
runtime.UNROLL_SCANS = False
with FakeTensorMode():
    x = distribute(torch.zeros(8, 4), mesh, P("data", None))
    part = torch.distributed.tensor.DTensor.from_local(
        torch.zeros(8, 4), mesh, (Replicate(), Partial()))
    with dryrun.LocalCost() as cost:
        x.redistribute(mesh, (Replicate(), Replicate()))
        part.redistribute(mesh, (Replicate(), Replicate()))
out["census"] = cost.census
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    proc = subprocess.run([sys.executable, "-c", FAKE_WORLD], env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_unrolled_decode_step_counts_every_layer(fake_world):
    """Rolled, the decode step's layer stack is one operator whose body
    no dispatch-level counter sees (``models/runtime.py``); unrolled, the
    per-layer loop: the layers' FLOPs are the difference, L times one
    layer's, the rest of the step (embedding, head) the same."""
    f = fake_world
    one = f["decode L1 unrolled"] - f["decode L1 rolled"]
    two = f["decode L2 unrolled"] - f["decode L2 rolled"]
    assert one > 0
    assert two == 2 * one
    assert f["decode L2 rolled"] == f["decode L1 rolled"]


def test_the_census_prices_a_redistribution(fake_world):
    """A [8, 4] float32 Shard(0) over "data" gathered whole: one
    all-gather over 2 ranks of a 128-byte result (64 bytes received); a
    partial sum over "model" made whole: one all-reduce of 128 bytes (2 ·
    128 · 1/2 sent and received)."""
    census = [tuple(c) for c in fake_world["census"]]
    assert census == [("all_gather_into_tensor", 128, 2),
                      ("all_reduce", 128, 2)]
    got = collective_bytes_from_census(census)
    assert got["all-gather"] == 64 and got["all-reduce"] == 128
    assert got["total"] == 192


def test_prefill_flops_per_device_times_chips(fake_world):
    """Llama smoke prefill_32k (B 32 × S 32 768, L 2, d 256, 4 heads / 2
    KV heads of 64, d_ff 512, vocab 512) on (2, 2): every product splits
    evenly over the 4 ranks (batch over "data", heads, d_ff and vocab
    over "model"), so FLOPs per device × 4 is the whole step's count:

      per layer  2T·d·(H + 2K)·hd + 2T·H·hd·d + 3 · 2T·d·ff  (projections,
                 wo, SwiGLU) + 4·B·H·S²·hd (the chunked attention forms
                 every chunk's scores and products, masked or not)
      head       2·B·d·V (the last position's logits only)

    ``model_flops`` is 2·N·T with N = 1 441 792 parameters (embedding
    and head 2·V·d, and per layer the 589 824 of the products above): it
    counts the products (2·T·589 824 a layer) but neither the
    attention's S² terms (4·B·H·S²·hd = 3.52e13 a layer, 14x the
    products) nor a head at the last position only, and it counts the
    embedding lookup and a head at every position as products.  So the
    ratio is (2·(2T·589 824 + 3.52e13) + 2·B·d·V) / (2·N·T) = 24.09:
    the attention of 32 768 positions dwarfs a model of 1.4 M
    parameters."""
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b@smoke")
    B, S, d, L = 32, 32_768, cfg.d_model, cfg.num_layers
    H, K, hd, ff, V = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                       cfg.d_ff, cfg.padded_vocab)
    T = B * S
    layer = 2 * T * d * (H + 2 * K) * hd + 2 * T * H * hd * d \
        + 3 * 2 * T * d * ff + 4 * B * H * S * S * hd
    want = L * layer + 2 * B * d * V
    assert fake_world["prefill"] * 4 == want
    ratio = want / model_flops(cfg, "prefill", T)
    assert 24.0 < ratio < 24.2, ratio


@pytest.mark.parametrize("census,want", [
    ([("all-gather", 1600, 16)], {"all-gather": 1500}),
    ([("all_reduce", 100, 4)], {"all-reduce": 150}),
    ([("reduce_scatter_tensor", 10, 8)], {"reduce-scatter": 70}),
    ([("all_to_all_single", 64, 4)], {"all-to-all": 48}),
    ([("collective-permute", 9, 2)], {"collective-permute": 9}),
    ([("all_reduce", 100, 1)], {}),
])
def test_collective_bytes_from_census_follows_the_hlo_rules(census, want):
    """The reference's per-kind rules (``roofline.py:79-84``): all-gather
    result·(g−1)/g, all-reduce 2·result·(g−1)/g, reduce-scatter
    result·(g−1), all-to-all result·(g−1)/g, collective-permute result;
    a group of one moves nothing."""
    got = collective_bytes_from_census(census)
    assert got == {**{k: 0 for k in COLLECTIVES}, **want,
                   "total": sum(want.values())}
