"""MobileNetV3-Large on the port against its plain reference (the
benchmark's ``portbench/reference/mobilenet_v3.py``: whole tensors in
plain torch, nothing of the port), on the CPU at a small size (1.0 at
32x32, 10 classes), on seeded He-normal weights and images uniform in
[-1, 1).

Covered: the graph is the reference's network layer for layer (Table 1 at
1.0@224: 15 blocks, 8 squeeze-and-excite, 10 residual adds, 6 5x5
depthwise convs, 21 h-swish and 8 h-sigmoid convs, 216.6 M
multiply-accumulates); the float outputs; the int8 parameters, the
pre-activation ones and the tables; the int8 answers bit for bit with no
budget, under a Pex budget and under the row cascade through the residual
diamonds (at 1.0@32 a 12 000 B budget is what only that rung meets: the
first block's add reads the stem's output beside the block's branch, as
at 224), with each rung's arena; and the two faults the comparison must
catch: ReLU6 for every h-swish, and every squeeze-and-excite gate taken
as 1.  The residual rung's planning: the diamonds it merges, the cut sets
it keeps, and that MobileNetV2 never reaches it.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import deploy
from repro_torch.core.partition import (_residual_chains, _skips_streamable,
                                        run_skips, sliceable_runs)
from repro_torch.graphs import (int8_scheduling_graph, mobilenet_v2_graph,
                                mobilenet_v3_large_graph)
from repro_torch.graphs.quantize import pre_activation
from repro_torch.params import apply_params

REFERENCE = (Path(__file__).resolve().parents[1] / "portbench" / "reference"
             / "mobilenet_v3.py")
_spec = importlib.util.spec_from_file_location("plain_mobilenet_v3",
                                               REFERENCE)
plain = sys.modules["plain_mobilenet_v3"] = \
    importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

CLASSES = 10
KINDS = {"conv": ("conv", "pw"), "dwconv": ("dw",), "add": ("add",),
         "avgpool": ("avgpool",), "fc": ("fc",), "mul": ("mul",)}


def _made(net, seed, pool, res):
    """Weights (He-normal) and images from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    weights = [torch.randn(layer.weight_shape, generator=gen)
               * plain.he_std(layer) if layer.weight_shape
               else torch.empty(0) for layer in net]
    images = torch.rand((pool, res, res, 3), generator=gen) * 2.0 - 1.0
    return weights, images


def _port_graph(alpha, res, weights):
    g = mobilenet_v3_large_graph(alpha, res, CLASSES)
    apply_params(g, {op.name: {"weight": w.numpy()} for op, w in
                     zip(g.default_schedule(), weights) if w.numel()})
    return g


def _tensor_names(g):
    return ["input"] + [op.output for op in g.default_schedule()]


def test_graph_is_the_reference_network_at_table_1_size():
    """1.0@224, 1 000 classes: the port's graph and the reference's layers
    agree op for op (kind, activation, weight shape, output shape and
    which tensors each reads); Table 1's counts and widths."""
    g = mobilenet_v3_large_graph(1.0, 224, 1000)
    net = plain.layers(1.0, 224, 1000)
    ops = g.default_schedule()
    assert len(ops) == len(net) == 91
    index = {name: i for i, name in enumerate(_tensor_names(g))}
    for op, layer in zip(ops, net):
        assert layer.kind in KINDS[op.kind], (op.name, layer)
        assert op.attrs.get("act", "") == layer.act, op.name
        w = op.attrs.get("weight")
        assert (() if w is None else w.shape) == layer.weight_shape
        assert tuple(g.tensors[op.output].shape) == \
            (layer.h_out, layer.w_out, layer.cout)
        assert tuple(index[i] for i in op.inputs) == layer.inputs, op.name
    kinds = [op.kind for op in ops]
    assert (kinds.count("conv"), kinds.count("dwconv"), kinds.count("add"),
            kinds.count("mul"), kinds.count("avgpool")) == (48, 15, 10, 8, 9)
    assert sum(op.kind == "dwconv" and op.attrs["k"] == 5
               for op in ops) == 6
    acts = [op.attrs.get("act") for op in ops]
    assert (acts.count("hswish"), acts.count("hsigmoid"),
            acts.count("none")) == (21, 8, 15)
    # the squeezes: make_divisible(exp / 4), as the published code rounds
    assert [op.attrs["weight"].shape[-1] for op in ops
            if op.attrs.get("act") == "relu"
            and g.tensors[op.output].shape[:2] == (1, 1)] == \
        [24, 32, 32, 120, 168, 168, 240, 240]
    # 216 589 760 multiply-accumulates (Table 3: 219 M), 5 451 272 weights
    assert plain.model_macs(net) == 216_589_760
    assert sum(op.attrs["weight"].size for op in ops
               if "weight" in op.attrs) == 5_451_272
    # 597 408 gated elements and 1 511 264 h-swish outputs an image
    assert sum(g.tensors[op.output].elements for op in ops
               if op.kind == "mul") == 597_408
    assert sum(g.tensors[op.output].elements for op in ops
               if op.attrs.get("act") == "hswish") == 1_511_264


def test_float_outputs_match_the_reference():
    """The f32 arena program against the reference's float pass, within
    1e-5 of the largest output: float32 summation order (K6's plain
    version is a matmul, the reference's 1x1 convs are conv2d)."""
    net = plain.layers(1.0, 32, CLASSES)
    weights, images = _made(net, 11, 2, 32)
    g = _port_graph(1.0, 32, weights)
    dep = deploy.build(g, device="cpu")
    want = plain.float_forward(images, net, weights)[-1].reshape(2, -1)
    got = np.stack([dep.run({"input": images[i].numpy()})[g.outputs[0]]
                    .reshape(-1) for i in range(2)])
    scale = float(want.abs().max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=1e-5 * scale)


def _int8(budget, seed=5):
    net = plain.layers(1.0, 32, CLASSES)
    weights, images = _made(net, seed, 6, 32)
    g = _port_graph(1.0, 32, weights)
    calib = [{"input": images[i].numpy()} for i in range(4)]
    dep = deploy.build(g, arena_budget=budget, quantize=True,
                       calibration=calib, device="cpu")
    return dep, net, weights, images


def _answers(dep, images):
    out = dep.graph.outputs[0]
    return np.stack([dep.run(dep.quantize_inputs(
        {"input": images[i].numpy()}))[out].reshape(-1)
        for i in range(images.shape[0])])


# (budget, arena bytes, rung the scheduler took)
BUDGETS = {
    "none": (None, 20_480, "greedy"),
    "pex": (15_000, 12_800, "greedy+pex"),
    "rescascade": (12_000, 10_752, "greedy+rescascade"),
}


@pytest.mark.parametrize("which", list(BUDGETS))
def test_int8_answers_are_the_references(which):
    """Same weights and calibration images: the port's qparams (the
    pre-activation ones too) and tables are the reference's, and every
    int8 answer equals the reference's, whole and under each budget (Pex
    slices, the row cascade through the residual diamonds, whose adds
    read the stem's and the blocks' outputs beside their branches)."""
    budget, arena, rung = BUDGETS[which]
    dep, net, weights, images = _int8(budget)
    assert (dep.arena_bytes, dep.schedule_result.method) == (arena, rung)
    assert dep.schedule_result.notes == ()
    ranges = plain.calibrate(images[:4], net, weights)
    qn = plain.quantize(net, weights, ranges, bits=8)
    names = _tensor_names(dep.graph)
    for name, q in zip(names, qn.act):
        assert dep.qmodel.qparams[name].scale == q.scale, name
        assert dep.qmodel.qparams[name].zero_point == q.zero_point, name
    assert sorted(qn.pre) == sorted(qn.tables) and len(qn.pre) == 29
    for j, op in enumerate(dep.graph.default_schedule()):
        if j in qn.pre:
            p = dep.qmodel.qparams[pre_activation(names[j + 1])]
            assert (p.scale, p.zero_point) == (qn.pre[j].scale,
                                               qn.pre[j].zero_point)
            np.testing.assert_array_equal(op.attrs["table"],
                                          qn.tables[j].numpy())
    kinds = [op.kind for op in dep.schedule]
    assert kinds.count("qadd") >= 10 and kinds.count("qmul") >= 8
    if which == "rescascade":
        assert "pex_ring_push" in kinds and "pex_ring_read" in kinds
    np.testing.assert_array_equal(_answers(dep, images),
                                  plain.outputs(images, qn).numpy())


def _tie_maps(h):
    """One 1 x h x h map a channel, whose sum is each tie ``n k + n / 2`` of
    the int8 grid and its neighbours (for odd n, each ``n k + n // 2`` and
    its neighbours), with the exact mean rounded half to even beside it."""
    from fractions import Fraction
    n = h * h
    sums = sorted({n * k + n // 2 + d for k in range(-128, 127)
                   for d in (-1, 0, 1)})
    base = [s // n for s in sums]
    x = torch.tensor(base, dtype=torch.int64).repeat(n, 1)
    x += (torch.arange(n)[:, None]
          < torch.tensor([s - b * n for s, b in zip(sums, base)]))
    want = [round(Fraction(s, n)) for s in sums]
    return x.reshape(1, h, h, len(sums)).to(torch.int8), np.array(want)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.card)])
@pytest.mark.parametrize("h", [7, 14, 28])
def test_the_pools_round_the_mean_half_to_even(device, h):
    """The port's ``qavgpool`` and the reference's pool give the mean of
    the map exactly rounded half to even, on every tie of a 14 x 14 and a
    28 x 28 map (the squeeze-and-excite pools at 224), where ``torch.mean``
    on the card, a product with the count's reciprocal, misses 81 of them."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.graphs.cnn_ops import qavgpool
    x, want = _tie_maps(h)
    port = qavgpool(x.to(device)).cpu().reshape(-1).numpy()
    reference = plain.pool_mean(x.to(device, torch.float64)).cpu()
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(reference.reshape(-1).numpy(), want)


@pytest.mark.parametrize("fault", plain.FAULTS)
def test_the_faults_are_not_the_reference(fault):
    """ReLU6 in place of every h-swish, and every gate taken as 1: the
    faulty reference's answers differ from the port's."""
    dep, _, weights, images = _int8(None)
    bad_net = plain.layers(1.0, 32, CLASSES, fault=fault)
    qn = plain.quantize(bad_net, weights,
                        plain.calibrate(images[:4], bad_net, weights))
    bad = plain.outputs(images, qn).numpy()
    assert np.abs(_answers(dep, images).astype(np.int64) - bad).max() > 0


def test_residual_diamonds_merge_into_one_run():
    """``sliceable_runs(skips=True)``: the stem, block 1's branch, its add
    and what follows form one run (the add reads the stem's output, a
    skip), as does each residual block up to its squeeze-and-excite pool;
    the linear runs are what they were."""
    g = int8_scheduling_graph(mobilenet_v3_large_graph())
    runs = sliceable_runs(g, skips=True)
    first = runs[0]
    assert [op.kind for op in first[:4]] == ["conv", "dwconv", "conv", "add"]
    assert run_skips(first) == [(0, 3, 0), (6, 10, 0)]
    assert first[-1].name == "dwconv13"          # block 4's depthwise: SE
    # no run crosses a squeeze-and-excite pool or its gate
    for run in runs:
        assert not any(op.kind in ("avgpool", "fc") for op in run)
        for op in run:
            if op.kind == "mul":
                assert op is run[0]
    linear = sliceable_runs(g)
    assert all(not run_skips(run) for run in linear)
    assert sum(map(len, _residual_chains(g))) == len(g.operators)


def test_skips_stream_only_within_a_segment_or_its_ring():
    """A skip (producer 0, join 3) streams with both in one segment, or
    with the producer last in its segment and the join in the next; not
    across another cut, nor past the cascade's end."""
    sk = [(0, 3, 0)]
    assert _skips_streamable(sk, (5,), 7)
    assert _skips_streamable(sk, (1, 5), 7)
    assert not _skips_streamable(sk, (2,), 7)
    assert not _skips_streamable(sk, (1, 2), 7)
    assert not _skips_streamable(sk, (1,), 3)
    assert _skips_streamable(sk, (1,), 7)


def test_mobilenet_v2_never_reaches_the_residual_rung():
    """MobileNetV2 meets 320 KB on the linear row cascade, so the rung
    after it never runs: its plan is the one it had."""
    from repro_torch.core import ArenaPlanner, schedule
    times = {}
    r = schedule(int8_scheduling_graph(mobilenet_v2_graph(0.35, 128, 10)),
                 arena_budget=80_000,
                 rungs=("reorder", "pex", "cascade", "solver"),
                 phase_s=times)
    assert "rung.rescascade" not in times
    assert r.method == "default+cascade+pex"
    assert ArenaPlanner.plan(r.graph, r.schedule).arena_size == 73_216


def test_the_reference_stands_apart_and_is_the_benchmarks():
    """The benchmark's reference, which these tests load by path, imports
    neither JAX nor the JAX package nor the port nor the benchmark."""
    import ast
    names = set()
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "portbench"}, names
    assert plain.__file__ == str(REFERENCE)


def test_a_run_of_many_diamonds_is_not_searched():
    """MobileNetV2 at 32x32 under a budget no rung meets: its 48-op run of
    eight diamonds holds ~35 000 cut sets, past ``SKIP_CUT_SETS``, so the
    residual rung leaves it as the rungs before planned it (and returns
    in seconds), and the result's notes name it; MobileNetV3's runs are
    searched."""
    import math
    from repro_torch.core import schedule
    from repro_torch.core.partition import (SKIP_CUT_SETS, SKIP_CUTS,
                                            _closed, _skips_streamable)

    def cut_sets(g):
        out = []
        for run in sliceable_runs(g, skips=True):
            sk = run_skips(run)
            if sk:
                out.append(sum(
                    math.comb(sum(_skips_streamable(sk, (c,), e)
                                  for c in range(1, e)), r)
                    for e in range(2, len(run) + 1) if _closed(g, run[:e])
                    for r in range(1, SKIP_CUTS + 1)))
        return out
    v2 = int8_scheduling_graph(mobilenet_v2_graph(1.0, 32, 10))
    assert max(cut_sets(v2)) > SKIP_CUT_SETS
    assert max(cut_sets(int8_scheduling_graph(
        mobilenet_v3_large_graph()))) <= SKIP_CUT_SETS
    times = {}
    r = schedule(v2, arena_budget=4_000, phase_s=times)
    assert "rung.rescascade" in times and "rescascade" not in r.method
    assert r.peak > 4_000
    assert len(r.notes) == 1 and "48 operators from conv1" in r.notes[0] \
        and "over SKIP_CUT_SETS" in r.notes[0]
