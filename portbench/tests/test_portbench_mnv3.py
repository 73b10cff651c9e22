"""The MobileNetV3-Large configuration on the CPU at a tiny size (1.0 @ 32,
the published 1 000-class head, a 10 000 B budget that needs the residual
row cascade, 4 lanes, a pool of 16): the reference's layers, work and
quantization, the system's run judged correct and counting its adds and
channel scales, and what must not be: the 7-bit control, and the
reference's two faults (ReLU6 for h-swish, every gate taken as 1) in the
program's place."""
import time

import numpy as np
import pytest
import torch

from portbench.harness import inputs, judge, scales, spec
from portbench.harness.trace import Summary

ref = spec.load_module("reference", "mobilenet_v3")
graphs = spec.load_module("graphs", "mobilenet_v3")
se = spec.load_module("systems", "cnn_se")
residual = spec.load_module("systems", "cnn_residual")
CPU = torch.device("cpu")
CONFIG = "mnv3l_int8_320k"
TINY = dict(alpha=1.0, resolution=32, arena_budget_bytes=10000, lanes=4,
            calibration_images=8)


def tiny_cell():
    """The cell as BENCHMARK.json has it, cut to the tiny size."""
    cell = spec.find_cell(f"{CONFIG}.backlog", spec.load_spec())
    cell.config = {**cell.config, **TINY}
    cell.traffic = {**cell.traffic, "pool": 16}
    return cell


def _run(seconds=0.5):
    return se.run(tiny_cell(), 2**31 + 23, seconds, False, CPU,
                  time.perf_counter())


def _bad(rec):
    return sorted(c.name for c in rec.checks if not c.ok)


def test_layers_are_table_1_and_the_ports_graph():
    """15 blocks, 8 squeeze-and-excite (squeezes 24/32/32/120/168/168/240/
    240), 10 adds, 6 5x5 depthwise convs, 21 h-swish and 8 h-sigmoid convs
    at 1.0@224; each operator of the port's ``mobilenet_v3_large_graph`` is
    the reference's layer (kind, activation, weight shape, the tensors it
    reads) with its output shape; 216 589 760 multiply-accumulates an
    image (Table 3's 219 M)."""
    net = ref.layers(1.0, 224, 1000)
    kinds = [layer.kind for layer in net]
    assert (kinds.count("add"), kinds.count("mul"), kinds.count("dw")) == \
        (10, 8, 15)
    assert sum(layer.kind == "dw" and layer.k == 5 for layer in net) == 6
    assert [net[layer.inputs[1] - 1].cin for layer in net
            if layer.kind == "mul"] == [24, 32, 32, 120, 168, 168, 240, 240]
    acts = [layer.act for layer in net]
    assert (acts.count("hswish"), acts.count("hsigmoid")) == (21, 8)
    assert ref.model_macs(net) == 216_589_760
    g = graphs.build(1.0, 224, 1000)
    ops = se.residual._layers_of(g, net)
    assert len(ops) == len(net) == 91
    assert [tuple(g.tensors[op.output].shape) for op in ops] == \
        [(layer.h_out, layer.w_out, layer.cout) for layer in net]
    with pytest.raises(ValueError, match="is not the reference's"):
        se.residual._layers_of(g, ref.layers(1.0, 224, 1000,
                                             fault="relu6_for_hswish"))


def test_quantization_is_the_ports_at_a_tiny_size():
    """Same weights and calibration images: the reference's qparams,
    pre-activation params, tables and int8 answers are the port's plain
    path's, under the tiny budget."""
    from repro_torch import deploy
    from repro_torch.graphs.quantize import pre_activation
    from repro_torch.params import apply_params
    net = ref.layers(1.0, 32, 1000)
    made = inputs.make(3, [layer.weight_shape for layer in net],
                       [ref.he_std(layer) for layer in net], 6, 32, CPU)
    g = graphs.build(1.0, 32, 1000)
    apply_params(g, {op.name: {"weight": w} for op, w in
                     zip(g.default_schedule(), made.weights_np()) if w.size})
    images = made.images.numpy()
    dep = deploy.build(g, arena_budget=10000, quantize=True,
                       calibration=[{"input": images[i]} for i in range(4)],
                       device="cpu")
    assert dep.schedule_result.method.endswith("rescascade+pex")
    ranges = ref.calibrate(made.images[:4], net, made.weights)
    qn = ref.quantize(net, made.weights, ranges, bits=8)
    names = ["input"] + [op.output for op in dep.graph.default_schedule()]
    assert [(dep.qmodel.qparams[n].scale, dep.qmodel.qparams[n].zero_point)
            for n in names] == [(q.scale, q.zero_point) for q in qn.act]
    assert len(qn.pre) == 29
    for j, q in qn.pre.items():
        p = dep.qmodel.qparams[pre_activation(names[j + 1])]
        assert (p.scale, p.zero_point) == (q.scale, q.zero_point)
    for j, op in enumerate(dep.graph.default_schedule()):
        if j in qn.tables:
            np.testing.assert_array_equal(op.attrs["table"],
                                          qn.tables[j].numpy())
    want = ref.outputs(made.images, qn).numpy()
    got = np.stack([dep.run(dep.quantize_inputs({"input": x}))[
        dep.graph.outputs[0]].reshape(-1) for x in images])
    np.testing.assert_array_equal(got, want)


def test_a_sound_run_is_correct_and_counts_its_adds_and_scales():
    rec = _run()
    assert _bad(rec) == [] and rec.failed == 0 and rec.attempted > 8
    assert rec.arena_bytes <= 10000
    assert rec.add_count >= 10 and rec.add_bytes > 0
    assert rec.scale_count >= 8 and rec.scale_bytes > 0
    assert any(n.startswith("schedule: rung ") and "+rescascade" in n
               for n in rec.notes)
    assert any(n.startswith("squeeze-and-excite:") for n in rec.notes)


def _control(fault=None, bits=8, seed=1):
    """The judge's numbers with the reference at ``bits`` or with
    ``fault`` in the program's place, at the tiny size."""
    cell = tiny_cell()
    cfg = cell.config
    net = ref.layers(cfg["alpha"], cfg["resolution"], cfg["num_classes"])
    made = inputs.make(seed, [layer.weight_shape for layer in net],
                       [ref.he_std(layer) for layer in net],
                       int(cell.traffic["pool"]), cfg["resolution"], CPU)
    n_cal = int(cfg["calibration_images"])
    want = ref.quantize(net, made.weights,
                        ref.calibrate(made.images[:n_cal], net,
                                      made.weights), bits=8)
    bad_net = ref.layers(cfg["alpha"], cfg["resolution"],
                         cfg["num_classes"], fault=fault)
    low = ref.quantize(bad_net, made.weights,
                       ref.calibrate(made.images[:n_cal], bad_net,
                                     made.weights), bits=bits)
    answers = ref.outputs(made.images, low).numpy()
    return judge.checks(
        answers=answers, images=np.arange(answers.shape[0]), unanswered=0,
        reference=ref.outputs(made.images, want).numpy(),
        program_q=[(q.scale, q.zero_point) for q in low.act],
        reference_q=[(q.scale, q.zero_point) for q in want.act],
        arena_bytes=0, budget=0, lane_bytes=0, limits=cfg["limits"])


@pytest.mark.parametrize("seed", [1, 2])
def test_the_7_bit_control_fails(seed):
    bad = {c.name for c in _control(bits=7, seed=seed) if not c.ok}
    assert {"answer_gap", "answer_mean_gap", "scale_gap", "zp_gap"} <= bad


@pytest.mark.parametrize("fault", ["relu6_for_hswish", "no_se"])
def test_the_faults_fail(fault):
    bad = {c.name for c in _control(fault=fault) if not c.ok}
    assert {"answer_gap", "answer_mean_gap"} <= bad


def test_the_sound_reference_in_the_programs_place_passes():
    """The comparison itself: the sound reference judged against itself
    meets every limit of 0."""
    assert all(c.ok for c in _control())


def test_scale_readers():
    """``scale_roofline`` and ``scale_launches_per_dispatch`` read the
    trace's ``qscale_kernel`` activities; with nothing to read they give
    None."""
    roof = spec.load_module("metrics", "scale_roofline")
    per = spec.load_module("metrics", "scale_launches_per_dispatch")
    rec = se.SERecord(cell=None, seed=0, device_kind="x")
    assert roof.read(rec) is None and per.read(rec) is None
    rec.trace = Summary(1.0, 0.5, {"qscale_kernel": (32, 1e-4),
                                   "qadd_kernel": (40, 1e-3)}, {})
    rec.traced_dispatches, rec.scale_launches = 4, 32
    rec.scale_bound_s = 2e-6
    assert per.read(rec) == 8.0
    assert roof.read(rec) == pytest.approx(100.0 * 2e-6 * 4 / 1e-4)
    rec.scale_launches = 31              # a launch the trace lacks
    assert per.read(rec) is None
    rec.scale_launches = 0               # a program without K10
    assert per.read(rec) is None
    # a record of a system without channel scales: both silent
    plain = residual.ResidualRecord(cell=None, seed=0, device_kind="x")
    plain.trace, plain.traced_dispatches = rec.trace, 4
    assert roof.read(plain) is None and per.read(plain) is None


def test_the_scale_matcher_leaves_the_residual_systems_own():
    """The channel scale is in this system's copy of the residual layer
    matcher only: the MobileNetV2 cell's matcher is as it was."""
    assert "mul" in se.residual.KINDS
    assert "mul" not in residual.KINDS and se.residual is not residual


def test_scale_work_is_two_bytes_an_element_a_lane_and_the_gate():
    from repro_torch.graphs import int8_scheduling_graph
    g = int8_scheduling_graph(graphs.build(1.0, 32, 10))
    s = scales.executed_scales(g, g.default_schedule(), 4,
                               {"hbm_bytes_per_s": 1e9})
    muls = [op for op in g.operators if op.kind == "mul"]
    elems = sum(g.tensors[op.output].elements for op in muls)
    gates = sum(g.tensors[op.inputs[1]].elements for op in muls)
    assert (s.count, s.bytes) == (8, 4 * (2 * elems + gates))
    assert s.bound_s == s.bytes / 1e9
    assert scales.executed_scales(g, g.default_schedule(), 4,
                                  None).bound_s == 0.0
