"""The MobileNetV2 configuration on the CPU at a tiny size (1.0 @ 32, the
published 1 000-class head, a 10 000 B budget that needs the cascade's
rings, 4 lanes, a pool of 16): the reference's layers, work and
quantization, the system's run judged correct, and what must not be: the
4-bit control, and the program's projections given a ReLU."""
import time

import numpy as np
import pytest
import torch

from portbench.harness import adds, inputs, judge, spec
from portbench.harness.trace import Summary

ref = spec.load_module("reference", "mobilenet_v2")
graphs = spec.load_module("graphs", "mobilenet_v2")
residual = spec.load_module("systems", "cnn_residual")
CPU = torch.device("cpu")
CONFIG = "mnv2_int8_320k"
TINY = dict(alpha=1.0, resolution=32, arena_budget_bytes=10000, lanes=4,
            calibration_images=8)


def tiny_cell():
    """The cell as BENCHMARK.json has it, cut to the tiny size."""
    cell = spec.find_cell(f"{CONFIG}.backlog", spec.load_spec())
    cell.config = {**cell.config, **TINY}
    cell.traffic = {**cell.traffic, "pool": 16}
    return cell


def _run(seconds=0.5):
    return residual.run(tiny_cell(), 2**31 + 17, seconds, False, CPU,
                        time.perf_counter())


def _bad(rec):
    return sorted(c.name for c in rec.checks if not c.ok)


def test_layers_are_table_2_and_the_ports_graph():
    """17 blocks and 10 adds at 1.0@224; each operator of the port's
    ``mobilenet_v2_graph`` is the reference's layer (kind, activation,
    weight shape, the tensors it reads) with its output shape; 300 774 272
    multiply-accumulates an image (Table 2's 300 M: 299 494 272 in the
    convs, 1 280 000 in the head)."""
    net = ref.layers(1.0, 224, 1000)
    assert len(net) == 64
    assert sum(layer.kind == "add" for layer in net) == 10
    assert sum(layer.act == "none" for layer in net) == 17
    assert ref.model_macs(net) == 300_774_272
    g = graphs.build(1.0, 224, 1000)
    ops = residual._layers_of(g, net)
    assert len(ops) == 64
    assert [tuple(g.tensors[op.output].shape) for op in ops] == \
        [(layer.h_out, layer.w_out, layer.cout) for layer in net]
    with pytest.raises(ValueError, match="is not the reference's"):
        residual._layers_of(g, ref.layers(1.0, 224, 1000,
                                          relu_projections=True))


def test_quantization_is_the_ports_at_a_tiny_size():
    """Same weights and calibration images: the reference's qparams and
    int8 answers are the port's plain path's, under the tiny budget."""
    from repro_torch import deploy
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
    ranges = ref.calibrate(made.images[:4], net, made.weights)
    qn = ref.quantize(net, made.weights, ranges, bits=8)
    names = ["input"] + [op.output for op in dep.graph.default_schedule()]
    assert [(dep.qmodel.qparams[n].scale, dep.qmodel.qparams[n].zero_point)
            for n in names] == [(q.scale, q.zero_point) for q in qn.act]
    want = ref.outputs(made.images, qn).numpy()
    got = np.stack([dep.run(dep.quantize_inputs({"input": x}))[
        dep.graph.outputs[0]].reshape(-1) for x in images])
    np.testing.assert_array_equal(got, want)


def test_a_sound_run_is_correct_and_counts_its_adds():
    rec = _run()
    assert _bad(rec) == [] and rec.failed == 0 and rec.attempted > 8
    assert rec.arena_bytes <= 10000
    assert rec.add_count >= 10 and rec.add_bytes > 0
    assert any(n.startswith("schedule: rung default+cascade") for n in
               rec.notes)


def test_relu_projections_in_the_program_are_not_correct(monkeypatch):
    """The fault: the program's projections given a ReLU after the graph
    was matched to the reference's layers."""
    import repro_torch.params as params
    apply = params.apply_params

    def relu_projections(graph, values):
        apply(graph, values)
        return apply(graph, {op.name: {"act": "relu"}
                             for op in graph.operators
                             if op.attrs.get("act") == "none"})
    monkeypatch.setattr(params, "apply_params", relu_projections)
    assert "answer_gap" in _bad(_run(0.3))


@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_fails(seed):
    import importlib.util
    path = spec.ROOT / "readings.py"
    s = importlib.util.spec_from_file_location("pb_readings_mnv2", path)
    readings = importlib.util.module_from_spec(s)
    s.loader.exec_module(readings)
    bad = {c.name for c in readings.control_checks(tiny_cell(), seed, CPU)
           if not c.ok}
    assert {"answer_gap", "answer_mean_gap", "scale_gap", "zp_gap"} <= bad


def test_add_readers():
    """``add_roofline`` and ``add_launches_per_dispatch`` read the trace's
    ``qadd_kernel`` activities; with nothing to read they give None."""
    roof = spec.load_module("metrics", "add_roofline")
    per = spec.load_module("metrics", "add_launches_per_dispatch")
    rec = residual.ResidualRecord(cell=None, seed=0, device_kind="x")
    assert roof.read(rec) is None and per.read(rec) is None
    rec.trace = Summary(1.0, 0.5, {"qadd_kernel": (20, 2e-4),
                                   "qconv1x1_kernel": (40, 1e-3)}, {})
    rec.traced_dispatches, rec.add_launches = 4, 20
    rec.add_bound_s = 1e-5
    assert per.read(rec) == 5.0
    assert roof.read(rec) == pytest.approx(100.0 * 1e-5 * 4 / 2e-4)
    rec.add_launches = 19                # a launch the trace lacks
    assert per.read(rec) is None
    rec.add_launches = 0                 # a program without K9
    assert per.read(rec) is None


def test_add_work_is_three_bytes_an_element_a_lane():
    from repro_torch.graphs import int8_scheduling_graph
    g = int8_scheduling_graph(graphs.build(1.0, 32, 10))
    a = adds.executed_adds(g, g.default_schedule(), 4,
                           {"hbm_bytes_per_s": 1e9})
    elems = sum(g.tensors[op.output].elements for op in g.operators
                if op.kind == "add")
    assert (a.count, a.bytes) == (10, 4 * 3 * elems)
    assert a.bound_s == a.bytes / 1e9
