"""Work counted from shapes, against hand arithmetic."""
import pytest

from portbench.harness import spec, work
from portbench.harness.readers import mfu
from portbench.harness.record import Record

PEAKS = {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1.979e15}


def _graph():
    from repro_torch.core.graph import Graph
    from repro_torch.graphs.cnn_ops import CNNBuilder
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", 12, 12, 8)
    x = b.dwconv(x, k=3, stride=1)            # 12x12x8
    x = b.conv(x, 16, k=1)                    # 12x12x16
    g.set_outputs([x])
    return g


def test_pointwise_and_depthwise_by_hand():
    g = _graph()
    dw, pw = g.default_schedule()
    assert work.conv_kind(dw) == "depthwise"
    assert work.conv_kind(pw) == "pointwise"
    assert work.op_macs(g, dw) == 12 * 12 * 8 * 9
    assert work.op_macs(g, pw) == 12 * 12 * 16 * 8
    lanes = 32
    got = work.executed_work(g, g.default_schedule(), lanes, PEAKS)
    # float32 tensors: 4 bytes an element; weights once a call
    dw_bytes = lanes * 4 * (12 * 12 * 8 + 12 * 12 * 8) + 4 * 9 * 8
    pw_bytes = lanes * 4 * (12 * 12 * 8 + 12 * 12 * 16) + 4 * 8 * 16
    assert got["depthwise"].bytes == dw_bytes
    assert got["pointwise"].bytes == pw_bytes
    assert got["depthwise"].ops == 2 * lanes * 12 * 12 * 8 * 9
    assert got["pointwise"].ops == 2 * lanes * 12 * 12 * 16 * 8
    assert got["pointwise"].bound_s == pytest.approx(max(
        pw_bytes / PEAKS["hbm_bytes_per_s"],
        2 * lanes * 12 * 12 * 16 * 8 / PEAKS["int8_ops_per_s"]))


def test_mobilenet_macs_in_mfu():
    """MobileNet-v1 1.0 @ 192 with its 1 000 classes: the graph's MACs are
    the reference's, and mfu's numerator is two operations a MAC."""
    ref = spec.load_module("reference", "mobilenet_v1")
    graph = spec.load_module("graphs", "mobilenet_v1").build(1.0, 192, 1000)
    macs = work.graph_macs(graph)
    assert macs == ref.model_macs(ref.layers(1.0, 192, 1000))
    # the published 569 M MACs at 224, the convolutions scaled to 192
    fc = 1024 * 1000
    assert macs - fc == pytest.approx((569e6 - fc) * (192 / 224) ** 2,
                                      rel=0.01)
    rec = Record(cell=None, seed=0, device_kind="x", model_macs=macs,
                 peaks=PEAKS, quiet_s=2.0, quiet_requests=5000)
    assert mfu(rec) == pytest.approx(
        100.0 * 2 * macs * 2500 / PEAKS["int8_ops_per_s"])


def test_kernel_map_names_kinds():
    kinds = spec.data("kernel_kinds")
    assert kinds["qconv1x1_kernel"] == "pointwise"
    assert kinds["qdwconv_kernel"] == "depthwise"
    assert set(kinds.values()) <= {"pointwise", "depthwise", "conv"}
    assert work.card_peaks(spec.data("peaks"),
                           "NVIDIA H100 80GB HBM3")["int8_ops_per_s"] \
        == 1.979e15
    assert work.card_peaks(spec.data("peaks"), "cpu") is None
