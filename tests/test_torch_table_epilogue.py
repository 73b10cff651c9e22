"""MobileNetV3's int8 activations and channel scale: the 256-entry tables
of h-swish and h-sigmoid (``graphs/quantize.py:activation_table``), the
table epilogue of K1–K3 (``ref.table_lookup`` after the requantize), the
squeeze-and-excite multiply ``ref.qmul`` and its kernel K10
(``ops.qscale``), and K2's compile-time 5x5 instance.

On the CPU: every table entry against the float definition evaluated
independently in numpy float32, tables that saturate at both rails, the
int8 rewrite's table convs, ``qmul`` against a plain int64 evaluation, the
wrappers' plain paths and K2's shared memory at the 5x5 shapes.  On the
card (each such test skips without one): K1–K3 with the table epilogue,
over ring windows too, K2 at k = 5 and K10 bit-identical to ``ref.py``.
This file imports no JAX: the card's machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.graphs import mobilenet_v3_large_graph
from repro_torch.graphs.cnn_ops import TABLE_ACTIVATIONS
from repro_torch.graphs.quantize import (QParams, activation_table,
                                         int8_scheduling_graph,
                                         pre_activation, quantize_graph,
                                         weight_qparams)
from repro_torch.kernels.conv_quant import ops, ref
from repro_torch.kernels.conv_quant.ops import RingWindow

torch.set_num_threads(1)

# (s_pre, zp_pre, s_out, zp_out): calibrated-looking params, a grid wider
# than h-swish's knee, and outputs that saturate at both rails
PARAMS = [(0.05, -20, 0.04, -119), (0.01, 3, 0.003, -10),
          (0.2, 100, 0.1, -124), (0.05, 0, 0.0007, 0)]


def _f32_definition(act, s_pre, zp_pre, s_out, zp_out):
    """The table from the definition, in numpy float32 step by step."""
    q = np.arange(-128, 128).astype(np.float32)
    x = np.float32(s_pre) * (q - np.float32(zp_pre))
    r6 = np.minimum(np.maximum(x + np.float32(3), np.float32(0)),
                    np.float32(6))
    f = (x * r6 if act == "hswish" else r6) / np.float32(6)
    y = np.round(f / np.float32(s_out)) + np.float32(zp_out)
    return np.clip(y, -128, 127).astype(np.int8)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("act", TABLE_ACTIVATIONS)
def test_every_table_entry_is_the_float_definition(act, params):
    s_pre, zp_pre, s_out, zp_out = params
    got = activation_table(act, QParams(s_pre, zp_pre), QParams(s_out, zp_out))
    assert got.dtype == np.int8 and got.shape == (256,)
    np.testing.assert_array_equal(got, _f32_definition(act, *params))


def test_a_table_saturates_at_both_rails():
    """h-swish's floor of -0.375 at a fine output scale falls below -128
    and its top above 127: both rails are written, and hold."""
    t = activation_table("hswish", QParams(0.05, 0), QParams(0.0007, 0))
    assert t.min() == -128 and t.max() == 127
    assert (t == -128).sum() > 1 and (t == 127).sum() > 1
    with pytest.raises(ValueError, match="no int8 table"):
        activation_table("relu6", QParams(0.1, 0), QParams(0.1, 0))


def test_table_lookup_indexes_by_the_int8_value():
    gen = torch.Generator().manual_seed(1)
    table = torch.randint(-128, 128, (256,), generator=gen, dtype=torch.int8)
    q = torch.randint(-128, 128, (3, 5, 7), generator=gen, dtype=torch.int8)
    got = ref.table_lookup(q, table)
    want = table.numpy()[q.numpy().astype(np.int64) + 128]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="256 int8 values"):
        ref.table_lookup(q, table[:255])


def _qmul_int64(x, g, mult, zp_x, zp_g, zp_out):
    acc = (x.astype(np.int64) - zp_x) * (g.astype(np.int64) - zp_g)
    y = np.rint(acc.astype(np.float32) * np.float32(mult)) + zp_out
    return np.clip(y, -128, 127).astype(np.int8)


@pytest.mark.parametrize("mult, zp_x, zp_g, zp_out",
                         [(0.0031, -7, -128, 4), (0.021, 30, -128, -90),
                          (0.0004, -128, 11, 127)])
def test_qmul_is_the_plain_int64_evaluation(mult, zp_x, zp_g, zp_out):
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(-128, 128, (4, 6, 5, 24), generator=gen,
                      dtype=torch.int8)
    g = torch.randint(-128, 128, (4, 1, 1, 24), generator=gen,
                      dtype=torch.int8)
    got = ref.qmul(x, g, mult, zp_x, zp_g, zp_out)
    np.testing.assert_array_equal(
        got.numpy(), _qmul_int64(x.numpy(), g.numpy(), mult, zp_x, zp_g,
                                 zp_out))
    # K10's plain path is it, lanes apart and written into a view
    arena = torch.zeros((4, 7 * 5 * 24), dtype=torch.int8)
    out = arena[:, 120:].reshape(4, 6, 5, 24)
    assert ops.qscale(x, g, mult=mult, zp_x=zp_x, zp_g=zp_g, zp_out=zp_out,
                      out=out) is out
    np.testing.assert_array_equal(out.numpy(), got.numpy())


def test_k10_refuses_a_gate_of_another_shape():
    x = torch.zeros((2, 4, 4, 8), dtype=torch.int8)
    for g in (torch.zeros((2, 1, 1, 4), dtype=torch.int8),
              torch.zeros((1, 1, 1, 8), dtype=torch.int8),
              torch.zeros((2, 4, 4, 8), dtype=torch.int8)):
        with pytest.raises(ValueError, match="expected"):
            ops.qscale(x, g, mult=0.1, zp_x=0, zp_g=0, zp_out=0)


def _conv_case(gen, k, cin, cout, depthwise=False):
    x = torch.randint(-128, 128, (3, 9, 7, cin), generator=gen,
                      dtype=torch.int8)
    shape = (k, k, cin) if depthwise else (k, k, cin, cout)
    w = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    table = torch.randint(-128, 128, (256,), generator=gen, dtype=torch.int8)
    return x, w, table


@pytest.mark.parametrize("kind", ["k1", "k2", "k3"])
def test_plain_paths_apply_the_table_after_the_requantize(kind):
    """K1–K3's plain versions with a table: the clamp's requantize over the
    whole grid, then ``table[q + 128]``."""
    gen = torch.Generator().manual_seed(3)
    qp = dict(mult=0.0021, zp_in=-9, zp_out=14, lo=-128, hi=127)
    if kind == "k1":
        x, w, table = _conv_case(gen, 1, 40, 24)
        w = w[0, 0]
        plain = ops.qconv1x1(x, w, **qp)
        got = ops.qconv1x1(x, w, table=table, **qp)
    else:
        dw = kind == "k2"
        x, w, table = _conv_case(gen, 5 if dw else 3, 16, 8, dw)
        fn = ops.qdwconv if dw else ops.qconv
        pads = dict(stride=2, hpad=(1, 2), wpad=(2, 1))
        plain = fn(x, w, **pads, **qp)
        got = fn(x, w, table=table, **pads, **qp)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.table_lookup(plain, table).numpy())


def test_the_int8_rewrite_gives_table_convs_their_pre_params():
    """Each h-swish / h-sigmoid conv of the int8 MobileNetV3 requantizes to
    the params calibrated before its activation (over the whole grid) and
    carries the table from those to its output's; the other convs keep
    their clamp pairs."""
    g = mobilenet_v3_large_graph(0.35, 32, 10)
    rng = np.random.default_rng(0)
    qm = quantize_graph(g, [{"input": rng.uniform(-1, 1, (32, 32, 3))
                             .astype(np.float32)} for _ in range(2)],
                        device="cpu")
    floats = {op.name: op for op in g.operators}
    tables = 0
    for op in qm.graph.operators:
        act, a = op.attrs.get("act"), op.attrs
        if act is None:
            continue
        sw = weight_qparams(floats[op.name].attrs["weight"])[1]
        s_in = qm.qparams[op.inputs[0]].scale
        if act in TABLE_ACTIVATIONS:
            tables += 1
            pre = qm.qparams[pre_activation(op.output)]
            assert (a["lo"], a["hi"], a["zp_out"]) == (-128, 127,
                                                      pre.zero_point)
            assert a["mult"] == s_in * sw / pre.scale
            np.testing.assert_array_equal(
                a["table"], activation_table(act, pre, qm.qparams[op.output]))
        else:
            out = qm.qparams[op.output]
            assert "table" not in a and a["zp_out"] == out.zero_point
            assert a["mult"] == s_in * sw / out.scale
    assert tables == 21 + 8


def test_k2_at_5x5_fits_its_shared_memory():
    """K2's tile at MobileNetV3-Large's 5x5 shapes (blocks 4–6 and 13–15,
    stride 2 in blocks 4 and 13), over 32 lanes on an H100's 132 SMs, fits
    a block's shared memory."""
    g = int8_scheduling_graph(mobilenet_v3_large_graph())
    fives = [op for op in g.operators
             if op.kind == "dwconv" and op.attrs["k"] == 5]
    assert len(fives) == 6
    assert sum(op.attrs["stride"] == 2 for op in fives) == 2
    for op in fives:
        oh, ow, c = g.tensors[op.output].shape
        plan = ops.plan_dw_tile(32, oh, ow, c, 132)
        assert ops.dw_smem(*plan, 5, op.attrs["stride"]) <= ops.DW_MAX_SMEM


# ------------------------------------------------------------------ the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _both(fn_card, fn_cpu):
    got = fn_card()
    torch.cuda.synchronize()
    return got.cpu().numpy(), fn_cpu().numpy()


@pytest.mark.card
@pytest.mark.parametrize("cin, cout, m", [(40, 24, 63), (240, 960, 49),
                                          (960, 1280, 1), (72, 120, 784)])
def test_k1_table_epilogue_is_the_plain_version(card, cin, cout, m):
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randint(-128, 128, (5, m, 1, cin), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cin, cout), generator=gen,
                      dtype=torch.int8)
    table = torch.randint(-128, 128, (256,), generator=gen, dtype=torch.int8)
    qp = dict(mult=0.00037, zp_in=-3, zp_out=21, lo=-128, hi=127)
    before = (ops.qconv1x1.launches, ops.qconv1x1.table_launches)
    got, want = _both(
        lambda: ops.qconv1x1(x.to(card), w.to(card), table=table.to(card),
                             **qp),
        lambda: ops.qconv1x1(x, w, table=table, **qp))
    np.testing.assert_array_equal(got, want)
    assert (ops.qconv1x1.launches, ops.qconv1x1.table_launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="whole int8 range"):
        ops.qconv1x1(x.to(card), w.to(card), table=table.to(card),
                     **{**qp, "lo": 21})


@pytest.mark.card
@pytest.mark.parametrize("k, stride, c", [(3, 1, 72), (3, 2, 240),
                                          (5, 2, 72), (5, 1, 120),
                                          (5, 2, 672), (5, 1, 960),
                                          (5, 1, 20)])
@pytest.mark.parametrize("tabled", [False, True])
def test_k2_is_the_plain_version_at_3x3_and_5x5(card, k, stride, c, tabled):
    """K2 with the clamp (k = 5's compile-time instance too) and with the
    table epilogue; whole inputs and a ring window read in place."""
    gen = torch.Generator().manual_seed(k * c + stride)
    x = torch.randint(-128, 128, (4, 14, 14, c), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, c), generator=gen, dtype=torch.int8)
    table = torch.randint(-128, 128, (256,), generator=gen, dtype=torch.int8)
    qp = dict(stride=stride, mult=0.0041, zp_in=7, zp_out=-30,
              hpad=ops._pads(14, k, stride), wpad=ops._pads(14, k, stride),
              lo=-128 if tabled else -30, hi=127 if tabled else 90)
    tab = dict(table=table) if tabled else {}
    got, want = _both(
        lambda: ops.qdwconv(x.to(card), w.to(card),
                            **{**qp, **{n: v.to(card)
                                        for n, v in tab.items()}}),
        lambda: ops.qdwconv(x, w, **qp, **tab))
    np.testing.assert_array_equal(got, want)
    # a ring window: rows 9, 10, ..., wrapping, of a 12-row ring
    n = 2 * stride + k
    qr = {**qp, "hpad": (0, 0)}
    got, want = _both(
        lambda: ops.qdwconv(x[:, :12].contiguous().to(card), w.to(card),
                            src=9, n=n,
                            **{**qr, **{t: v.to(card)
                                        for t, v in tab.items()}}),
        lambda: ref.qdwconv_ring_ref(x[:, :12].contiguous(), w, src=9, n=n,
                                     **qr, **tab))
    np.testing.assert_array_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("cin, cout", [(3, 16), (16, 24)])
def test_k3_table_epilogue_is_the_plain_version(card, cin, cout):
    """K3 (MobileNetV3's h-swish stem) with the table, whole and over a
    ring window."""
    gen = torch.Generator().manual_seed(cin * cout)
    x = torch.randint(-128, 128, (3, 16, 16, cin), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                      dtype=torch.int8)
    table = torch.randint(-128, 128, (256,), generator=gen, dtype=torch.int8)
    qp = dict(stride=2, mult=0.0013, zp_in=-128, zp_out=5, hpad=(0, 1),
              wpad=(0, 1), lo=-128, hi=127)
    before = ops.qconv.table_launches
    got, want = _both(
        lambda: ops.qconv(x.to(card), w.to(card), table=table.to(card), **qp),
        lambda: ops.qconv(x, w, table=table, **qp))
    np.testing.assert_array_equal(got, want)
    assert ops.qconv.table_launches == before + 1
    got, want = _both(
        lambda: ops.qconv(x[:, :10].contiguous().to(card), w.to(card),
                          table=table.to(card), src=7, n=7,
                          **{**qp, "hpad": (0, 0)}),
        lambda: ref.qconv_ring_ref(x[:, :10].contiguous(), w, src=7, n=7,
                                   table=table, **{**qp, "hpad": (0, 0)}))
    np.testing.assert_array_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("h, c, offset", [(7, 960, 0), (14, 120, 16),
                                          (28, 72, 4), (5, 20, 0),
                                          (3, 13, 1)])
def test_k10_is_qmul(card, h, c, offset):
    """K10 against ``ref.qmul``: lanes apart in an arena (16-, 4- and
    1-byte threads by the offset and C), its gate in another, and in
    place over its map; a ring window handed to the lowering is
    gathered."""
    gen = torch.Generator().manual_seed(h * c + offset)
    lanes, n = 6, h * h * c
    x = torch.randint(-128, 128, (lanes, h, h, c), generator=gen,
                      dtype=torch.int8)
    g = torch.randint(-128, 128, (lanes, 1, 1, c), generator=gen,
                      dtype=torch.int8)
    qp = dict(mult=0.00093, zp_x=-11, zp_g=-128, zp_out=3)
    want = ref.qmul(x, g, qp["mult"], qp["zp_x"], qp["zp_g"], qp["zp_out"])
    pitch = offset + n + c + 16
    arena = torch.zeros((lanes, pitch), dtype=torch.int8, device=card)
    xv = arena[:, offset:offset + n].view(lanes, h, h, c)
    gv = arena[:, offset + n:offset + n + c].view(lanes, 1, 1, c)
    xv.copy_(x.to(card))
    gv.copy_(g.to(card))
    before = ops.qscale.launches
    out = ops.qscale(xv, gv, out=xv, **qp)      # in place over the map
    torch.cuda.synchronize()
    assert out is xv and ops.qscale.launches == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), want.numpy())
    # the lowering gathers a ring window of the map
    from repro_torch.graphs import cnn_ops
    ring = x[:, :h].contiguous().to(card)
    win = RingWindow(ring, 2, h)
    op = type("Op", (), {"attrs": {"mult": qp["mult"], "zp_x": qp["zp_x"],
                                   "zp_g": qp["zp_g"],
                                   "zp_out": qp["zp_out"]}})()
    got = cnn_ops._lower_qmul(None, op, win, g.to(card), out=None)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        ref.qmul(ref.ring_window(x[:, :h].contiguous(), 2, h), g,
                 qp["mult"], qp["zp_x"], qp["zp_g"], qp["zp_out"]).numpy())
