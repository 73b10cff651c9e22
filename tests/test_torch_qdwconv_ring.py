"""Cascade ring windows read in place by K2 (``qdwconv``) and K3
(``qconv``): the ring-view plain versions in ``kernels/conv_quant/ref.py``
against gather-then-plain, the card's route emulated on the CPU (the
executor hands K2/K3 a ``RingWindow`` and nothing gathers it; qmaxpool and
the 1x1 route to K1 gather), the small int8 row and 2-D cascades still
bit-identical to the reference executor that way, and K2's host-side
plans: the tile (``plan_dw_tile``) and the load width (``load_width``)."""
import types

import numpy as np
import pytest
import torch

from repro.core import cascade_graph as jax_cascade
from repro.graphs import mobilenet_v1_graph as jax_mobilenet

from repro_torch.core import cascade_graph
from repro_torch.graphs import cnn_ops, mobilenet_v1_graph, random_input
from repro_torch.kernels.conv_quant import ops, ref

from test_torch_executor import check_twin_executors
from test_torch_params import int8_twins

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

_QP = dict(mult=0.0123, zp_in=3, zp_out=-5)


def qrand(rng, shape):
    return torch.as_tensor(rng.integers(-128, 128, size=shape,
                                        dtype=np.int8))


def ring_lanes(rng, lanes, rows, w, c):
    """A ring of ``lanes`` lanes lying a byte stride apart that is no
    multiple of 4, as arena views lie."""
    n = rows * w * c
    buf = qrand(rng, (lanes, n + 37))
    return buf[:, 5:5 + n].view(lanes, rows, w, c)


# (ring rows, src, n): a window that does not wrap, one that wraps, one
# that starts at the last ring row, the whole ring from row 0 and from the
# middle; src is a row of the stream, so it may pass the ring's rows
WINDOWS = [(7, 1, 4), (7, 5, 5), (7, 6, 3), (6, 0, 6), (6, 3, 6),
           (5, 12, 4)]


@pytest.mark.parametrize("rows,src,n", WINDOWS)
def test_ring_view_plain_versions_equal_gather_then_plain(rows, src, n):
    """``q{dw,}conv{,_add}_ring_ref`` and the CPU wrappers with (src, n)
    equal gathering the window (the executor's span copies) and running
    the plain version, bit for bit."""
    rng = np.random.default_rng(rows * 100 + src * 10 + n)
    ring = ring_lanes(rng, 2, rows, 9, 8)
    win = ops.RingWindow(ring, src, n).gather()
    want_rows = torch.stack([ring[:, (src + j) % rows] for j in range(n)], 1)
    assert torch.equal(win, want_rows)
    assert torch.equal(ref.ring_window(ring, src, n), want_rows)
    pads = dict(stride=1, hpad=(1, 1), wpad=(1, 1))
    wd = qrand(rng, (3, 3, 8))
    want = ref.qdwconv_ref(win, wd, **pads, **_QP)
    assert torch.equal(ref.qdwconv_ring_ref(ring, wd, src=src, n=n, **pads,
                                            **_QP), want)
    assert torch.equal(ops.qdwconv(ring, wd, src=src, n=n, **pads, **_QP),
                       want)
    wc = qrand(rng, (3, 3, 8, 5))
    pads = dict(stride=2, hpad=(0, 1), wpad=(1, 0))
    want = ref.qconv_ref(win, wc, **pads, **_QP)
    assert torch.equal(ref.qconv_ring_ref(ring, wc, src=src, n=n, **pads,
                                          **_QP), want)
    assert torch.equal(ops.qconv(ring, wc, src=src, n=n, **pads, **_QP),
                       want)
    r = qrand(rng, tuple(want.shape))
    ap = (0.71, 0.39, -5, 2, -7)
    want = ref.qconv_add_ref(win, wc, r, add_params=ap, **pads, **_QP)
    assert torch.equal(ops.qconv_add(ring, wc, r, src=src, n=n,
                                     add_params=ap, **pads, **_QP), want)


def test_ring_arguments_are_checked():
    ring = torch.zeros((1, 5, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 8), dtype=torch.int8)
    pads = dict(stride=1, hpad=(1, 1), wpad=(1, 1))
    for src, n in ((-1, 2), (0, 0)):
        with pytest.raises(ValueError, match="ring"):
            ops.qdwconv(ring, w, src=src, n=n, **pads, **_QP)
    with pytest.raises(ValueError, match="src"):
        ops.qdwconv(ring, w, src=2, **pads, **_QP)


@pytest.fixture
def card_route(monkeypatch):
    """The card's routing forced on CPU tensors: ring windows go to the
    K2/K3 wrappers with (src, n), whose plain ring versions stand in for
    the kernels.  Returns the record of gathers and of the wrappers'
    calls."""
    seen = {"gather": [], "qdwconv": [], "qconv": [], "qconv1x1": []}
    monkeypatch.setattr(ops, "reads_in_place", lambda x: True)
    real_gather = ops.RingWindow.gather

    def gather(self, out=None):
        seen["gather"].append(self.shape)
        return real_gather(self, out)
    monkeypatch.setattr(ops.RingWindow, "gather", gather)
    for name in ("qdwconv", "qconv", "qconv1x1"):
        real = getattr(ops, name)

        def call(x, *a, _f=real, _n=name, **kw):
            seen[_n].append(kw.get("n"))
            return _f(x, *a, **kw)
        monkeypatch.setattr(ops, name, call)
    return seen


def test_card_route_reads_windows_in_place_and_gathers_elsewhere(card_route):
    """On the card's route K2 and K3 take (ring, src, n) and nothing is
    gathered; the 1x1 route to K1 and qmaxpool gather the window."""
    rng = np.random.default_rng(4)
    ring = ring_lanes(rng, 2, 7, 6, 8)
    win = ops.RingWindow(ring, 5, 5)
    rows = win.gather()
    card_route["gather"].clear()
    wd = qrand(rng, (3, 3, 8, 1))
    got = ops.qdwconv_fused(win, wd, stride=1, hpad=(1, 1), wpad=(1, 1),
                            **_QP)
    w3 = qrand(rng, (3, 3, 8, 4))
    got3 = ops.qconv_fused(win, w3, stride=2, hpad=(1, 0), wpad=(0, 1),
                           **_QP)
    assert card_route["gather"] == []
    assert card_route["qdwconv"] == [5] and card_route["qconv"] == [5]
    assert torch.equal(got, ref.qdwconv_ref(rows, wd[..., 0], stride=1,
                                            hpad=(1, 1), wpad=(1, 1), **_QP))
    assert torch.equal(got3, ref.qconv_ref(rows, w3, stride=2, hpad=(1, 0),
                                           wpad=(0, 1), **_QP))
    w1 = qrand(rng, (1, 1, 8, 3))
    got1 = ops.qconv_fused(win, w1, stride=1, **_QP)
    assert card_route["gather"] == [(2, 5, 6, 8)]
    assert card_route["qconv1x1"] == [None]
    assert torch.equal(got1, ref.qconv1x1_ref(rows, w1[0, 0], **_QP))
    op = types.SimpleNamespace(attrs={"k": 2, "stride": 2})
    pooled = cnn_ops._lower_qmaxpool(None, op, win, out=None)
    assert len(card_route["gather"]) == 2
    assert torch.equal(pooled, cnn_ops.qmaxpool2d(rows, 2, 2))


def test_cpu_route_gathers_before_the_plain_versions(monkeypatch):
    """Off the card a ring window is gathered, and the wrappers get a
    plain tensor."""
    calls = []
    real = ops.qdwconv
    monkeypatch.setattr(ops, "qdwconv", lambda x, *a, **kw:
                        calls.append(kw.get("n")) or real(x, *a, **kw))
    rng = np.random.default_rng(5)
    win = ops.RingWindow(ring_lanes(rng, 1, 5, 4, 8), 3, 4)
    assert not ops.reads_in_place(win)
    wd = qrand(rng, (3, 3, 8, 1))
    got = ops.qdwconv_fused(win, wd, stride=1, **_QP)
    assert calls == [None]
    assert torch.equal(got, ref.qdwconv_ref(win.gather(), wd[..., 0],
                                            stride=1, hpad=(1, 1),
                                            wpad=(1, 1), **_QP))


@pytest.mark.parametrize("strips", [None, (2,)])
def test_cascades_on_the_card_route_stay_bit_identical(strips, card_route):
    """MobileNet-0.25@96 int8 under a row cascade and a 2-D tiled cascade
    (``test_torch_cascade.py``'s graphs), with the card's routing: outputs
    equal the reference executor's, ``zero_copy_reads`` too, and every
    zero-copy window reaches K2/K3 as (ring, src, n) — gathered only for a
    qmaxpool or 1x1 consumer."""
    pf = mobilenet_v1_graph(0.25, 96)
    jq, pq = int8_twins(jax_mobilenet(0.25, 96), pf, random_input(pf))
    budget = int(0.5 * pq.graph.peak_usage(pq.graph.default_schedule()))
    kw = {} if strips is None else {"strips_choices": strips}
    jc = jax_cascade(jq.graph, budget=budget, **kw)
    pc = cascade_graph(pq.graph, budget=budget, **kw)
    ex = check_twin_executors(jc.graph, jc.graph.default_schedule(),
                              pc.graph, pc.graph.default_schedule(),
                              random_input(pq.graph, seed=6))
    g = pc.graph
    consumers = [g.consumers(t)[0] for t in ex._zc]
    gathered = [op for op in consumers if op.kind == "qmaxpool" or (
        op.kind == "qconv" and op.attrs["weight_q"].shape[0] == 1
        and op.attrs["stride"] == 1
        and tuple(op.attrs.get("pex_pads") or (0, 0)) == (0, 0)
        and tuple(op.attrs.get("pex_wpads") or (0, 0)) == (0, 0))]
    in_place = len(consumers) - len(gathered)
    assert ex.zero_copy_reads == len(consumers) > 0 and in_place > 0
    # one run in check_twin_executors: each window once
    assert len(card_route["gather"]) == len(gathered)
    ring_calls = [n for k in ("qdwconv", "qconv") for n in card_route[k]
                  if n is not None]
    assert len(ring_calls) == in_place


# ----------------------------------------------------------- K2's plans
H100_SMS = 132


@pytest.mark.parametrize("lanes", [1, 4])
def test_dw_tile_plan_covers_each_output_once(lanes):
    """Every output (pixel, channel) of every main-path shape and of odd
    ones lies in exactly one block's tile; a block has DW_THREADS threads,
    one channel each; a thread takes more than one pixel only where the
    grid still reaches DW_BLOCKS_PER_SM blocks an SM, and fewer only where
    a larger group would not."""
    shapes = [(96, 96, 32), (48, 48, 64), (48, 48, 128), (24, 24, 256),
              (12, 12, 512), (6, 6, 1024), (1, 26, 128), (2, 61, 32),
              (1, 1, 4), (3, 5, 12), (7, 9, 33), (96, 96, 9), (96, 96, 2),
              (48, 48, 20)]
    want = ops.DW_BLOCKS_PER_SM * H100_SMS
    for oh, ow, c in shapes:
        cq, gx, gy, ppt = ops.plan_dw_tile(lanes, oh, ow, c, H100_SMS)
        assert cq * gx * gy == ops.DW_THREADS
        assert cq & (cq - 1) == 0 and cq <= ops.DW_MAX_CHANNELS
        assert cq >= min(c, ops.DW_MAX_CHANNELS)
        assert ppt in (1, 2, 4)
        tw = gx * ppt
        cover = np.zeros((oh, ow, c), dtype=int)
        for ty in range(-(-oh // gy)):
            for tx in range(-(-ow // tw)):
                for cb in range(-(-c // cq)):
                    cover[ty * gy:(ty + 1) * gy, tx * tw:(tx + 1) * tw,
                          cb * cq:(cb + 1) * cq] += 1
        assert (cover == 1).all(), (oh, ow, c)
        tile, blocks = ops.dw_tile(lanes, oh, ow, c, ppt)
        assert tile == (cq, gx, gy, ppt)
        assert blocks == lanes * -(-oh // gy) * -(-ow // tw) * -(-c // cq)
        assert ppt == 1 or blocks >= want
        if ppt < 4:    # a larger group would have fallen short
            assert ops.dw_tile(lanes, oh, ow, c, 2 * ppt)[1] < want
        assert ops.dw_smem(*tile, 3, 2) < ops.DW_MAX_SMEM


def test_load_width_decider():
    """16-byte copies only where C and every pointer and stride are
    multiples of 16, 4-byte where of 4, else the scalar path: C 4/12/33,
    a misaligned view, a lane stride no multiple of 4."""
    assert ops.load_width(32, 4096, 221696) == 16
    assert ops.load_width(128, 4096 + 16, 0) == 16
    assert ops.load_width(12, 4096, 0) == 4
    assert ops.load_width(4, 4096, 64) == 4
    assert ops.load_width(32, 4096 + 4, 0) == 4
    assert ops.load_width(32, 4096, 221696 + 4) == 4
    assert ops.load_width(33, 4096, 0) == 1
    assert ops.load_width(32, 4096 + 1, 0) == 1
    assert ops.load_width(32, 4096, 37) == 1
    # both int8 MobileNet-1.0@192 arenas' lane pitches take 16 bytes
    for pitch in (221696, 884736):
        assert ops.load_width(64, 512, pitch) == 16


def dw_emulation(x, w, *, stride, hpad, wpad, mult, zp_in, zp_out,
                 sms=H100_SMS):
    """K2's arithmetic (``csrc/qdwconv.cu``) in plain torch: per block of
    ``plan_dw_tile``, the input tile with its halo staged with zp_in
    outside the input, ``Σx·w - zp_in·Σw`` per channel in int32, then the
    requantize epilogue."""
    lanes, h, wd, c = x.shape
    k = w.shape[0]
    oh = (h + hpad[0] + hpad[1] - k) // stride + 1
    ow = (wd + wpad[0] + wpad[1] - k) // stride + 1
    _, gx, gy, ppt = ops.plan_dw_tile(lanes, oh, ow, c, sms)
    tw = gx * ppt
    xp = torch.full((lanes, h + 2 * k * stride + gy * stride + hpad[0],
                     wd + 2 * k * stride + tw * stride + wpad[0], c),
                    zp_in, dtype=torch.int32)
    xp[:, hpad[0]:hpad[0] + h, wpad[0]:wpad[0] + wd] = x.to(torch.int32)
    wi = w.to(torch.int32)
    acc = torch.zeros((lanes, oh, ow, c), dtype=torch.int32)
    for oy0 in range(0, oh, gy):
        for ox0 in range(0, ow, tw):
            rows, cols = (gy - 1) * stride + k, (tw - 1) * stride + k
            tile = xp[:, oy0 * stride:oy0 * stride + rows,
                      ox0 * stride:ox0 * stride + cols]
            ny, nx = min(gy, oh - oy0), min(tw, ow - ox0)
            part = torch.zeros((lanes, ny, nx, c), dtype=torch.int32)
            for dy in range(k):
                for dx in range(k):
                    part += (tile[:, dy:dy + (ny - 1) * stride + 1:stride,
                                  dx:dx + (nx - 1) * stride + 1:stride]
                             * wi[dy, dx])
            acc[:, oy0:oy0 + ny, ox0:ox0 + nx] = part - zp_in * wi.sum((0, 1))
    return ref.requantize(acc, mult, zp_out, lo=zp_out)


@pytest.mark.parametrize("h,w,c,k,stride,hpad,wpad", [
    (9, 9, 32, 3, 1, (1, 1), (1, 1)), (5, 61, 32, 3, 1, (0, 0), (1, 1)),
    (6, 61, 64, 3, 2, (0, 1), (0, 1)), (7, 9, 12, 3, 2, (1, 1), (0, 2)),
    (6, 7, 33, 5, 1, (2, 2), (2, 2)), (4, 5, 4, 3, 1, (2, 0), (1, 1))])
@pytest.mark.parametrize("zp_in", [-128, 3, 127])
def test_dw_zero_point_formulation_is_bit_exact(h, w, c, k, stride, hpad,
                                                wpad, zp_in):
    """K2's tiles with a zp_in halo and ``Σx·w - zp_in·Σw`` give the plain
    version's int8 outputs bit for bit (wrapped windows, odd W at stride
    2, C 4/12/33, k = 5)."""
    rng = np.random.default_rng(h * w + c + k + zp_in + 128)
    x = qrand(rng, (2, h, w, c))
    wt = qrand(rng, (k, k, c))
    qp = dict(mult=0.004, zp_in=zp_in, zp_out=-3)
    want = ref.qdwconv_ref(x, wt, stride=stride, hpad=hpad, wpad=wpad, **qp)
    got = dw_emulation(x, wt, stride=stride, hpad=hpad, wpad=wpad, **qp)
    assert torch.equal(got, want)
