"""K3/K5's formulation on the int8 tensor cores (``csrc/qconv.cuh``),
emulated in plain torch on the CPU: per block of 64 output pixels, the
input patch staged with zp_in outside the input (rows read through the
ring mapping), taps padded with zeros to 32-deep K-steps, the A tile
gathered through the per-K offset table, ``Σx·w - zp_in·Σw`` in int32 over
the planner's Cin chunks.  It must equal ``qconv_ref`` and
``qconv_add_ref`` bit for bit over hypothesis-drawn shapes: the stem and
its Pex slices with asymmetric pads, Cin 1, 3 and 40, Cout 5, 32 and 72,
strides 1 and 2, k 1, 3 and 5, ring windows.  Also the tile planner
``ops.plan_qconv``."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.conv_quant import ops, ref

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ADD = (0.71, 0.39, None, 2, -7)     # (mult_a, mult_b, zp_a, zp_b, zp_out)


def mma_emulation(x, w, *, stride, hpad, wpad, zp_in, src=0, n=None,
                  ck=None):
    """K3's int32 accumulators [lanes, OH, OW, Cout] as the kernel forms
    them; ``x`` is [lanes, ring_rows, W, Cin], the input its window (src,
    n) (default: all of x); ``ck`` overrides the planner's Cin chunk."""
    lanes, ring_rows, W, cin = x.shape
    H = ring_rows if n is None else n
    k, cout = w.shape[0], w.shape[3]
    OH = (H + hpad[0] + hpad[1] - k) // stride + 1
    OW = (W + wpad[0] + wpad[1] - k) // stride + 1
    _, plan_ck = ops.plan_qconv(OH, OW, cin, cout, k, stride)
    ck = ck or plan_ck
    M, BM, KS = OH * OW, ops.QC_BM, ops.QC_KSTEP
    xi, wi = x.to(torch.int64), w.to(torch.int64)
    acc = torch.zeros((lanes, M, cout), dtype=torch.int64)
    for m0 in range(0, M, BM):
        m_last = min(M, m0 + BM) - 1
        oy_a, oy_b = m0 // OW, m_last // OW
        ox_lo = m0 % OW if oy_a == oy_b else 0
        ox_hi = m_last % OW if oy_a == oy_b else OW - 1
        rows_in = (oy_b - oy_a) * stride + k
        cols_in = (ox_hi - ox_lo) * stride + k
        # within the rows x cols the launch reserves (ops.qconv_smem)
        assert rows_in <= (min(OH, (BM - 1) // OW + 2) - 1) * stride + k
        assert cols_in <= (OW - 1) * stride + k
        iy0, ix0 = oy_a * stride - hpad[0], ox_lo * stride - wpad[0]
        m = torch.arange(m0, m_last + 1)
        prow = (m // OW - oy_a) * stride       # each output's first tap
        pcol = (m % OW - ox_lo) * stride
        for c0 in range(0, cin, ck):
            ckc = min(ck, cin - c0)
            kc = k * k * ckc
            kcp = -(-kc // KS) * KS
            pitch = -(-cols_in * ckc // 16) * 16   # patch rows of 16 B
            patch = torch.full((lanes, rows_in, pitch), zp_in,
                               dtype=torch.int64)
            for r in range(rows_in):
                iy = iy0 + r
                if not 0 <= iy < H:
                    continue
                lo, hi = max(0, -ix0), min(cols_in, W - ix0)
                if lo < hi:
                    patch[:, r, lo * ckc:hi * ckc] = xi[
                        :, (src + iy) % ring_rows, ix0 + lo:ix0 + hi,
                        c0:c0 + ckc].reshape(lanes, -1)
            kk = torch.arange(kcp)
            tap, cl = kk // ckc, kk % ckc
            offs = torch.where(kk < kc, (tap // k) * pitch + (tap % k) * ckc
                               + cl, 0)
            b = torch.zeros((kcp, cout), dtype=torch.int64)
            b[:kc] = wi[:, :, c0:c0 + ckc].reshape(kc, cout)
            base = prow * pitch + pcol * ckc
            a = patch.reshape(lanes, -1)[:, base[:, None] + offs]
            # the column sums: each output column's weights over every K
            acc[:, m0:m_last + 1] += a @ b - zp_in * b.sum(0)
    assert acc.abs().max() < 2 ** 31
    return acc.to(torch.int32).reshape(lanes, OH, OW, cout)


def qrand(rng, shape):
    return torch.as_tensor(rng.integers(-128, 128, size=shape,
                                        dtype=np.int8))


def check(rng, h, w, cin, cout, k, stride, hpad, wpad, zp_in, ring=None,
          ck=None, lanes=2):
    """Emulation == plain version for K3 and K5; ``ring = (ring_rows,
    src)`` reads the input as that window of a ring."""
    if ring is None:
        x = qrand(rng, (lanes, h, w, cin))
        win, rk = x, {}
    else:
        rows, src = ring
        x = qrand(rng, (lanes, rows, w, cin))
        win, rk = ref.ring_window(x, src, h), dict(src=src, n=h)
    wt = qrand(rng, (k, k, cin, cout))
    qp = dict(stride=stride, hpad=hpad, wpad=wpad, mult=0.6 / (k * k * cin),
              zp_in=zp_in, zp_out=-3)
    acc = mma_emulation(x, wt, stride=stride, hpad=hpad, wpad=wpad,
                        zp_in=zp_in, ck=ck, **rk)
    got = ref.requantize(acc, qp["mult"], qp["zp_out"], lo=qp["zp_out"])
    want = ref.qconv_ref(win, wt, **qp)
    assert torch.equal(got, want)
    assert torch.equal(ops.qconv(x, wt, **rk, **qp), want)
    r = qrand(rng, tuple(want.shape))
    ap = (ADD[0], ADD[1], qp["zp_out"], ADD[3], ADD[4])
    assert torch.equal(ref.qadd(got, r, *ap),
                       ref.qconv_add_ref(win, wt, r, add_params=ap, **qp))


# the stem of MobileNet-v1 1.0@192 and its Pex / 2-D tile slices on the
# path, (H, W, Cin, Cout, k, stride, hpad, wpad)
STEM = [(192, 192, 3, 32, 3, 2, (0, 1), (0, 1)),
        (9, 125, 3, 32, 3, 2, (0, 0), (0, 1)),
        (9, 110, 3, 32, 3, 2, (0, 0), (1, 1)),
        (19, 192, 3, 32, 3, 2, (0, 0), (0, 1))]


@pytest.mark.parametrize("case", STEM)
def test_stem_and_its_slices(case):
    """The path's K3 shapes, each as a plain input and as a ring window
    that wraps."""
    h, w, cin, cout, k, stride, hpad, wpad = case
    rng = np.random.default_rng(h + w)
    check(rng, *case, zp_in=-128 if h > 100 else 5, lanes=1)
    if h < 100:
        check(rng, *case, zp_in=7, ring=(h + 3, h + 1))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_tensor_core_formulation_is_bit_exact(data):
    """Hypothesis-drawn shapes: Cin 1/3/40 (K > 32), Cout 5/32/72 (not a
    multiple of 8, two N tiles), stride 1/2, k 1/3/5 with asymmetric pads,
    zero points at both ends, ring windows, forced Cin chunks."""
    d = data.draw
    k = d(st.sampled_from([1, 3, 5]))
    stride = d(st.sampled_from([1, 2]))
    cin = d(st.sampled_from([1, 3, 40]))
    cout = d(st.sampled_from([5, 32, 72]))
    h = d(st.integers(k, k + 9))
    w = d(st.integers(k, k + 70))
    hpad = (d(st.integers(0, k - 1)), d(st.integers(0, k - 1)))
    wpad = (d(st.integers(0, k - 1)), d(st.integers(0, k - 1)))
    zp_in = d(st.sampled_from([-128, -1, 0, 9, 127]))
    ring = d(st.sampled_from([None, (h, 0), (h + 2, h + 5), (h + 1, 2)]))
    ck = d(st.sampled_from([None, 1, max(1, cin // 3)]))
    seed = d(st.integers(0, 2 ** 16))
    check(np.random.default_rng(seed), h, w, cin, cout, k, stride, hpad,
          wpad, zp_in, ring=ring, ck=ck)


def test_qconv_plan():
    """The N tile is the smallest of 8/16/32/64 that holds Cout (64
    beyond); Cin stays whole where the block's shared memory fits
    QC_SMEM, else the chunk is the largest halving of it that fits; the
    stem's plan is (32, 3) in 4 624 bytes."""
    assert ops.plan_qconv(96, 96, 3, 32, 3, 2) == (32, 3)
    assert ops.qconv_smem(96, 96, 3, 2, 3, 32) == 4624
    for cout, bn in ((1, 8), (5, 8), (9, 16), (32, 32), (33, 64), (72, 64),
                     (1024, 64)):
        assert ops.plan_qconv(4, 62, 3, cout, 3, 2)[0] == bn
    for oh, ow, cin, k, s in ((96, 96, 3, 3, 2), (48, 48, 512, 3, 1),
                              (6, 6, 1024, 3, 1), (1, 200, 2048, 5, 2),
                              (12, 12, 40, 5, 1)):
        bn, ck = ops.plan_qconv(oh, ow, cin, 64, k, s)
        assert 1 <= ck <= cin
        assert ops.qconv_smem(oh, ow, k, s, ck, bn) <= ops.QC_SMEM
        if ck < cin:
            assert ops.qconv_smem(oh, ow, k, s, 2 * ck, bn) > ops.QC_SMEM
