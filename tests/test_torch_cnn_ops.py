"""Every op of ``repro_torch.graphs.cnn_ops`` against its JAX twin on the
same numpy inputs: int8 ops bit-exact (round-half-even ties included),
float32 ops at ``rtol=2e-5, atol=1e-6`` (XLA CPU and torch CPU sum
convolutions in different orders — the tolerance of
``tests/test_executor_diff.py``), and the Pex row maps equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import cnn_ops as J

from repro_torch.graphs import cnn_ops as P

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

_F32 = dict(rtol=2e-5, atol=1e-6)
_PADS = [(None, None), ((0, 2), None), ((1, 0), (0, 1)), ((2, 1), (1, 2))]


def qrand(rng, shape):
    return rng.integers(-128, 128, size=shape, dtype=np.int8)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_requantize_including_exact_ties():
    rng = np.random.default_rng(0)
    acc = rng.integers(-40000, 40000, size=(7, 5, 6)).astype(np.int32)
    for mult, zp, lo in [(0.0123, -5, -5), (0.5, 3, -128), (0.25, 0, 0),
                         (1.5, -7, -7), (3e-5, 11, -128)]:
        _eq(P.requantize(torch.as_tensor(acc), mult, zp, lo=lo),
            J.requantize(jnp.asarray(acc), mult, zp, lo=lo))


def test_quantize_dequantize_arrays():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((9, 7, 4)) * 3).astype(np.float32)
    x.flat[:4] = [0.05, -0.05, 0.15, 2.5]        # exact .5 ties at 0.1
    for scale, zp in [(0.1, 0), (0.037, -9), (0.5, 4)]:
        _eq(P.quantize_array(torch.as_tensor(x), scale, zp),
            J.quantize_array(jnp.asarray(x), scale, zp))
        q = qrand(rng, (9, 7, 4))
        _eq(P.dequantize_array(torch.as_tensor(q), scale, zp),
            J.dequantize_array(jnp.asarray(q), scale, zp))


@pytest.mark.parametrize("hpad,wpad", _PADS)
@pytest.mark.parametrize("k,stride", [(2, 2), (3, 1), (3, 2)])
def test_qmaxpool2d(k, stride, hpad, wpad):
    rng = np.random.default_rng(2)
    x = qrand(rng, (9, 8, 3))
    _eq(P.qmaxpool2d(torch.as_tensor(x), k, stride, hpad=hpad, wpad=wpad),
        J.qmaxpool2d(jnp.asarray(x), k, stride, hpad=hpad, wpad=wpad))


def test_qadd_including_integer_ties():
    rng = np.random.default_rng(3)
    a, b = qrand(rng, (8, 6, 5)), qrand(rng, (8, 6, 5))
    # mult 0.5 on one leg and 0 on the other: every odd (a - zp_a) is an
    # exact half after the fixed-point shift
    for args in [(0.37, 0.61, 3, -2, 5), (0.5, 0.0, 1, 0, 0),
                 (0.5, 0.25, -4, 7, -3), (1.25, 0.75, 0, 0, 0)]:
        _eq(P.qadd(torch.as_tensor(a), torch.as_tensor(b), *args),
            J.qadd(jnp.asarray(a), jnp.asarray(b), *args))


def test_qavgpool_qfc_qconcat():
    rng = np.random.default_rng(4)
    x = qrand(rng, (6, 6, 10))
    _eq(P.qavgpool(torch.as_tensor(x)), J.qavgpool(jnp.asarray(x)))
    # a 2x2 map: means land on .25/.5/.75 — the .5s exercise the tie rule
    x2 = qrand(rng, (2, 2, 64))
    _eq(P.qavgpool(torch.as_tensor(x2)), J.qavgpool(jnp.asarray(x2)))
    w = qrand(rng, (6 * 6 * 10, 7))
    _eq(P.qfc(torch.as_tensor(x), torch.as_tensor(w), 0.0021, 3, -4),
        J.qfc(jnp.asarray(x), jnp.asarray(w), 0.0021, 3, -4))
    y = qrand(rng, (6, 6, 3))
    kw = dict(mults=(0.7, 1.5), zps=(2, -3), zp_out=1)
    _eq(P.qconcat(torch.as_tensor(x), torch.as_tensor(y), **kw),
        J.qconcat(jnp.asarray(x), jnp.asarray(y), **kw))


def test_batched_int8_ops_equal_per_lane():
    """The executor hands ops [lanes, H, W, C]; each lane must equal the
    unbatched op."""
    rng = np.random.default_rng(5)
    xs = qrand(rng, (3, 6, 6, 4))
    ys = qrand(rng, (3, 6, 6, 4))
    w = qrand(rng, (6 * 6 * 4, 3))
    batched = [P.qmaxpool2d(torch.as_tensor(xs), 3, 2),
               P.qadd(torch.as_tensor(xs), torch.as_tensor(ys),
                      0.4, 0.6, 1, 2, 3),
               P.qavgpool(torch.as_tensor(xs)),
               P.qfc(torch.as_tensor(xs), torch.as_tensor(w), 0.01, 1, 2)]
    for b in range(3):
        x, y = torch.as_tensor(xs[b]), torch.as_tensor(ys[b])
        lanes = [P.qmaxpool2d(x, 3, 2), P.qadd(x, y, 0.4, 0.6, 1, 2, 3),
                 P.qavgpool(x), P.qfc(x, torch.as_tensor(w), 0.01, 1, 2)]
        for got, want in zip(batched, lanes):
            _eq(got[b], want)


@pytest.mark.parametrize("hpad,wpad", _PADS)
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2)])
def test_f32_conv_dwconv_maxpool(k, stride, hpad, wpad):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((9, 8, 3)).astype(np.float32)
    w = (rng.standard_normal((k, k, 3, 5)) * 0.3).astype(np.float32)
    wd = (rng.standard_normal((k, k, 3, 1)) * 0.3).astype(np.float32)
    tx = torch.as_tensor(x)
    np.testing.assert_allclose(
        P.conv2d(tx, w, stride, hpad=hpad, wpad=wpad).numpy(),
        np.asarray(J.conv2d(jnp.asarray(x), w, stride, hpad=hpad,
                            wpad=wpad)), **_F32)
    np.testing.assert_allclose(
        P.dwconv2d(tx, wd, stride, hpad=hpad, wpad=wpad).numpy(),
        np.asarray(J.dwconv2d(jnp.asarray(x), wd, stride, hpad=hpad,
                              wpad=wpad)), **_F32)
    if k > 1:
        np.testing.assert_array_equal(
            P.maxpool2d(tx, k, stride, hpad=hpad, wpad=wpad).numpy(),
            np.asarray(J.maxpool2d(jnp.asarray(x), k, stride, hpad=hpad,
                                   wpad=wpad)))


def test_f32_fc_and_avgpool():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 4, 6)).astype(np.float32)
    w = rng.standard_normal((96, 5)).astype(np.float32)
    # the reference's fc has no free function: this is its closure's body
    # (graphs/cnn_ops.py, CNNBuilder.fc)
    want = jnp.sum(jnp.reshape(x, (-1, 1)) * w, axis=0)[None, None, :]
    np.testing.assert_allclose(P.fc(torch.as_tensor(x), w).numpy(),
                               np.asarray(want), **_F32)
    np.testing.assert_allclose(
        P.avgpool(torch.as_tensor(x)).numpy(),
        np.asarray(jnp.mean(jnp.asarray(x), axis=(0, 1), keepdims=True)),
        **_F32)


@pytest.mark.parametrize("kind", ["conv", "dwconv", "maxpool", "add",
                                  "qconv", "qdwconv", "qmaxpool", "qadd",
                                  "concat", "avgpool", "fc", "qfc"])
def test_pex_spec_row_maps_equal(kind):
    for out_shape, cin, k, stride in [((12, 10, 8), 4, 3, 2),
                                      ((5, 5, 16), 16, 1, 1),
                                      ((7, 9, 3), 3, 5, 1)]:
        js = J.pex_spec(kind, out_shape, cin, k, stride)
        ps = P.pex_spec(kind, out_shape, cin, k, stride)
        if js is None:
            assert ps is None
            continue
        strip = {f.name for f in dataclasses.fields(js)} - {"make_fn"}
        assert {f: getattr(ps, f) for f in strip} == \
            {f: getattr(js, f) for f in strip}
        assert (ps.make_fn is None) == (js.make_fn is None)


def test_grow_kernel_is_the_reference_edit_and_function_preserving():
    """Receptive-field growth (the planner's ``rf_redistribute`` leg)
    zero-embeds the same weights as the reference and leaves the int8
    outputs bit-identical."""
    from repro.core.graph import Graph as JaxGraph
    from repro_torch.core.graph import Graph
    from repro_torch.graphs import random_input
    from repro_torch.mcu.compile import compile_schedule

    from test_torch_params import int8_twins

    def chain(graph_cls, builder_cls):
        g = graph_cls()
        b = builder_cls(g)
        x = b.input("input", 12, 12, 4)
        x = b.conv(x, 8, k=3)
        x = b.dwconv(x, k=3, stride=2)
        x = b.conv(x, 6, k=1)
        g.set_outputs([x])
        return g

    pf = chain(Graph, P.CNNBuilder)
    jq, pq = int8_twins(chain(JaxGraph, J.CNNBuilder), pf, random_input(pf))
    jg = J.grow_kernel(jq.graph, "dwconv2", 5)
    pg = P.grow_kernel(pq.graph, "dwconv2", 5)
    np.testing.assert_array_equal(pg.op_by_name("dwconv2").attrs["weight_q"],
                                  np.asarray(jg.op_by_name("dwconv2")
                                             .attrs["weight_q"]))
    assert pg.op_by_name("dwconv2").attrs["k"] == 5
    x = random_input(pq.graph, seed=3)
    base = compile_schedule(pq.graph, device="cpu").run(x)
    grown = compile_schedule(pg, device="cpu").run(x)
    for o in pg.outputs:
        np.testing.assert_array_equal(grown[o], base[o])
