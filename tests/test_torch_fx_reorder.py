"""The paper's reordering over traced PyTorch programs
(``repro_torch.core.fx_reorder``), on the CPU.

* On programs whose aten trace maps one to one onto the reference's
  jaxpr (no view, no multi-output node), the port's scheduling ``Graph``
  equals the reference's ``jaxpr_to_graph`` (tensor sizes, edges,
  outputs) and the reordered peaks equal ``reorder_closed_jaxpr``'s.
* The view rule, multi-output bundles and input mutation each have their
  own test.
* The reordered module's outputs are bit-identical to eager torch (the
  reference's ``tests/test_jaxpr_reorder.py``, held against eager torch),
  ``peak_after <= peak_before`` and the report's peak is the emitted
  module's ``peak_liveness``.
* A port kernel reached while ``make_fx`` traces raises ``TraceError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from torch.fx.experimental.proxy_tensor import make_fx

from repro.core.jaxpr_reorder import jaxpr_to_graph
from repro.core.jaxpr_reorder import peak_liveness as jax_peak_liveness
from repro.core.jaxpr_reorder import reorder_closed_jaxpr

from repro_torch.core import fx_reorder
from repro_torch.core.fx_reorder import (fx_to_graph, peak_liveness, reorder,
                                         reorder_graph_module, trace)
from repro_torch.errors import TraceError
from repro_torch.kernels.build import KernelSet

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)


def branchy_fn(x):
    """``tests/test_jaxpr_reorder.py``'s Figure-1-shaped program:
    expensive branch traced first."""
    t1 = torch.tanh(x)                    # big
    a = t1 @ t1.T                         # branch A: big intermediates
    a = torch.tanh(a)
    a = a.sum(dim=1)
    b = t1.sum(dim=1)                     # branch B: tiny
    return a + b


# one-to-one programs: (jax version, torch version, argument shapes)
ONE_TO_ONE = {
    "chain": (lambda x, w, b: (jnp.tanh(x) @ w).sum(axis=1) + b,
              lambda x, w, b: (torch.tanh(x) @ w).sum(dim=1) + b,
              [(64, 32), (32, 16), (64,)]),
    "two_branches": (
        lambda x: jnp.tanh(x).sum(axis=1) + jnp.exp(x).sum(axis=1),
        lambda x: torch.tanh(x).sum(dim=1) + torch.exp(x).sum(dim=1),
        [(128, 96)]),
    "branchy_no_view": (
        lambda x, w: jnp.tanh(jnp.tanh(x) @ w).sum(axis=1)
        + jnp.tanh(x).sum(axis=1),
        lambda x, w: torch.tanh(torch.tanh(x) @ w).sum(dim=1)
        + torch.tanh(x).sum(dim=1),
        [(128, 128), (128, 128)]),
    "two_matmuls": (
        lambda x, w1, w2: (x @ w1).sum(axis=1) * (x @ w2).sum(axis=1),
        lambda x, w1, w2: (x @ w1).sum(dim=1) * (x @ w2).sum(dim=1),
        [(64, 32), (32, 256), (32, 256)]),
    "mlp": (lambda x, w1, w2: jnp.tanh(x @ w1) @ w2,
            lambda x, w1, w2: torch.tanh(x @ w1) @ w2,
            [(256, 32), (32, 512), (512, 32)]),
}


def _args(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _canon(g):
    """A graph up to tensor and operator names: tensor sizes in insertion
    order, each operator's input and output positions, the outputs."""
    idx = {n: i for i, n in enumerate(g.tensors)}
    return ([t.size for t in g.tensors.values()],
            [(tuple(idx[i] for i in op.inputs), idx[op.output])
             for op in g.operators],
            [idx[o] for o in g.outputs])


@pytest.mark.parametrize("name", sorted(ONE_TO_ONE))
@pytest.mark.parametrize("shard_divisor", [1, 8])
def test_graph_and_peaks_equal_the_reference(name, shard_divisor):
    fj, ft, shapes = ONE_TO_ONE[name]
    args = _args(shapes)
    closed = jax.make_jaxpr(fj)(*args)
    gm, leaves = trace(ft, *[torch.as_tensor(a) for a in args])
    jg, _ = jaxpr_to_graph(closed.jaxpr, shard_divisor)
    pg = fx_to_graph(gm, shard_divisor).graph
    assert _canon(pg) == _canon(jg)
    assert peak_liveness(gm, shard_divisor) == \
        jax_peak_liveness(closed, shard_divisor)
    _, jrep = reorder_closed_jaxpr(closed, shard_divisor)
    new_gm, rep = reorder_graph_module(gm, shard_divisor)
    assert (rep.n_eqns, rep.peak_before, rep.peak_after, rep.changed) == \
        (jrep.n_eqns, jrep.peak_before, jrep.peak_after, jrep.changed)
    assert peak_liveness(new_gm, shard_divisor) == rep.peak_after
    want = ft(*[torch.as_tensor(a) for a in args])
    assert torch.equal(new_gm(*leaves), want)


def test_reorder_reduces_peak_on_branchy_fn():
    gm, _ = trace(branchy_fn, torch.ones((128, 128)))
    new_gm, rep = reorder_graph_module(gm)
    assert rep.peak_after < rep.peak_before and rep.changed
    assert peak_liveness(new_gm) == rep.peak_after
    assert "fx reorder: 6 ops" in str(rep)


def test_reorder_numerics_bit_identical():
    x = torch.as_tensor(np.random.default_rng(0)
                        .standard_normal((64, 64)).astype(np.float32))
    reports = []
    got = reorder(branchy_fn, report_to=reports)(x)
    assert torch.equal(got, branchy_fn(x))
    assert reports[0].peak_after <= reports[0].peak_before


def test_view_rule():
    """A view is no operator: its uses are its base's, it keeps its base
    alive, and it is re-emitted right after its base."""
    def fn(x):
        t = torch.tanh(x)
        v = t.T                   # permute: a view of t
        flat = t.view(-1)         # view
        big = torch.exp(x) * 2.0
        return big.sum() + flat[:8].sum() + v[0].sum()   # slice, select

    x = torch.randn(16, 16)
    gm, leaves = trace(fn, x)
    views = [n for n in gm.graph.nodes if fx_reorder.is_view(n)]
    assert {str(n.target) for n in views} == {
        "aten.permute.default", "aten.view.default", "aten.slice.Tensor",
        "aten.select.int"}
    fg = fx_to_graph(gm)
    computing = [n for n in gm.graph.nodes if n.op == "call_function"
                 and n not in views]
    assert len(fg.graph.operators) == len(computing)
    tanh = next(n for n in computing if n.target is torch.ops.aten.tanh.default)
    for v in views:
        assert fg.tensor_of[v] == fg.tensor_of[tanh]
    # the last sum reads t through three views: t lives until then
    last_sum = [op for op in fg.graph.operators if "sum" in op.kind][-1]
    assert fg.tensor_of[tanh] in last_sum.inputs
    new_gm, rep = reorder_graph_module(gm)
    assert rep.changed            # exp's branch first, then tanh's
    nodes = list(new_gm.graph.nodes)

    def base_of(m):
        return fx_reorder.alias_base(m) if m.op == "call_function" else None

    def aliases(m, b):                      # m is a view of (a view of) b
        while (m := base_of(m)) is not None:
            if m is b:
                return True
        return False

    for n in nodes:
        base = base_of(n)
        if base is not None:     # only other views of base in between
            i, j = nodes.index(base), nodes.index(n)
            assert i < j and all(aliases(m, base) for m in nodes[i + 1:j])
    assert torch.equal(new_gm(*leaves), fn(x))


def test_unsafe_view_is_a_view():
    """Reshaping a transposed tensor traces as clone, then _unsafe_view of
    the clone, whose schema declares no alias: it is a view all the
    same, and the clone an operator."""
    def fn(x):
        return torch.tanh(x).T.reshape(-1) * 2.0

    gm, leaves = trace(fn, torch.randn(6, 4))
    kinds = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert "aten._unsafe_view.default" in kinds and "aten.clone.default" in kinds
    fg = fx_to_graph(gm)
    assert [op.kind for op in fg.graph.operators] == [
        "aten.tanh.default", "aten.clone.default", "aten.mul.Tensor"]
    assert torch.equal(reorder(fn)(*leaves), fn(*leaves))


def test_reorder_handles_multi_output_nodes():
    """``max`` over a dim returns (values, indices): one bundle tensor of
    both, its getitems aliases of it."""
    def fn(x):
        vals, idx = torch.max(torch.tanh(x), dim=1)
        return vals.sum() + idx.sum() + torch.exp(x).sum()

    x = torch.randn(32, 8)
    gm, leaves = trace(fn, x)
    fg = fx_to_graph(gm)
    mx = next(n for n in gm.graph.nodes
              if n.target is torch.ops.aten.max.dim)
    getitems = [n for n in gm.graph.nodes if n.args and n.args[0] is mx]
    assert len(getitems) == 2
    assert {fg.tensor_of[n] for n in getitems} == {fg.tensor_of[mx]}
    assert fg.graph.tensors[fg.tensor_of[mx]].size == 32 * 4 + 32 * 8
    assert torch.equal(reorder(fn)(x), fn(x))


def test_reorder_pytree_outputs():
    def fn(x):
        return {"a": x * 2, "b": (x + 1, x.sum())}

    x = torch.arange(12.0).reshape(3, 4)
    got = reorder(fn)(x)
    want = fn(x)
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["b"][0], want["b"][0])
    assert torch.equal(got["b"][1], want["b"][1])


def test_input_mutation_writes_back_last():
    """functionalize turns ``c.add_`` into an add and a trailing copy_:
    the copy stays after every reader, the add's result is an output of
    the scheduling graph, and the reordered module mutates its input as
    eager torch does."""
    def fn(x, c):
        c.add_(x.sum())
        y = torch.exp(x).sum(dim=1)
        return torch.tanh(x).sum(dim=1) + y + c.sum()

    x = torch.randn(16, 8)
    c_eager, c_fx = torch.zeros(3), torch.zeros(3)
    want = fn(x, c_eager)
    gm, _ = trace(fn, x, torch.zeros(3))
    fg = fx_to_graph(gm)
    assert [str(w.target) for w in fg.writebacks] == ["aten.copy_.default"]
    assert fg.mutation is None
    assert fg.tensor_of[fg.writebacks[0].args[1]] in fg.graph.outputs
    new_gm, rep = reorder_graph_module(gm)
    assert rep.method != "skipped-mutation"
    body = [n for n in new_gm.graph.nodes if n.op != "output"]
    assert body[-1].target is torch.ops.aten.copy_.default
    assert torch.equal(new_gm(x, c_fx), want)
    assert torch.equal(c_fx, c_eager)


def test_unfunctionalized_mutation_is_skipped():
    def fn(x):
        y = torch.tanh(x)
        y.mul_(2.0)
        return y.sum() + torch.exp(x).sum()

    gm = make_fx(fn)(torch.randn(8, 8))
    new_gm, rep = reorder_graph_module(gm)
    assert new_gm is gm
    assert rep.method == "skipped-mutation" and not rep.changed
    assert rep.peak_before == rep.peak_after == peak_liveness(gm)


def test_shard_divisor_scales_sizes():
    gm, _ = trace(branchy_fn, torch.ones((128, 128)))
    p1 = peak_liveness(gm, shard_divisor=1)
    p8 = peak_liveness(gm, shard_divisor=8)
    assert p1 > p8 >= p1 // 8


@given(st.integers(0, 500))
@settings(max_examples=20, deadline=None)
def test_random_programs_bit_identical(seed):
    """The reference's random-program test, held against eager torch bit
    for bit."""
    def make(seed):
        rng = np.random.default_rng(seed)

        def fn(x):
            vals = [x]
            for _ in range(6):
                pick = vals[int(rng.integers(len(vals)))]
                choice = int(rng.integers(4))
                if choice == 0:
                    vals.append(torch.tanh(pick))
                elif choice == 1:
                    vals.append(pick * 1.5 + 1.0)
                elif choice == 2:
                    other = vals[int(rng.integers(len(vals)))]
                    vals.append(pick + other)
                else:
                    vals.append(pick.sum(dim=(0, 1), keepdim=True)
                                * torch.ones_like(pick))
            return sum(v.sum() for v in vals)
        return fn

    x = torch.as_tensor(np.random.default_rng(seed + 1)
                        .standard_normal((16, 16)).astype(np.float32))
    reports = []
    got = reorder(make(seed), report_to=reports)(x)
    assert torch.equal(got, make(seed)(x))
    assert reports[0].peak_after <= reports[0].peak_before


def test_a_kernel_reached_while_tracing_raises():
    """A ctypes launch fills its output through ``data_ptr``; under
    ``make_fx`` that write would be lost, so the launch refuses (a fake
    launch function stands in for a built kernel)."""
    calls = []
    ks = KernelSet(None, {"fake": []})
    ks._fns["fake"] = lambda *args: calls.append(args) or 0

    def program(x):
        out = torch.empty_like(x)
        ks.launch("fake", out.data_ptr())
        return out + 1

    x = torch.ones(4)
    program(x)                       # eager: launches
    assert len(calls) == 1
    with pytest.raises(TraceError, match="fake reached while make_fx"):
        make_fx(program)(x)
    with pytest.raises(TraceError):
        reorder(program)(x)
    assert len(calls) == 1           # no launch under the trace
