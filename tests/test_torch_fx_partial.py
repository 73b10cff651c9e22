"""Partial execution over traced PyTorch programs
(``repro_torch.core.fx_partial``), on the CPU.

The reference's jaxpr Pex tests (``tests/test_partition.py``'s
``test_jaxpr_*``) fail on this JAX (ROADMAP R3: the rewrite builds its
``Var``s with a retired signature), so their intent is held here against
eager torch, and the parts of the reference that still run — the run
finder and the per-k peak estimate — are held equal to the port's on the
same MLP.

* elementwise and reduce slices are bit-identical to the whole op;
* a sliced ``mm``/``addmm`` is within float accumulation tolerance
  (``rtol=2e-6, atol=1e-6``, the reference test's);
* the accumulator is charged once: each ``write_rows`` is in place on it;
* ``reorder_graph_module(partition_budget=...)`` keeps the lower peak
  (``+pex``); anything unrecognised is left unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.core.jaxpr_partial import _estimate_run as jax_estimate_run
from repro.core.jaxpr_partial import _find_runs as jax_find_runs

from repro_torch.core.fx_partial import (_estimate_run, _find_runs, _rewrite,
                                         partial_execute_graph_module,
                                         write_rows)
from repro_torch.core.fx_reorder import (fx_to_graph, peak_liveness,
                                         reorder_graph_module, trace)

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

MM_TOL = dict(rtol=2e-6, atol=1e-6)


def _mlp(seed):
    """The reference test's MLP: a fat (256, 512) interior."""
    rng = np.random.default_rng(seed)
    w1 = torch.as_tensor(rng.standard_normal((32, 512)).astype(np.float32))
    w2 = torch.as_tensor(rng.standard_normal((512, 32)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((256, 32)).astype(np.float32))
    return (lambda x: torch.tanh(x @ w1) @ w2), x


def test_partial_execution_mlp():
    mlp, x = _mlp(0)
    gm, leaves = trace(mlp, x)
    pgm, n_runs = partial_execute_graph_module(gm)
    assert n_runs == 1
    assert peak_liveness(pgm) < peak_liveness(gm)
    torch.testing.assert_close(pgm(*leaves), mlp(x), **MM_TOL)


def test_runs_and_estimates_equal_the_reference():
    """The MLP's trace maps one to one onto the reference's jaxpr: the
    same run, and the same estimated peak for every k."""
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(s).astype(np.float32)
            for s in [(256, 32), (32, 512), (512, 32)]]
    closed = jax.make_jaxpr(lambda x, a, b: jnp.tanh(x @ a) @ b)(*args)
    gm, _ = trace(lambda x, a, b: torch.tanh(x @ a) @ b,
                  *[torch.as_tensor(a) for a in args])
    (jrun,) = jax_find_runs(closed.jaxpr)
    (run,) = _find_runs(gm)
    assert [closed.jaxpr.eqns[i].primitive.name for i in jrun] == \
        ["dot_general", "tanh", "dot_general"]
    assert [str(n.target) for n in run] == \
        ["aten.mm.default", "aten.tanh.default", "aten.mm.default"]
    for k in (2, 4, 8, 16):
        for div in (1, 8):
            assert _estimate_run(run, k, div) == jax_estimate_run(
                [closed.jaxpr.eqns[i] for i in jrun], k, div)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("which", ["exp_tanh", "sum", "amax", "amin",
                                   "prod", "clamp"])
def test_elementwise_and_reduce_slicing_bit_identical(which, k):
    """Every run of the program split into k slices, whether or not the
    estimate would choose it (the reference test expands its run
    directly too)."""
    def f(x):
        y = torch.exp(torch.tanh(x))
        if which == "sum":
            return y.sum(dim=1) + 1.0
        if which == "amax":
            return torch.amax(y * 0.5, dim=-1)
        if which == "amin":
            return torch.amin(y, dim=(1, 2), keepdim=True)
        if which == "prod":
            return torch.prod(y * 0.9, dim=2)
        if which == "clamp":
            return torch.clamp(y, 0.5, 2.0) - 1.0
        return y

    x = torch.as_tensor(np.random.default_rng(1)
                        .standard_normal((64, 16, 3)).astype(np.float32))
    gm, leaves = trace(f, x)
    (run,) = _find_runs(gm)
    assert len(run) == len([n for n in gm.graph.nodes
                            if n.op == "call_function"])
    pgm = _rewrite(gm, {run[-1]: (run, k)})
    assert sum(n.target is write_rows for n in pgm.graph.nodes) == k
    assert torch.equal(pgm(*leaves), f(x))


def test_addmm_bias_is_taken_whole():
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.standard_normal((512, 32)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((512,)).astype(np.float32))

    def f(x):
        return torch.relu(torch.nn.functional.linear(x, w, b)).sum(dim=1)

    x = torch.as_tensor(rng.standard_normal((128, 32)).astype(np.float32))
    gm, leaves = trace(f, x)
    assert any(n.target is torch.ops.aten.addmm.default
               for n in gm.graph.nodes)
    pgm, n_runs = partial_execute_graph_module(gm)
    assert n_runs == 1
    torch.testing.assert_close(pgm(*leaves), f(x), **MM_TOL)


def test_the_accumulator_is_charged_once():
    """Every write_rows is in place on the accumulator, in the scheduling
    graph and in eager torch."""
    mlp, x = _mlp(0)
    gm, leaves = trace(mlp, x)
    pgm, _ = partial_execute_graph_module(gm, k_choices=(4,))
    fg = fx_to_graph(pgm)
    writes = [op for op in fg.graph.operators
              if fg.node_of[op.name].target is write_rows]
    assert len(writes) == 4
    for op in writes:
        assert op.attrs["inplace"] and op.attrs["inplace_input"] in op.inputs
    kinds = {str(n.target) for n in pgm.graph.nodes}
    assert not any("scatter" in k for k in kinds)
    acc = torch.zeros(6, 2)
    rows = torch.ones(2, 2)
    assert write_rows(acc, rows, 3) is acc
    assert acc[3:5].eq(1).all() and acc[:3].eq(0).all() and acc[5:].eq(0).all()
    # at each write the accumulator is live once: the write's output
    # shares the dying accumulator's buffer
    g = fg.graph
    sched = g.default_schedule()
    live = g.live_sets(sched)
    for t, op in enumerate(sched):
        if op in writes:
            assert op.attrs["inplace_input"] in live[t]
            assert op.output not in live[t]
    assert peak_liveness(pgm) < peak_liveness(gm)


def test_reorder_with_partition_budget():
    mlp, x = _mlp(2)
    gm, leaves = trace(mlp, x)
    _, base = reorder_graph_module(gm)
    budget = base.peak_after // 2
    new_gm, rep = reorder_graph_module(gm, partition_budget=budget)
    assert rep.method.endswith("+pex") and rep.peak_after < base.peak_after
    assert rep.peak_before == base.peak_before
    assert peak_liveness(new_gm) == rep.peak_after
    torch.testing.assert_close(new_gm(*leaves), mlp(x), **MM_TOL)
    # without a budget the behaviour is unchanged
    _, plain = reorder_graph_module(gm)
    assert plain.peak_after == base.peak_after


@pytest.mark.parametrize("which", ["broadcast", "cumsum_rows", "sum_rows",
                                   "transposed_lhs", "mutation"])
def test_unrecognised_programs_are_left_unchanged(which):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((32, 16)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((16,)).astype(np.float32))

    def f(x):
        if which == "broadcast":
            return torch.tanh(x) + v           # implicit broadcast
        if which == "cumsum_rows":
            return torch.cumsum(torch.tanh(x), dim=0)
        if which == "sum_rows":
            return torch.tanh(x).sum(dim=0) * 2.0
        if which == "transposed_lhs":
            return torch.tanh(x).T @ x
        y = torch.tanh(x)
        y.mul_(2.0)
        return torch.exp(y)

    tracer = make_fx(f) if which == "mutation" else None
    gm = tracer(x) if tracer else trace(f, x)[0]
    pgm, n_runs = partial_execute_graph_module(gm)
    assert (pgm, n_runs) == (gm, 0)
