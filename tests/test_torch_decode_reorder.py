"""The paper's reordering of the LLM decode step on the port
(``ServingEngine.analyse_decode_schedule``, the L1 level of DESIGN.md §2)
against the reference's, on the CPU.

The port traces ``Model.decode_step(..., traced=True)``, whose layer stack
is the one functional operator ``repro_torch::decode_layers``, with
``make_fx(functionalize(...), tracing_mode="fake")``; the reference's step
scans its layers, so its jaxpr holds the stack as one equation too.  The
reference's report is computed here with ``jax.make_jaxpr`` over shapes
and ``reorder_closed_jaxpr``.  Both peaks must agree within 8 KiB: the
two traces differ in small tensors only — the port's tokens are int64
where the reference's are int32, its views and the ``getitem``s of the
operator's outputs cost nothing where the reference materialises a
reshape or a slice, and the reference's scan carries an aux-loss scalar
and the port's does not.  Full width runs on meta tensors.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.core.jaxpr_reorder import reorder_closed_jaxpr
from repro.models.model import Model as JaxModel
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params

import repro_torch.kernels as kernels
import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.core.fx_reorder import peak_liveness
from repro_torch.models import Model, init_params
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import reorder_decode_step

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

TOLERANCE_B = 8 * 1024
SMOKE = ("llama3.2-3b@smoke", "granite-moe-1b-a400m@smoke")
RECURRENT = ("zamba2-2.7b@smoke", "xlstm-350m@smoke")
STACK_OPS = (torch.ops.repro_torch.decode_layers.default,
             torch.ops.repro_torch.decode_recurrent_layers.default)


def _jax_report(arch, batch, cache_len):
    """The reference's ``analyse_decode_schedule`` over shapes."""
    cfg = jax_get_config(arch)
    params = jax.eval_shape(lambda: jax_init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: jax_init_cache(cfg, batch, cache_len))
    toks = jax.ShapeDtypeStruct((batch,), jnp.int32)
    closed = jax.make_jaxpr(JaxModel(cfg).decode_step)(params, cache, toks)
    return reorder_closed_jaxpr(closed)[1]


@pytest.mark.parametrize("arch,batch,cache_len", [
    ("llama3.2-3b@smoke", 2, 48),     # tests/test_serving.py's engine
    ("llama3.2-3b@smoke", 4, 96),     # the launcher's
    ("llama3.2-3b", 4, 96),
    ("llama3.2-3b", 4, 2048),
    ("granite-moe-1b-a400m", 4, 96),
    ("zamba2-2.7b@smoke", 4, 96),     # the launcher's, recurrent layouts
    ("xlstm-350m@smoke", 4, 96),
    ("xlstm-350m", 4, 96)])
def test_report_matches_the_reference(arch, batch, cache_len):
    """Smoke configs through the engine on the CPU, full width on meta
    tensors: the layer stack is one operator (``decode_layers``, or
    ``decode_recurrent_layers`` for Zamba2 and xLSTM), the peaks are the
    reference's within 8 KiB, and reordering never raises the peak."""
    cfg = get_config(arch)
    if arch.endswith("@smoke"):
        eng = ServingEngine(cfg, init_params(cfg, device="cpu"),
                            cache_len=cache_len, device="cpu")
        rep = eng.analyse_decode_schedule(batch)
        assert eng.reorder_report is rep
        gm = eng.reordered_step.gm
    else:
        step, rep = reorder_decode_step(
            Model(cfg), init_params(cfg, device="meta"), batch, cache_len)
        gm = step.gm
    want = _jax_report(arch, batch, cache_len)
    ops = [n for n in gm.graph.nodes if n.target in STACK_OPS]
    assert len(ops) == 1
    assert rep.n_eqns >= 10 and want.n_eqns > 10
    assert rep.peak_after <= rep.peak_before
    assert peak_liveness(gm) == rep.peak_after
    assert abs(rep.peak_before - want.peak_before) <= TOLERANCE_B, (rep, want)
    assert abs(rep.peak_after - want.peak_after) <= TOLERANCE_B, (rep, want)


def test_full_depth_trace_and_schedule_take_under_10_s():
    cfg = get_config("llama3.2-3b")
    params = init_params(cfg, device="meta")
    t0 = time.perf_counter()
    _, rep = reorder_decode_step(Model(cfg), params, 4, 2048)
    assert time.perf_counter() - t0 < 10.0
    assert rep.n_eqns == 28


def test_zamba_full_width_report_counts_no_reshape_copies():
    """Zamba2-2.7B at full width: one layer-stack operator, and a peak
    below the reference's.  The reference's step reshapes the stacked
    Mamba2 weights and states to ``[groups, per_group, ...]`` and back
    (``model.py:1082-1085``, ``:1110-1111``), and its jaxpr counts each
    reshape as a new buffer (1.4 GB for each of ``w_x``, ``w_z``,
    ``w_out``; 283 MB for ``state``); the port indexes the stacked
    tensors, so its trace has no such copies.  At smoke width (one group)
    the two agree within 8 KiB (above)."""
    cfg = get_config("zamba2-2.7b")
    step, rep = reorder_decode_step(Model(cfg),
                                    init_params(cfg, device="meta"), 4, 96)
    want = _jax_report("zamba2-2.7b", 4, 96)
    assert len([n for n in step.gm.graph.nodes
                if n.target in STACK_OPS]) == 1
    assert rep.peak_after <= rep.peak_before
    assert rep.peak_before < want.peak_after - 1_000_000_000, (rep, want)


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("arch", SMOKE + RECURRENT)
def test_reordered_step_is_bit_equal_to_the_in_place_step(
        arch, route, monkeypatch):
    """The reordered module and ``decode_step`` on copies of one cache:
    equal logits and caches, bit for bit, over steps that fill the cache
    and overwrite its last slot.  ``card`` forces the card's routing on
    CPU tensors (K8's plain version stands in), where the operator gets
    ``lengths`` in place of the mask."""
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    cfg = get_config(arch)
    params = init_params(cfg, device="cpu")
    model = Model(cfg)
    eng = ServingEngine(cfg, params, cache_len=12, device="cpu")
    eng.analyse_decode_schedule(2)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 500, (2, 9)))
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=12)
    mine = {n: t.clone() for n, t in cache.items()}
    tok = torch.argmax(logits, -1)
    for _ in range(5):
        got, mine = eng.reordered_step(params, mine, tok)
        want, cache = model.decode_step(params, cache, tok)
        assert torch.equal(got, want)
        for name in cache:
            assert torch.equal(mine[name], cache[name]), name
        tok = torch.argmax(want, -1)
    assert int(cache["pos"]) == 14


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("arch", SMOKE)
def test_the_operator_fake_outputs_match_the_real_ones(arch, route,
                                                       monkeypatch):
    """``repro_torch::decode_layers`` under fake tensors gives the shapes,
    dtypes and strides its real run gives, and leaves its inputs as they
    were."""
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    cfg = get_config(arch)
    params = init_params(cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 500, (3, 5)))
    _, cache = Model(cfg).prefill(params, {"tokens": toks}, cache_len=8)
    seen = []
    op = torch.ops.repro_torch.decode_layers

    def record(*args):
        seen.append(args)
        return op(*args)
    monkeypatch.setattr(torch.ops.repro_torch, "decode_layers", record)
    before = {n: t.clone() for n, t in cache.items()}
    Model(cfg).decode_step(params, cache, torch.tensor([1, 2, 3]),
                           traced=True)
    (args,) = seen
    real = op(*args)
    assert torch.equal(args[2], before["k"]) and \
        torch.equal(args[3], before["v"])
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*[[mode.from_tensor(t) for t in a] if isinstance(a, list)
                    else mode.from_tensor(a)
                    if isinstance(a, torch.Tensor) else a for a in args])
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.stride()) == (f.shape, f.dtype,
                                                  f.stride())


def test_the_analysis_launches_nothing(monkeypatch):
    """On the card's routing the traced operator would reach K8; under
    fake tensors only its shapes run, so no kernel wrapper is called, and
    the operator gets ``lengths`` (argument 7), not the mask."""
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)

    def no_kernel(*a, **kw):
        raise AssertionError("the analysis called a kernel wrapper")
    monkeypatch.setattr(kernels, "decode_attention", no_kernel)
    monkeypatch.setattr(kernels, "flash_attention", no_kernel)
    cfg = get_config("llama3.2-3b")
    step, rep = reorder_decode_step(Model(cfg), init_params(cfg,
                                                            device="meta"),
                                    4, 2048)
    assert rep.n_eqns == 28
    (op,) = [n for n in step.gm.graph.nodes
             if n.target is torch.ops.repro_torch.decode_layers.default]
    assert op.args[7] is not None and op.args[8] is None


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_the_recurrent_operator_fake_outputs_match_the_real_ones(
        arch, route, monkeypatch):
    """``repro_torch::decode_recurrent_layers`` under fake tensors gives
    the shapes, dtypes and strides of its real run (x, then the layout's
    cache tensors in ``Model.stack_state`` order), and leaves its inputs
    as they were."""
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    cfg = get_config(arch)
    params = init_params(cfg, device="cpu")
    model = Model(cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 500, (3, 5)))
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=8)
    seen = []
    op = torch.ops.repro_torch.decode_recurrent_layers

    def record(*args):
        seen.append(args)
        return op(*args)
    monkeypatch.setattr(torch.ops.repro_torch, "decode_recurrent_layers",
                        record)
    before = {n: t.clone() for n, t in cache.items()}
    model.decode_step(params, cache, torch.tensor([1, 2, 3]), traced=True)
    (args,) = seen
    real = op(*args)
    for name, t in zip(model.stack_state, args[2]):
        assert torch.equal(t, before[name]), name
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*[[mode.from_tensor(t) for t in a] if isinstance(a, list)
                    else mode.from_tensor(a)
                    if isinstance(a, torch.Tensor) else a for a in args])
    assert len(real) == len(fake) == 1 + len(model.stack_state)
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.stride()) == (f.shape, f.dtype,
                                                  f.stride())
