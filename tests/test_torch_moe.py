"""The port's MoE decoders against the JAX package, on the CPU:
``repro_torch.models.moe`` (router, capacity-bounded expert pass,
``moe_ffn``) against ``repro.models.moe`` on seeded numpy inputs, and
``granite-moe-1b-a400m@smoke`` / ``phi3.5-moe-42b-a6.6b@smoke`` through
``Model`` and ``ServingEngine`` against the reference's, with the
reference's ``init_params(PRNGKey(0))`` carried across by
``llm_params_from_numpy``.

Ties: ``torch.topk`` and ``lax.top_k`` may order equal probabilities
differently.  The router inputs here are random float32, and each test
that compares routings asserts that no two of a token's k+1 largest
probabilities are equal, so the expert choices are the same on both
sides; the model tests compare logits, where a tie would show as a
mismatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.models import Model, init_params
from repro_torch.models import moe
from repro_torch.params import llm_params_from_numpy
from repro_torch.serving import Request, ServingEngine
from test_torch_capture import no_host_reads

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

MOE = ("granite-moe-1b-a400m@smoke", "phi3.5-moe-42b-a6.6b@smoke")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _no_ties(x, w, k):
    probs = np.sort(np.asarray(jax.nn.softmax(
        np.asarray(x, np.float32) @ np.asarray(w, np.float32), -1)), -1)
    top = probs[..., ::-1][..., :k + 1]
    assert (np.diff(top, axis=-1) < 0).all(), "a tie among the top k+1"


def _ffn_inputs(seed, B=2, S=16, d=16, ff=24, E=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)).astype(np.float32),
            rng.standard_normal((d, E)).astype(np.float32),
            (rng.standard_normal((E, d, ff)) * 0.2).astype(np.float32),
            (rng.standard_normal((E, d, ff)) * 0.2).astype(np.float32),
            (rng.standard_normal((E, ff, d)) * 0.2).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_matches_the_reference(k):
    x, wr = _ffn_inputs(0)[:2]
    _no_ties(x, wr, k)
    jp, ji, jaux = jax_moe.router_topk(jnp.asarray(x), jnp.asarray(wr), k)
    p, i, aux = moe.router_topk(torch.as_tensor(x), torch.as_tensor(wr), k)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # the two float32 softmaxes differ by a few ulps (2^-23 each)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _kept_by_the_reference(top_i, E, capacity):
    """Which (token, expert) pairs the reference's ``_expert_pass`` keeps,
    read from its output: every token is ones, every expert computes the
    same positive value c, expert e's down projection is scaled by 2^e and
    the gates are 1, so token t's output is c · Σ_{kept e} 2^e."""
    T, k = top_i.shape
    d, ff = 2, 2
    ones = jnp.ones((E, d, ff), jnp.float32)
    wd = jnp.ones((E, ff, d), jnp.float32) * (2.0 ** jnp.arange(E))[
        :, None, None]
    y = np.asarray(jax_moe._expert_pass(
        jnp.ones((T, d), jnp.float32), jnp.ones((T, k), jnp.float32),
        jnp.asarray(top_i), ones, ones, wd, jnp.int32(0), capacity))[:, 0]
    c = float(jax.nn.silu(jnp.float32(d)) * d * ff)
    bits = np.rint(y / c).astype(np.int64)
    return (bits[:, None] >> np.arange(E)) & 1 == 1


@pytest.mark.parametrize("capacity", [1, 3, 5, 40])
def test_dispatch_keeps_and_drops_the_references_tokens(capacity):
    """Token slots over the flat token order: the tokens kept and dropped
    by each expert are the reference's, from full overflow (capacity 1)
    to none (40 rows for 20 tokens)."""
    rng = np.random.default_rng(capacity)
    E, k, T = 6, 2, 20
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)]) \
        .astype(np.int32)
    slot, kept = moe.dispatch(torch.as_tensor(top_i), E, capacity)
    want = _kept_by_the_reference(top_i, E, capacity)
    np.testing.assert_array_equal(kept.numpy(), want)
    assert (slot.numpy()[~want] == capacity).all()
    assert want.sum() == min(T * k, sum(min(capacity, (top_i == e).sum())
                                        for e in range(E)))


def test_capacity_drops_tokens_beyond_c():
    """The reference test's case: capacity 1 and every token routed to
    one expert — only the first token gets a contribution, and it is the
    reference's."""
    d, ff, T = 4, 8, 6
    x = np.ones((T, d), np.float32)
    args = (x, np.ones((T, 1), np.float32), np.zeros((T, 1), np.int32),
            np.ones((1, d, ff), np.float32), np.ones((1, d, ff), np.float32),
            np.ones((1, ff, d), np.float32))
    want = np.asarray(jax_moe._expert_pass(*map(jnp.asarray, args),
                                           jnp.int32(0), capacity=1))
    got = moe.expert_pass(*map(torch.as_tensor, args), capacity=1).numpy()
    assert np.abs(got[0]).sum() > 0
    np.testing.assert_array_equal(got[1:], 0)
    _close(got, want)


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_the_reference(k, capacity_factor):
    """``moe_ffn`` on 32 tokens over 4 experts: with ample capacity, the
    reference launcher's factor and one that overflows every expert."""
    x, wr, wg, wu, wd = _ffn_inputs(k)
    _no_ties(x, wr, k)
    jy, jaux = jax_moe.moe_ffn(*map(jnp.asarray, (x, wr, wg, wu, wd)), k=k,
                               capacity_factor=capacity_factor)
    y, aux = moe.moe_ffn(*map(torch.as_tensor, (x, wr, wg, wu, wd)), k=k,
                         capacity_factor=capacity_factor)
    assert y.dtype == torch.float32 and y.shape == x.shape
    _close(y.numpy(), jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the tokens every expert dropped are zero on both sides
    np.testing.assert_array_equal((y.numpy() == 0).all(-1),
                                  (np.asarray(jy) == 0).all(-1))
    cap = moe.capacity_of(32, k, 4, capacity_factor)
    if capacity_factor < 1:
        _, top_i, _ = moe.router_topk(torch.as_tensor(x),
                                      torch.as_tensor(wr), k)
        _, kept = moe.dispatch(top_i.reshape(-1, k), 4, cap)
        assert int(kept.sum()) < 32 * k          # the case overflows


@pytest.fixture(scope="module", params=MOE)
def twins(request):
    """(cfg, port params, jax cfg, jax params) of an MoE smoke config."""
    jcfg = jax_get_config(request.param)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(request.param)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, params, jcfg, jparams


def test_prefill_and_decode_match_the_reference(twins):
    """Prefill of 2 × 20 tokens (40 tokens over 4 experts, top 2:
    capacity 25) and five teacher-forced decode steps (2 tokens: capacity
    1, so a second token choosing an expert is dropped by it)."""
    cfg, params, jcfg, jparams = twins
    assert cfg.is_moe and "we_g" in params["blocks"]
    jmodel, model = JaxModel(jcfg), Model(cfg)
    toks = np.random.default_rng(0).integers(0, 512, (2, 20)) \
        .astype(np.int32)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=24))(
        jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                               cache_len=24)
    _close(log.numpy(), jlog)
    _close(cache["k"].numpy(), jcache["k"])
    step = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(1)
    for _ in range(5):
        tok = rng.integers(0, 512, 2).astype(np.int32)
        jlog, jcache = step(jparams, jcache, jnp.asarray(tok))
        log, cache = model.decode_step(params, cache, torch.as_tensor(tok))
        _close(log.numpy(), jlog)
    _close(cache["v"].numpy(), jcache["v"])


def _jax_reqs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [JaxRequest(rid=i, prompt=rng.integers(0, 500, rng.integers(4, 12))
                       .astype(np.int32), max_new_tokens=6)
            for i in range(n)]


def test_served_tokens_match_the_reference(twins):
    """tests/test_serving.py's traffic (5 requests, max_batch 2, cache_len
    48): the same greedy tokens and KV-arena statistics."""
    cfg, params, jcfg, jparams = twins
    jeng = JaxServingEngine(jcfg, jparams, max_batch=2, cache_len=48)
    jres = jeng.serve(_jax_reqs(5))
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=48, device="cpu")
    res = eng.serve([Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in _jax_reqs(5)])
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert eng.block_bytes == jeng.block_bytes
    assert eng.stats.kv_arena_peak_bytes == jeng.stats.kv_arena_peak_bytes


@pytest.mark.parametrize("route", ["card", "cpu"])
def test_moe_decode_step_makes_no_host_read(route, monkeypatch):
    """Granite's decode step, on the card's routing (K8's plain version
    stands in) and on the CPU's: no host read, no data-dependent shape,
    no host data copied in, the cache updated where it lies — what a
    captured step needs."""
    cfg = get_config("granite-moe-1b-a400m@smoke")
    params = init_params(cfg, device="cpu")
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    model = Model(cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (3, 6)))
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=10)
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    tok = torch.argmax(logits, -1)
    for _ in range(5):
        with no_host_reads(monkeypatch):
            logits, out = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        assert out is cache
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    assert torch.isfinite(logits).all()


def test_the_cards_bf16_expert_product_has_the_widened_products_gradient():
    """The card's expert product ``_BmmF32`` (``bmm(out_dtype=float32)``,
    which has no derivative of its own) is differentiable: its backward
    passes ``gradcheck`` in float64 through its plain CPU stand-in, and on
    bf16 operands it gives autograd's gradients of the widened product
    ``bmm(a.float(), b.float())`` — formed in float32, returned in bf16,
    as JAX transposes the reference's ``preferred_element_type`` einsums.
    On the CPU its forward is the widened product itself."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 4, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(3, 4, 6, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(moe._BmmF32.apply, (a, b))
    a16 = a.detach().to(torch.bfloat16).requires_grad_()
    b16 = b.detach().to(torch.bfloat16).requires_grad_()
    g = torch.randn(3, 5, 6, generator=gen)
    y = moe._BmmF32.apply(a16, b16)
    assert y.dtype == torch.float32
    got = torch.autograd.grad(y, (a16, b16), g)
    a32, b32 = (t.detach().float().requires_grad_() for t in (a16, b16))
    y32 = torch.bmm(a32, b32)
    want = torch.autograd.grad(y32, (a32, b32), g)
    assert torch.equal(y, y32)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, w.to(torch.bfloat16))
