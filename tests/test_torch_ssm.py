"""The port's recurrent decoders against the JAX package, on the CPU:
``repro_torch.models.ssm`` (chunked linear attention, its decode step,
the causal conv1d and the sLSTM scan) against ``repro.models.ssm``, and
the Zamba2 hybrid and xLSTM (``zamba2-2.7b@smoke``, ``xlstm-350m@smoke``,
float32) against ``repro.models.Model``: prefill logits and every cache
tensor, then teacher-forced decode steps, with the reference's
``init_params(PRNGKey(0))`` carried across by ``llm_params_from_numpy``.
Inputs come from numpy seeds.  Tolerance ``rtol=1e-4, atol=1e-5·max|ref|``
(float sums in other orders), as ``test_torch_llm.py``'s; the card's
routing is forced on CPU tensors where it is tested (the kernels' plain
versions stand in)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params

import repro_torch.kernels as kernels
import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import Model, init_params, ssm
from repro_torch.params import llm_params_from_numpy

from test_torch_capture import no_host_reads

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ARCHS = ("zamba2-2.7b@smoke", "xlstm-350m@smoke")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _la_inputs(seed, B=2, S=13, H=3, N=4, P=5):
    """q, k, v and gates: log decays <= 0 (some below -60 over a chunk, so
    the clips bite), input scales in (0, 1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, N)).astype(np.float32)
    k = rng.standard_normal((B, S, H, N)).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ld = -rng.exponential(1.0, (B, S, H)).astype(np.float32)
    ld[:, 4] = -70.0
    sc = rng.uniform(0.0, 1.0, (B, S, H)).astype(np.float32)
    return q, k, v, ld, sc


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 5, 16])
def test_chunked_linear_attention_matches_the_reference(chunk, normalize):
    """S 13 in chunks of 1, 3, 5 and 16 (ragged last chunks, one chunk
    longer than S), from zero and from a given state."""
    q, k, v, ld, sc = _la_inputs(chunk)
    Pv = v.shape[-1] + normalize
    state = np.random.default_rng(99).standard_normal(
        (2, 3, 4, Pv)).astype(np.float32)
    for state_in in (None, state):
        jy, js = jax_ssm.chunked_linear_attention(
            *map(jnp.asarray, (q, k, v, ld, sc)), chunk=chunk,
            normalize=normalize,
            state_in=None if state_in is None else jnp.asarray(state_in))
        y, s = ssm.chunked_linear_attention(
            *map(_t, (q, k, v, ld, sc)), chunk=chunk, normalize=normalize,
            state_in=None if state_in is None else _t(state_in))
        assert y.dtype == s.dtype == torch.float32
        assert tuple(y.shape) == jy.shape and tuple(s.shape) == js.shape
        _close(y.numpy(), jy)
        _close(s.numpy(), js)


@pytest.mark.parametrize("normalize", [False, True])
def test_steps_continue_a_chunked_state(normalize):
    """``linear_attention_step`` from the state of a chunked prefill of 9
    positions, over the next 4, matches the reference's steps and the
    chunked run over all 13; a ``state_in`` without the normaliser column
    is refused."""
    q, k, v, ld, sc = _la_inputs(7)
    _, s = ssm.chunked_linear_attention(
        *(_t(a[:, :9]) for a in (q, k, v, ld, sc)), chunk=4,
        normalize=normalize)
    js = jnp.asarray(s.numpy())
    full, _ = ssm.chunked_linear_attention(*map(_t, (q, k, v, ld, sc)),
                                           chunk=4, normalize=normalize)
    for t in range(9, 13):
        args = [a[:, t] for a in (q, k, v, ld, sc)]
        jy, js = jax_ssm.linear_attention_step(
            js, *map(jnp.asarray, args), normalize=normalize)
        y, s = ssm.linear_attention_step(s, *map(_t, args),
                                         normalize=normalize)
        _close(y.numpy(), jy)
        _close(s.numpy(), js)
        _close(y.numpy(), full[:, t].numpy())
    if normalize:
        with pytest.raises(ValueError, match="normaliser"):
            ssm.chunked_linear_attention(
                *map(_t, (q, k, v, ld, sc)), normalize=True,
                state_in=torch.zeros((2, 3, 4, 5)))


@pytest.mark.parametrize("S", [1, 2, 9])
@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_the_reference(S, with_cache):
    """silu of the 4-tap causal conv in x's dtype, and the pre-activation
    window as the new cache (S shorter than the window included)."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 6)).astype(np.float32) \
        if with_cache else None
    jy, jc = jax_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if cache is None
                                   else jnp.asarray(cache))
    y, c = ssm.causal_conv1d(_t(x), _t(w),
                             None if cache is None else _t(cache))
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(c.numpy(), jc)


@pytest.mark.parametrize("given_state", [False, True])
def test_slstm_scan_matches_the_reference(given_state):
    """From the scan's own start (0, 1, 0, -10) and from a given state,
    13 steps: the outputs and the final (c, n, h, m)."""
    rng = np.random.default_rng(5)
    B, S, H, P = 2, 13, 3, 4
    gates = rng.standard_normal((B, S, 4, H, P)).astype(np.float32) * 2
    r = rng.standard_normal((4, H, P, P)).astype(np.float32) * 0.5
    state = None
    if given_state:
        state = tuple(rng.standard_normal((B, H, P)).astype(np.float32)
                      for _ in range(4))
    jh, jst = jax_ssm.slstm_scan(
        jnp.asarray(gates), jnp.asarray(r),
        None if state is None else tuple(map(jnp.asarray, state)))
    h, st = ssm.slstm_scan(_t(gates), _t(r),
                           None if state is None else tuple(map(_t, state)))
    _close(h.numpy(), jh)
    for got, want in zip(st, jst):
        _close(got.numpy(), want)


# ------------------------------------------------------------ the models
def _twins(arch, **changes):
    jcfg = jax_get_config(arch).replace(**changes)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).replace(**changes)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, params, jcfg, jparams


@pytest.mark.parametrize("ssm_chunk", [128, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, ssm_chunk):
    """Prefill of a 13-token prompt (in chunks of 4: four chunks, the last
    ragged), every cache tensor, then five teacher-forced decode steps:
    logits, every cache tensor and ``pos``.  The step updates the one
    cache in place (what a captured step replays)."""
    cfg, params, jcfg, jparams = _twins(arch, ssm_chunk=ssm_chunk)
    jmodel, model = JaxModel(jcfg), Model(cfg)
    toks = np.random.default_rng(0).integers(0, 512, (2, 13)) \
        .astype(np.int32)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=16))(
        jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                               cache_len=16)
    _close(log.numpy(), jlog)
    assert sorted(cache) == sorted(jcache)

    def same_cache():
        for name, t in cache.items():
            assert tuple(t.shape) == jcache[name].shape, name
            assert str(t.dtype).split(".")[-1] == jcache[name].dtype.name
            if t.dtype.is_floating_point:
                _close(t.numpy(), jcache[name])
            else:
                np.testing.assert_array_equal(t.numpy(), jcache[name])
    same_cache()
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    step = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(1)
    for _ in range(5):
        tok = rng.integers(0, 512, 2).astype(np.int32)
        jlog, jcache = step(jparams, jcache, jnp.asarray(tok))
        log, out = model.decode_step(params, cache, torch.as_tensor(tok))
        assert out is cache
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
        _close(log.numpy(), jlog)
        same_cache()
    assert int(cache["pos"]) == 18      # the K/V cache (16) overflowed


@pytest.mark.parametrize("route", ["card", "cpu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_makes_no_host_read_and_stays_in_place(arch, route,
                                                           monkeypatch):
    """Under ``test_torch_capture.py``'s no-host-read dispatch mode, on
    the card's routing (forced on CPU tensors) and on the CPU's: no host
    read, every cache tensor updated where it lies."""
    cfg = get_config(arch)
    params = init_params(cfg, device="cpu")
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    model = Model(cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 6)))
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=8)
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    before = {n: t.clone() for n, t in cache.items()}
    tok = torch.argmax(logits, -1)
    for _ in range(4):          # past the K/V cache's end
        with no_host_reads(monkeypatch):
            logits, out = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        assert out is cache
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    assert int(cache["pos"]) == 10
    assert torch.isfinite(logits).all()
    for name in model.stack_state:       # every state moved
        assert not torch.equal(cache[name], before[name]), name


# K7/K8's plain versions and the CPU path's chunked / masked attention
# sum in other orders (~1e-7 relative per attention), and 54 residual
# layers, 9 of them attention, carry that to the logits: 2e-4 of
# max|logit| was seen at Zamba2's depth, the bound leaves 5x.
DEEP_TOL = 1e-3


def _deep_close(got, want):
    err = float((got - want).abs().max())
    assert err <= DEEP_TOL * float(want.abs().max()), err


@pytest.mark.parametrize("arch,per_prefill", [("zamba2-2.7b@smoke", 9),
                                              ("xlstm-350m@smoke", 0)])
def test_the_card_path_calls_k7_and_k8_once_a_group(arch, per_prefill,
                                                    monkeypatch):
    """At the full models' depth (Zamba2: 54 layers in 9 groups; xLSTM: 24
    in 4) and smoke width, with the card's routing forced on CPU tensors:
    Zamba2's prefill calls K7 once per shared-attention application (9)
    and each decode step K8 as often, with the shared block's shapes
    (H = K); xLSTM calls neither.  The kernels' plain versions there give
    the CPU path's logits within ``DEEP_TOL`` of max|logit|."""
    depth = {"zamba2-2.7b@smoke": 54, "xlstm-350m@smoke": 24}[arch]
    cfg = get_config(arch).replace(num_layers=depth)
    params = init_params(cfg, device="cpu")
    model = Model(cfg)
    assert model.layout.groups == depth // 6
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (2, 7)))
    want = [model.prefill(params, {"tokens": toks}, cache_len=9)]
    for t in range(3):
        want.append(model.decode_step(params, want[-1][1],
                                      torch.tensor([t, t + 1])))
    calls = {"flash": [], "decode": []}

    def flash(q, k, v, *, causal, window=0):
        calls["flash"].append((tuple(q.shape), tuple(k.shape), causal))
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)

    def decode(q, k_cache, v_cache, lengths):
        calls["decode"].append((tuple(q.shape), tuple(k_cache.shape),
                                lengths.tolist()))
        return decode_ops.decode_attention(q, k_cache, v_cache, lengths)

    monkeypatch.setattr(kernels, "flash_attention", flash)
    monkeypatch.setattr(kernels, "decode_attention", decode)
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    log, cache = model.prefill(params, {"tokens": toks}, cache_len=9)
    _deep_close(log, want[0][0])
    H, hd = cfg.num_heads, cfg.head_dim_
    assert calls["flash"] == [((2, 7, H, hd), (2, 7, H, hd), True)] \
        * per_prefill
    for t in range(3):
        log, cache = model.decode_step(params, cache,
                                       torch.tensor([t, t + 1]))
        _deep_close(log, want[t + 1][0])
        assert calls["decode"][len(calls["decode"]) - per_prefill:] == \
            [((2, H, hd), (2, 9, H, hd), [min(8 + t, 9)] * 2)] * per_prefill
    assert len(calls["decode"]) == 3 * per_prefill


def test_params_from_numpy_take_the_nested_trees():
    """``llm_params_from_numpy`` follows ``init_params(device="meta")``:
    Zamba2's stacked ``mamba`` and unstacked ``shared_attn`` trees and
    xLSTM's ``mlstm``/``slstm`` arrive with the reference's values; a
    shape that differs is refused with its path."""
    cfg, params, _, jparams = _twins("zamba2-2.7b@smoke")
    assert sorted(params) == sorted(jparams)
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
    assert tuple(params["shared_attn"]["wq"].shape) == (d, H, hd)
    assert tuple(params["mamba"]["w_x"].shape) == \
        (6, d, cfg.ssm_heads, cfg.ssm_head_dim)
    np.testing.assert_array_equal(params["shared_attn"]["wo"].numpy(),
                                  jparams["shared_attn"]["wo"])
    np.testing.assert_array_equal(params["mamba"]["conv_x"].numpy(),
                                  jparams["mamba"]["conv_x"])
    cfg, params, _, jparams = _twins("xlstm-350m@smoke")
    assert tuple(params["slstm"]["r"].shape) == (1, 4, 4, 64, 64)
    np.testing.assert_array_equal(params["mlstm"]["w_q"].numpy(),
                                  jparams["mlstm"]["w_q"])
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["slstm"]["b"] = tree["slstm"]["b"][0]
    with pytest.raises(ValueError, match="slstm.b: shape"):
        llm_params_from_numpy(cfg, tree)
