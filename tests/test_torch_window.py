"""Sliding-window attention in the port against the JAX package, on the
CPU: the ring cache (``repro_torch.models.model``), K8's prefix lengths
against the reference's windowed mask, the window of K7's plain version
(``repro_torch.kernels.flash_attention.ref``) and of the tile plan of its
CUDA bodies, and the card's routing of windowed models.

ROADMAP R8: the reference's prefill keeps a prompt longer than its ring of
``Sc`` slots at slots ``0 .. Sc-1`` in order, while its decode step writes
position ``pos`` at slot ``pos % Sc``; for ``S % Sc != 0`` the step then
overwrites a position still inside the window.  The port writes position
``p`` at slot ``p % Sc`` in prefill too, so its decode steps equal the
reference's own windowed prefill of the same tokens.

Weights are the reference's ``init_params(PRNGKey(0))`` carried across by
``llm_params_from_numpy``; prompts come from numpy with fixed seeds.
Logits agree at ``rtol=1e-4, atol=1e-5·max|ref|`` (float32 sums in other
orders) unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params

import repro_torch.kernels as kernels
import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch.shapes import SLIDING_WINDOW, config_for_shape
from repro_torch.models import Model, init_params, layers
from repro_torch.models.model import decode_lengths
from repro_torch.params import llm_params_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ARCH, W = "llama3.2-3b@smoke", 8
CACHE = 2 * W       # served cache length: a ring of Sc = min(CACHE, W) = W


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def twins():
    """(port cfg, port params, jax params) of the smoke config with a
    window of ``W``, the reference's jitted prefill (logits, and a cache of
    ``CACHE``) and its jitted decode step."""
    jcfg = jax_get_config(ARCH).with_sliding_window(W)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH).with_sliding_window(W)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    jmodel = JaxModel(jcfg)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t},
                                                  cache_len=CACHE))
    return cfg, params, jparams, prefill, jax.jit(jmodel.decode_step)


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (1, n)) \
        .astype(np.int32)


def _wrap(prompt):
    """The first position a decode step writes at slot 0 of the ring."""
    return -(-prompt // W) * W


def _steps(prompt):
    """Decode steps through 10 past the step that writes ``_wrap``."""
    return _wrap(prompt) - prompt + 11


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("prompt,faulty", [(11, True), (5, False),
                                           (8, False), (16, False)])
def test_r8_the_references_decode_leaves_its_windowed_prefill(
        twins, prompt, faulty):
    """The reference alone, three decode steps after a prompt of
    ``prompt`` tokens at W 8: after 11 tokens (11 % 8 = 3) its step
    overwrites a position inside the window and its logits leave its own
    windowed prefill of the same tokens by more than 0.1·max|logit|;
    after 5, 8 or 16 they stay within 1e-5."""
    _, _, jparams, prefill, step = twins
    toks = _tokens(prompt, seed=prompt)
    _, cache = prefill(jparams, jnp.asarray(toks))
    assert cache["k"].shape[2] == W
    errs = []
    for t in (3, 7, 11):
        logits, cache = step(jparams, cache, jnp.asarray([t], jnp.int32))
        toks = np.concatenate([toks, [[t]]], 1).astype(np.int32)
        want, _ = prefill(jparams, jnp.asarray(toks))
        errs.append(_rel(logits, want))
    if faulty:
        assert max(errs) > 0.1, errs
    else:
        assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("prompt", [5, 8, 11, 16, 27])
def test_the_ports_decode_is_the_references_windowed_prefill(twins, prompt):
    """The port's prefill, then decode steps through 10 past the ring's
    next wrap: each step's logits are the reference's windowed prefill of
    the tokens so far, R8's prompts (11, 27) included; where R8 does not
    strike (5, 8, 16) they are also the reference's decode step's."""
    cfg, params, jparams, prefill, step = twins
    model = Model(cfg)
    toks = _tokens(prompt, seed=prompt)
    jlog, jcache = prefill(jparams, jnp.asarray(toks))
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                               cache_len=CACHE)
    _close(log.numpy(), jlog)
    assert cache["k"].shape[2] == W
    rng = np.random.default_rng(prompt + 100)
    for _ in range(_steps(prompt)):
        t = int(rng.integers(0, 512))
        log, cache = model.decode_step(params, cache, torch.tensor([t]))
        toks = np.concatenate([toks, [[t]]], 1).astype(np.int32)
        want, _ = prefill(jparams, jnp.asarray(toks))
        _close(log.numpy(), want)
        if prompt % W == 0 or prompt < W:
            jlog, jcache = step(jparams, jcache, jnp.asarray([t], jnp.int32))
            _close(log.numpy(), jlog)
    assert int(cache["pos"]) == _wrap(prompt) + 11


@pytest.mark.parametrize("prompt,cache_len", [(27, None), (11, 64),
                                              (5, CACHE), (11, 6)])
def test_prefill_puts_position_p_at_slot_p_mod_sc(twins, prompt, cache_len):
    """After prefill, ``kv_pos[p % Sc] == p`` for the kept positions (the
    last ``Sc``), and each slot holds the reference's K/V of that position
    (the reference keeps them at slots ``0 .. Sc-1`` in order)."""
    cfg, params, jparams, _, _ = twins
    toks = _tokens(prompt, seed=prompt)
    jmodel = JaxModel(jax_get_config(ARCH).with_sliding_window(W))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               cache_len=cache_len)
    _, cache = Model(cfg).prefill(params, {"tokens": torch.as_tensor(toks)},
                                  cache_len=cache_len)
    Sc = min(cache_len or prompt, W)
    assert cache["k"].shape[2] == Sc == jcache["k"].shape[2]
    kept = np.arange(max(0, prompt - Sc), prompt)
    kv_pos = cache["kv_pos"].numpy()
    np.testing.assert_array_equal(kv_pos[kept % Sc], kept)
    assert (kv_pos >= 0).sum() == len(kept)
    jslots = kept - kept[0]         # the reference's in-order slots
    for name in ("k", "v"):
        _close(cache[name].numpy()[:, :, kept % Sc],
               np.asarray(jcache[name])[:, :, jslots])


@pytest.mark.parametrize("prompt,cache_len", [(11, CACHE), (13, 6),
                                              (3, 6), (4, 40)])
def test_k8s_prefix_is_the_window_mask(twins, prompt, cache_len,
                                       monkeypatch):
    """At every decode step through the wrap, the prefix ``min(pos + 1,
    Sc)`` that the card's route hands K8 is exactly the reference's
    windowed mask ``(kv_pos >= 0) & (kv_pos <= pos) & (kv_pos > pos - W)``
    over the port's ring, for ``Sc = W`` and for ``cache_len < W``; the
    forced card route (K7/K8's plain versions on CPU tensors) gives the
    CPU route's logits."""
    cfg, params, _, _, _ = twins
    model = Model(cfg)
    toks = {"tokens": torch.as_tensor(_tokens(prompt, seed=prompt))}
    steps = torch.as_tensor(np.random.default_rng(7).integers(0, 512, 14))
    want = [model.prefill(params, toks, cache_len=cache_len)]
    for t in steps:
        want.append(model.decode_step(params, want[-1][1], t[None]))
    lengths = []

    def decode(q, k_cache, v_cache, lens):
        lengths.append(lens.tolist())
        return decode_ops.decode_attention(q, k_cache, v_cache, lens)
    monkeypatch.setattr(kernels, "decode_attention", decode)
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    log, cache = model.prefill(params, toks, cache_len=cache_len)
    _close(log.numpy(), want[0][0].numpy())
    Sc = cache["k"].shape[2]
    assert Sc == min(cache_len, W)
    for i, t in enumerate(steps):
        pos = int(cache["pos"])
        kv_pos = cache["kv_pos"].clone()
        kv_pos[pos % Sc] = pos
        mask = (kv_pos >= 0) & (kv_pos <= pos) & (kv_pos > pos - W)
        n = decode_lengths(pos, Sc)
        assert torch.equal(mask, torch.arange(Sc) < n), (pos, kv_pos)
        log, cache = model.decode_step(params, cache, t[None])
        assert lengths[-1] == [n] and len(lengths) == (i + 1) * \
            cfg.num_layers
        _close(log.numpy(), want[i + 1][0].numpy())
    assert int(cache["pos"]) >= 2 * Sc


# --------------------------------------------- K7's plain version, window
def _qkv(B, Sq, Skv, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]


# (B, Sq, Skv, H, K, D, window, chunk): W 1, W < chunk, W = S, W > S,
# Sq < Skv (the queries are the last Sq positions)
WINDOWED = [(1, 24, 24, 4, 2, 16, 1, 8), (2, 40, 40, 4, 2, 16, 5, 16),
            (1, 33, 33, 6, 2, 32, 33, 16), (1, 33, 33, 6, 2, 32, 100, 16),
            (2, 9, 40, 4, 4, 16, 7, 16), (1, 17, 50, 4, 1, 64, 20, 8)]


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,window,chunk", WINDOWED)
def test_plain_k7_window_matches_the_chunked_attentions(B, Sq, Skv, H, K, D,
                                                        window, chunk):
    """``ref.attention_ref(window=W)`` (K7's plain version, what the card
    route runs on CPU tensors) against the reference's
    ``layers.chunked_attention(sliding_window=W)`` and the port's, on the
    queries' absolute positions ``Skv - Sq ..``."""
    q, k, v = _qkv(B, Sq, Skv, H, K, D, seed=Sq + window)
    qpos = np.arange(Skv - Sq, Skv)
    got = flash_ops.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                    causal=True, window=window)
    want = jax_layers.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, chunk=chunk,
        q_positions=jnp.asarray(qpos), sliding_window=window)
    mine = layers.chunked_attention(
        *map(torch.as_tensor, (q, k, v)), causal=True, chunk=chunk,
        q_positions=torch.as_tensor(qpos), sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(mine.numpy(), got.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("Sq,Skv", [(33, 33), (9, 40)])
def test_a_window_of_at_least_skv_is_causal_bit_for_bit(Sq, Skv):
    q, k, v = map(torch.as_tensor, _qkv(1, Sq, Skv, 4, 2, 16))
    causal = ref.attention_ref(q, k, v, causal=True)
    for window in (Skv, Skv + 1, 10 ** 6):
        assert torch.equal(ref.attention_ref(q, k, v, causal=True,
                                             window=window), causal)


def test_the_wrapper_refuses_a_window_without_causal():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention(q, q, q, causal=False, window=2)
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention(q, q, q, causal=True, window=-1)


# ----------------------------------------- K7's tile plan with a window
def tile_plan_emulation(q, k, v, window, *, body):
    """K7's loops in float32 torch, as ``csrc/flash_attention.cu`` runs
    them with ``causal`` and a ``window``: per block of BQ query rows the
    key tiles from the one of its first row's oldest key (``kv_begin``) to
    its last row's newest (``kv_end``); in the bf16 body a warpgroup of 64
    rows skips a tile above or wholly below its rows' windows and a warp
    of 16 rows masks only a tile its ``edge`` test flags, scores unmasked
    elsewhere; the float32 body masks every tile.  Masked scores -1e30,
    keys past Skv -inf, the online softmax per row.  A wrong skip or edge
    test leaves masked keys in a row's sum.  Returns (out, tiles loaded)."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(H // K, 2)
    vf = v.repeat_interleave(H // K, 2)
    BQ, BKV, WG, WARP = {"bf16": (128, 64, 64, 16),
                         "f32": (64, 32, 64, 64)}[body]
    off, scale = Skv - Sq, D ** -0.5
    out = torch.zeros((B, Sq, H, D))
    loaded = 0
    for q0 in range(0, Sq, BQ):
        kv_end = min(Skv, off + min(q0 + BQ, Sq))
        kv_begin = max(0, q0 + off - window + 1) // BKV * BKV
        m = torch.full((B, H, BQ), -1e30)
        l = torch.zeros((B, H, BQ))
        acc = torch.zeros((B, H, BQ, D))
        for kv0 in range(kv_begin, kv_end, BKV):
            loaded += 1
            for g0 in range(q0, q0 + BQ, WG):
                if body == "bf16" and not (
                        g0 < Sq and not kv0 > off + g0 + WG - 1
                        and not kv0 + BKV - 1 <= off + g0 - window):
                    continue
                for w0 in range(g0, g0 + WG, WARP):
                    rows = torch.arange(w0, w0 + WARP)
                    cols = torch.arange(kv0, kv0 + BKV)
                    qt = q[:, w0:w0 + WARP].float()
                    if qt.shape[1] < WARP:       # rows past Sq: zeros
                        qt = torch.cat([qt, torch.zeros(
                            (B, WARP - qt.shape[1], H, D))], 1)
                    kt = torch.zeros((B, BKV, H, D))
                    vt = torch.zeros((B, BKV, H, D))
                    n = max(0, min(BKV, Skv - kv0))
                    kt[:, :n], vt[:, :n] = kf[:, kv0:kv0 + n], \
                        vf[:, kv0:kv0 + n]
                    s = torch.einsum("bihd,bjhd->bhij", qt, kt) * scale
                    edge = (body == "f32" or kv0 + BKV > Skv
                            or kv0 + BKV - 1 > off + w0
                            or kv0 <= off + w0 + WARP - 1 - window)
                    if edge:
                        r, c = rows[:, None] + off, cols[None]
                        s = s.masked_fill((c > r) | (c <= r - window),
                                          -1e30)
                        s = s.masked_fill(c >= Skv, float("-inf"))
                    i = slice(w0 - q0, w0 - q0 + WARP)
                    m_new = torch.maximum(m[..., i], s.amax(-1))
                    alpha = torch.exp(m[..., i] - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l[..., i] = l[..., i] * alpha + p.sum(-1)
                    acc[..., i, :] = acc[..., i, :] * alpha[..., None] \
                        + torch.einsum("bhij,bjhd->bhid", p, vt)
                    m[..., i] = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        n = min(BQ, Sq - q0)
        out[:, q0:q0 + n] = o[:, :, :n].permute(0, 2, 1, 3)
    return out, loaded


# (Sq, Skv, window): W 1; W < one key tile (both edges in one tile); W a
# tile, a tile and a bit, several tiles; W = S and W > S; Sq < Skv; a
# second query block
TILE_SHAPES = [(17, 17, 1), (200, 200, 5), (200, 200, 64), (200, 200, 70),
               (300, 300, 100), (200, 200, 200), (200, 200, 500),
               (70, 333, 50), (129, 129, 128), (256, 256, 63)]


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("Sq,Skv,window", TILE_SHAPES)
def test_k7s_tile_plan_keeps_the_window(Sq, Skv, window, body):
    """The kernel's loop bounds, skips and edge tests with a window give
    the plain version's attention (2e-5·max, float32), and load no key
    tile wholly below a block's window."""
    q, k, v = map(torch.as_tensor, _qkv(1, Sq, Skv, 2, 1, 16, seed=window))
    got, loaded = tile_plan_emulation(q, k, v, window, body=body)
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5 * float(want.abs().max()))
    BQ, BKV = {"bf16": (128, 64), "f32": (64, 32)}[body]
    off, need = Skv - Sq, 0
    for q0 in range(0, Sq, BQ):
        last = off + min(q0 + BQ, Sq) - 1
        first = max(0, q0 + off - window + 1)
        need += last // BKV - first // BKV + 1
    assert loaded == need


# ------------------------------------------ the card's routing, windowed
@pytest.mark.parametrize("arch,window", [
    ("llama3.2-3b@smoke", 6), ("granite-moe-1b-a400m@smoke", 5),
    ("internvl2-1b@smoke", 6)])
def test_the_card_route_passes_the_window_to_k7(arch, window, monkeypatch):
    """``config_for_shape(..., "long_500k")`` gives these architectures
    (dense, MoE, VLM) a window; at smoke width a window of ``window``
    slots makes it bite (a prompt of 9 tokens, InternVL2's 8 patch rows
    on top, and a cache of 12).  With the card's routing forced on CPU
    tensors, prefill calls K7 once a layer with that window (causal self
    attention), each decode step K8 over the ring's prefix, and both give
    the CPU route's logits."""
    base = get_config(arch)
    assert config_for_shape(base, "long_500k").sliding_window \
        == SLIDING_WINDOW
    cfg = base.with_sliding_window(window)
    params = init_params(cfg, device="cpu")
    model = Model(cfg)
    S = 9 + (cfg.num_patch_tokens or 0)
    batch = {n: torch.as_tensor(a) for n, a in SyntheticLMDataset(
        cfg, 2, S, seed=4).batch(0).items()}
    batch["tokens"] = batch["tokens"][:, :9]
    want = [model.prefill(params, batch, cache_len=12)]
    for t in range(4):
        want.append(model.decode_step(params, want[-1][1],
                                      torch.tensor([t, t + 1])))
    calls = {"flash": [], "decode": []}

    def flash(q, k, v, *, causal, window=0):
        calls["flash"].append((tuple(q.shape), causal, window))
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)

    def decode(q, k_cache, v_cache, lengths):
        calls["decode"].append((k_cache.shape[1], lengths.tolist()))
        return decode_ops.decode_attention(q, k_cache, v_cache, lengths)

    monkeypatch.setattr(kernels, "flash_attention", flash)
    monkeypatch.setattr(kernels, "decode_attention", decode)
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    log, cache = model.prefill(params, batch, cache_len=12)
    _close(log.numpy(), want[0][0].numpy())
    H, hd = cfg.num_heads, cfg.head_dim_
    assert calls["flash"] == [((2, S, H, hd), True, window)] \
        * cfg.num_layers
    for t in range(4):
        pos = int(cache["pos"])
        log, cache = model.decode_step(params, cache,
                                       torch.tensor([t, t + 1]))
        _close(log.numpy(), want[t + 1][0].numpy())
        assert calls["decode"][-cfg.num_layers:] == \
            [(window, [min(pos + 1, window)] * 2)] * cfg.num_layers


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("arch", ["llama3.2-3b@smoke",
                                  "granite-moe-1b-a400m@smoke"])
def test_the_reordered_step_replays_the_windowed_step(arch, route,
                                                       monkeypatch):
    """The traced form of a windowed decode step (the layer stack as
    ``repro_torch::decode_layers``, traced from shapes and reordered by
    ``analyse_decode_schedule``) against ``decode_step`` on copies of one
    ring, through its wraps: logits and every cache tensor bit-equal.
    ``card`` forces the card's routing on CPU tensors (the operator gets
    K8's ``lengths`` in place of the mask)."""
    from repro_torch.serving import ServingEngine
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    cfg = get_config(arch).with_sliding_window(6)
    params = init_params(cfg, device="cpu")
    model = Model(cfg)
    eng = ServingEngine(cfg, params, cache_len=12, device="cpu")
    eng.analyse_decode_schedule(2)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, 500, (2, 9)))
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=12)
    assert cache["k"].shape[2] == 6
    mine = {n: t.clone() for n, t in cache.items()}
    tok = torch.argmax(logits, -1)
    for _ in range(8):
        got, mine = eng.reordered_step(params, mine, tok)
        want, cache = model.decode_step(params, cache, tok)
        assert torch.equal(got, want)
        for name in cache:
            assert torch.equal(mine[name], cache[name]), name
        tok = torch.argmax(want, -1)
    assert int(cache["pos"]) == 17
