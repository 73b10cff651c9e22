"""The port's encoder-decoder and vision-language decoders against the JAX
package, on the CPU: ``whisper-large-v3@smoke`` (the ``encdec`` layout: a
non-causal encoder over frame embeddings, cross attention in every decoder
block, the cross cache ``ck``/``cv``) and ``internvl2-1b@smoke`` (patch
embeddings before the token rows) against ``repro.models.Model`` and
``repro.serving.ServingEngine``, with the reference's
``init_params(PRNGKey(0))`` carried across by ``llm_params_from_numpy``.
Inputs come from ``repro_torch.data.SyntheticLMDataset``, so frames and
patches are seeded and non-zero: with the engine's zero stubs the encoder
output is exactly zero and cross attention adds nothing.  Tolerance
``rtol=1e-4, atol=1e-5·max|ref|`` (float sums in other orders), as
``test_torch_llm.py``'s; the card's routing is forced on CPU tensors where
it is tested (the kernels' plain versions stand in)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

import repro_torch.kernels as kernels
import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, init_params
from repro_torch.params import llm_params_from_numpy
from repro_torch.serving import Request, ServingEngine

from test_torch_capture import no_host_reads

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

WHISPER, VLM = "whisper-large-v3@smoke", "internvl2-1b@smoke"
ARCHS = (WHISPER, VLM)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _twins(arch, **changes):
    jcfg = jax_get_config(arch).replace(**changes)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).replace(**changes)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, params, jcfg, jparams


def _batch(cfg, B, n_text, seed=0):
    """The dataset's batch of ``n_text`` tokens (patch rows come on top)."""
    return SyntheticLMDataset(cfg, B, n_text + (cfg.num_patch_tokens or 0),
                              seed).batch(0)


@pytest.mark.parametrize("cache_len", [24, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, cache_len):
    """Prefill of a 13-token prompt (after InternVL2's 8 patch rows; over
    Whisper's 16 frames), every cache tensor — ``k``, ``v``, ``kv_pos``,
    ``pos``, and Whisper's ``ck``/``cv`` — then five teacher-forced decode
    steps: logits and every cache tensor, the one cache updated in place.
    Cache 24 fills during InternVL2's steps (from 21 positions), cache 16
    during Whisper's; it is shorter than InternVL2's prompt, whose prefill
    keeps its last 16 positions and drops patch rows, as the reference's
    does."""
    cfg, params, jcfg, jparams = _twins(arch)
    jmodel, model = JaxModel(jcfg), Model(cfg)
    batch = _batch(cfg, 2, 13)
    S = 13 + (cfg.num_patch_tokens or 0)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, cache_len=cache_len))(
        jparams, {n: jnp.asarray(a) for n, a in batch.items()})
    log, cache = model.prefill(params, batch, cache_len=cache_len)
    _close(log.numpy(), jlog)
    want = {"k", "v", "kv_pos", "pos"} | ({"ck", "cv"} if arch == WHISPER
                                          else set())
    assert set(cache) == set(jcache) == want
    assert int(cache["pos"]) == S

    def same_cache():
        for name, t in cache.items():
            assert tuple(t.shape) == jcache[name].shape, name
            assert str(t.dtype).split(".")[-1] == jcache[name].dtype.name
            if t.dtype.is_floating_point:
                _close(t.numpy(), jcache[name])
            else:
                np.testing.assert_array_equal(t.numpy(), jcache[name])
    same_cache()
    if arch == WHISPER:     # frames are non-zero, so is the cross cache
        assert float(cache["ck"].abs().min(-1).values.max()) > 0
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
    assert int(cache["pos"]) == S + 5


def _jax_reqs(n, seed=0):
    """tests/test_serving.py's traffic."""
    rng = np.random.default_rng(seed)
    return [JaxRequest(rid=i, prompt=rng.integers(0, 500, rng.integers(4, 12))
                       .astype(np.int32), max_new_tokens=6)
            for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_the_reference(arch):
    """tests/test_serving.py's traffic (5 requests, max_batch 2, cache_len
    48) with the engines' zero stubs: the same greedy tokens, KV block
    (Whisper's counts the cross cache) and arena statistics."""
    cfg, params, jcfg, jparams = _twins(arch)
    jeng = JaxServingEngine(jcfg, jparams, max_batch=2, cache_len=48)
    jres = jeng.serve(_jax_reqs(5))
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=48, device="cpu")
    res = eng.serve([Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in _jax_reqs(5)])
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert eng.block_bytes == jeng.block_bytes
    if arch == WHISPER:     # k, v at 48 slots and ck, cv at 16 frames
        L, K, H, hd = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, \
            cfg.head_dim_
        assert eng.block_bytes == 2 * L * hd * 4 * (48 * K + 16 * H) \
            + 4 + 4 * 48
    for name in ("kv_arena_peak_bytes", "kv_static_bytes", "peak_concurrent",
                 "requests", "dispatches"):
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ... --device cpu``: the
    reference launcher's traffic answered, then the L1 report with the
    layer stack one operator."""
    eng = launch_serve.main(["--arch", arch, "--requests", "3",
                             "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("tokens=") == 3 and eng.stats.requests == 3
    assert out.strip().splitlines()[-1].startswith("fx reorder: 25 ops")
    assert [n.target for n in eng.reordered_step.gm.graph.nodes].count(
        torch.ops.repro_torch.decode_layers.default) == 1


def test_the_encoder_masks_the_pad_keys_of_a_ragged_chunk(monkeypatch):
    """ROADMAP R6 at smoke width: ``encoder_seq`` 20 in chunks of 16 pads
    the last chunk with 12 zero keys.  The port's chunked path masks them,
    so its encoder (seen through the cross cache it feeds, and the
    logits) equals plain softmax attention — K7's plain version
    ``attention_ref``, reached with the card's routing forced — and the
    reference's own chunked path, which weighs the pad keys, does not."""
    cfg, params, jcfg, jparams = _twins(WHISPER, encoder_seq=20)
    assert cfg.encoder_seq % cfg.attn_chunk
    batch = _batch(cfg, 2, 9, seed=4)
    model = Model(cfg)
    log, cache = model.prefill(params, batch, cache_len=12)
    _, jcache = jax.jit(lambda p, b: JaxModel(jcfg).prefill(
        p, b, cache_len=12))(
        jparams, {n: jnp.asarray(a) for n, a in batch.items()})
    err = float(np.abs(cache["ck"].numpy() - np.asarray(jcache["ck"])).max())
    assert err > 1e-2 * float(np.abs(np.asarray(jcache["ck"])).max())
    calls = []

    def flash(q, k, v, *, causal, window=0):
        calls.append(causal)
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)
    monkeypatch.setattr(kernels, "flash_attention", flash)
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    plain_log, plain = model.prefill(params, batch, cache_len=12)
    assert calls.count(False) == cfg.encoder_layers + cfg.num_layers
    for name in ("ck", "cv"):
        _close(cache[name].numpy(), plain[name].numpy())
    _close(log.numpy(), plain_log.numpy())


@pytest.mark.parametrize("arch,k7,k8", [(WHISPER, 3, 2), (VLM, 1, 1)])
def test_the_card_path_calls_k7_and_k8_with_the_models_arguments(
        arch, k7, k8, monkeypatch):
    """With the card's routing forced on CPU tensors: Whisper's prefill
    calls K7 3·L times — each encoder layer non-causal over the frames,
    each decoder layer causal over the text and then non-causal over the
    encoder's H-head keys — and each decode step K8 2·L times, the cross
    call over all ``encoder_seq`` rows; InternVL2 calls each L times over
    the patch and token rows.  The plain versions there give the CPU
    path's logits."""
    cfg = get_config(arch)
    params = init_params(cfg, device="cpu")
    model = Model(cfg)
    batch = _batch(cfg, 2, 7, seed=3)
    want = [model.prefill(params, batch, cache_len=20)]
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
    log, cache = model.prefill(params, batch, cache_len=20)
    _close(log.numpy(), want[0][0].numpy())
    L, H, K, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim_
    S = 7 + (cfg.num_patch_tokens or 0)
    assert len(calls["flash"]) == k7 * L
    self_call = ((2, S, H, hd), (2, S, K, hd), True)
    if arch == WHISPER:
        Se = cfg.encoder_seq
        assert calls["flash"] == \
            [((2, Se, H, hd), (2, Se, K, hd), False)] * L \
            + [self_call, ((2, S, H, hd), (2, Se, H, hd), False)] * L
    else:
        assert calls["flash"] == [self_call] * L
    for t in range(3):
        log, cache = model.decode_step(params, cache,
                                       torch.tensor([t, t + 1]))
        _close(log.numpy(), want[t + 1][0].numpy())
        mine = calls["decode"][-k8 * L:]
        self_call = ((2, H, hd), (2, 20, K, hd), [S + 1 + t] * 2)
        if arch == WHISPER:
            assert mine == [self_call, ((2, H, hd), (2, Se, H, hd),
                                        [Se] * 2)] * L
        else:
            assert mine == [self_call] * L
    assert len(calls["decode"]) == 3 * k8 * L


@pytest.mark.parametrize("route", ["card", "cpu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_makes_no_host_read_and_stays_in_place(arch, route,
                                                           monkeypatch):
    """Under ``test_torch_capture.py``'s no-host-read dispatch mode, on the
    card's routing (forced on CPU tensors) and on the CPU's: no host read
    and no tensor made from host data (Whisper's cross lengths are made on
    the device), every cache tensor updated where it lies, the cross cache
    left as the prefill wrote it."""
    cfg = get_config(arch)
    params = init_params(cfg, device="cpu")
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    model = Model(cfg)
    S = 6 + (cfg.num_patch_tokens or 0)
    logits, cache = model.prefill(params, _batch(cfg, 2, 6), cache_len=S + 3)
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    before = {n: t.clone() for n, t in cache.items()}
    tok = torch.argmax(logits, -1)
    for _ in range(6):          # past the K/V cache's end
        with no_host_reads(monkeypatch):
            logits, out = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        assert out is cache
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    assert int(cache["pos"]) == S + 6
    assert torch.isfinite(logits).all()
    for name in cache:
        assert torch.equal(cache[name], before[name]) == (name in ("ck",
                                                                   "cv"))


def test_params_from_numpy_take_the_new_trees():
    """``llm_params_from_numpy`` follows ``init_params(device="meta")``:
    Whisper's ``encoder`` tree, ``frame_proj`` and the blocks' cross
    weights (K/V with H heads), InternVL2's ``vis_proj``, all with the
    reference's values; a cross weight of another shape is refused with
    its path."""
    cfg, params, _, jparams = _twins(WHISPER)
    assert sorted(params) == sorted(jparams) == [
        "blocks", "embed", "encoder", "final_norm", "frame_proj", "head"]
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
    assert tuple(params["blocks"]["wk_x"].shape) == (2, d, H, hd)
    assert "wk_x" not in params["encoder"]
    for tree, name in (("blocks", "wv_x"), ("blocks", "ln_x"),
                       ("encoder", "wq"), ("encoder", "wdn")):
        np.testing.assert_array_equal(params[tree][name].numpy(),
                                      jparams[tree][name])
    np.testing.assert_array_equal(params["frame_proj"].numpy(),
                                  jparams["frame_proj"])
    cfg, params, _, jparams = _twins(VLM)
    assert tuple(params["vis_proj"].shape) == (cfg.frontend_dim,
                                               cfg.d_model)
    np.testing.assert_array_equal(params["vis_proj"].numpy(),
                                  jparams["vis_proj"])
    cfg = get_config(WHISPER)
    tree = jax.tree_util.tree_map(np.asarray, _twins(WHISPER)[3])
    tree["blocks"]["wk_x"] = tree["blocks"]["wk_x"][:, :, :2]
    with pytest.raises(ValueError, match="blocks.wk_x: shape"):
        llm_params_from_numpy(cfg, tree)
