"""The port's LLM serving slice against the JAX package, on the CPU:
``repro_torch.models`` (dense decoder, prefill and decode) and
``repro_torch.serving.ServingEngine`` against ``repro.models.Model`` and
``repro.serving.ServingEngine`` on ``llama3.2-3b@smoke`` (float32, 2
layers, d 256), with the reference's ``init_params(PRNGKey(0))`` carried
across by ``llm_params_from_numpy``.  Logits agree at ``rtol=1e-4,
atol=1e-5·max|ref|`` (float sums in other orders); tokens, cache
bookkeeping and KV-arena statistics are equal.  At full width only shapes
are compared (``device="meta"``, nothing allocated)."""
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
from repro.serving import kv_block_bytes as jax_kv_block_bytes

import repro_torch.kernels as kernels
import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, init_params
from repro_torch.models.model import decode_lengths, init_cache
from repro_torch.params import llm_params_from_numpy
from repro_torch.serving import Request, ServingEngine, kv_block_bytes

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ARCH = "llama3.2-3b@smoke"


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def twins():
    """(cfg, port params, jax cfg, jax params) of the smoke config."""
    jcfg = jax_get_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, params, jcfg, jparams


def _prompt(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)) \
        .astype(np.int32)


def _jax_mask(jcache):
    """The reference's decode mask for the next token (model.py:1043-1049,
    sliding_window 0), from its cache."""
    kv_pos, pos = np.asarray(jcache["kv_pos"]), int(jcache["pos"])
    Sc = kv_pos.shape[0]
    kv_pos = kv_pos.copy()
    kv_pos[min(pos, Sc - 1)] = pos
    return (kv_pos >= 0) & (kv_pos <= pos)


@pytest.mark.parametrize("cache_len", [22, 16])
def test_prefill_and_decode_match_the_reference(twins, cache_len):
    """Prefill logits and cache, then five teacher-forced decode steps:
    with cache_len 22 the cache fills after two steps and its last slot is
    overwritten (pos >= Sc); with 16 the 20-token prompt keeps only its
    last 16 positions.  ``pos`` is an int32 tensor beside the cache, and
    every step updates the one cache in place (what a captured step
    replays)."""
    cfg, params, jcfg, jparams = twins
    jmodel, model = JaxModel(jcfg), Model(cfg)
    toks = _prompt(2, 20)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b,
                                                       cache_len=cache_len))(
        jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                               cache_len=cache_len)
    _close(log.numpy(), jlog)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name].numpy(), jcache[name])
    np.testing.assert_array_equal(cache["kv_pos"].numpy(), jcache["kv_pos"])
    assert int(cache["pos"]) == int(jcache["pos"]) == 20
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    assert cache["pos"].device == cache["kv_pos"].device == cache["k"].device
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    step = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(1)
    for _ in range(5):
        pos = int(cache["pos"])
        Sc = cache["k"].shape[2]
        np.testing.assert_array_equal(
            np.arange(Sc) < decode_lengths(pos, Sc), _jax_mask(jcache))
        tok = rng.integers(0, 512, 2).astype(np.int32)
        jlog, jcache = step(jparams, jcache, jnp.asarray(tok))
        log, out = model.decode_step(params, cache, torch.as_tensor(tok))
        assert out is cache
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
        _close(log.numpy(), jlog)
        np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                      jcache["kv_pos"])
        assert int(cache["pos"]) == int(jcache["pos"])
    _close(cache["k"].numpy(), jcache["k"])
    assert int(cache["pos"]) >= Sc     # the full-cache case was reached


def test_sliding_window_on_the_cpu_path(twins):
    """A sliding window on the CPU path (ring cache, windowed mask): the
    prefill's logits are the reference's, and each decode step's are the
    reference's own windowed prefill of the tokens so far.  The prompt of
    12 is longer than the ring of 8 and not a multiple of it, where the
    reference's decode step departs from its prefill (ROADMAP R8) and the
    port's does not (tests/test_torch_window.py has the cases)."""
    cfg, params, jcfg, jparams = twins
    cfg, jcfg = cfg.with_sliding_window(8), jcfg.with_sliding_window(8)
    jmodel, model = JaxModel(jcfg), Model(cfg)
    toks = _prompt(1, 12, seed=2)
    prefill = jax.jit(jmodel.prefill)
    jlog, _ = prefill(jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)})
    _close(log.numpy(), jlog)
    assert cache["k"].shape[2] == 8
    for t in (3, 7, 11):
        toks = np.concatenate([toks, [[t]]], 1).astype(np.int32)
        jlog, _ = prefill(jparams, {"tokens": jnp.asarray(toks)})
        log, cache = model.decode_step(params, cache, torch.tensor([t]))
        _close(log.numpy(), jlog)


def test_the_card_path_calls_k7_and_k8_with_the_models_arguments(
        twins, monkeypatch):
    """With the card's routing forced on CPU tensors, prefill calls the
    flash-attention wrapper once per layer (causal, the layer's q/k/v) and
    each decode step the decode-attention wrapper once per layer with the
    prefix lengths; the kernels' plain versions there give the CPU path's
    logits.  On the CPU the model calls neither wrapper."""
    cfg, params, _, _ = twins
    model = Model(cfg)
    toks = torch.as_tensor(_prompt(2, 10, seed=3))
    calls = {"flash": [], "decode": []}

    def no_kernel(*a, **kw):
        raise AssertionError("the CPU path called a kernel wrapper")

    monkeypatch.setattr(kernels, "flash_attention", no_kernel)
    monkeypatch.setattr(kernels, "decode_attention", no_kernel)
    want = [model.prefill(params, {"tokens": toks}, cache_len=12)]
    cache = want[0][1]
    for t in range(3):
        want.append(model.decode_step(params, cache,
                                      torch.tensor([t, t + 1])))
        cache = want[-1][1]

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
    log, cache = model.prefill(params, {"tokens": toks}, cache_len=12)
    _close(log.numpy(), want[0][0].numpy())
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    assert calls["flash"] == [((2, 10, H, hd), (2, 10, K, hd), True)] * 2
    for t in range(3):
        log, cache = model.decode_step(params, cache,
                                       torch.tensor([t, t + 1]))
        _close(log.numpy(), want[t + 1][0].numpy())
        assert calls["decode"][-2:] == [((2, H, hd), (2, 12, K, hd),
                                         [min(11 + t, 12)] * 2)] * 2
    assert len(calls["decode"]) == 3 * cfg.num_layers


def _jax_reqs(n, seed=0):
    """tests/test_serving.py's traffic."""
    rng = np.random.default_rng(seed)
    return [JaxRequest(rid=i, prompt=rng.integers(0, 500, rng.integers(4, 12))
                       .astype(np.int32), max_new_tokens=6)
            for i in range(n)]


def test_serving_engine_matches_the_reference(twins, monkeypatch):
    """tests/test_serving.py's traffic (5 requests, max_batch 2, cache_len
    48): the same greedy tokens and the same KV-arena statistics.  The
    engine reads its tokens from the device once per batch."""
    cfg, params, jcfg, jparams = twins
    jeng = JaxServingEngine(jcfg, jparams, max_batch=2, cache_len=48)
    jres = jeng.serve(_jax_reqs(5))
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=48, device="cpu")
    reads = []
    tolist = torch.Tensor.tolist

    def counted(t):
        reads.append(tuple(t.shape))
        return tolist(t)
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    res = eng.serve([Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in _jax_reqs(5)])
    monkeypatch.undo()
    assert reads == [(2, 6), (2, 6), (1, 6)]   # [B, max_new] per batch
    assert sorted(eng._steps) == [1, 2]        # one decode step per B
    assert [r.rid for r in res] == [r.rid for r in jres]
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert eng.block_bytes == jeng.block_bytes
    for name in ("kv_arena_peak_bytes", "kv_static_bytes", "peak_concurrent",
                 "requests", "dispatches"):
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    assert eng.stats.kv_arena_peak_bytes == 2 * eng.block_bytes
    assert eng.stats["arena_peak_bytes"] == eng.stats.kv_arena_peak_bytes


def test_launcher_serves_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu``: the reference
    launcher's traffic, every request answered, then the L1 report."""
    eng = launch_serve.main(["--arch", ARCH, "--requests", "3",
                             "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("tokens=") == 3 and "arena peak" in out
    assert eng.stats.requests == 3 and eng.device.type == "cpu"
    # the last line is the decode step's reordering at max_batch 4, cache 96
    last = out.strip().splitlines()[-1]
    assert last.startswith("fx reorder: 25 ops, peak 6,829,804 -> ")
    assert eng.reorder_report.n_eqns == 25


@pytest.mark.parametrize("arch", ["zamba2-2.7b@smoke", "xlstm-350m@smoke"])
def test_recurrent_decoders_serve_the_references_tokens(arch):
    """The Zamba2 hybrid and xLSTM through ``ServingEngine`` on
    tests/test_serving.py's traffic: the reference engine's greedy tokens,
    KV block and arena statistics; then the launcher serves the model on
    the CPU and prints the L1 report, the layer stack one operator."""
    jcfg = jax_get_config(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    jeng = JaxServingEngine(jcfg, jparams, max_batch=2, cache_len=48)
    jres = jeng.serve(_jax_reqs(5))
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=48, device="cpu")
    res = eng.serve([Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in _jax_reqs(5)])
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert eng.block_bytes == jeng.block_bytes
    for name in ("kv_arena_peak_bytes", "kv_static_bytes", "peak_concurrent",
                 "requests", "dispatches"):
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    eng = launch_serve.main(["--arch", arch, "--requests", "3",
                             "--max-new", "4", "--device", "cpu"])
    assert eng.stats.requests == 3
    op = {"zamba2-2.7b@smoke": 25, "xlstm-350m@smoke": 10}[arch]
    assert eng.reorder_report.n_eqns == op
    assert [n.target for n in eng.reordered_step.gm.graph.nodes
            if n.op == "call_function"].count(
        torch.ops.repro_torch.decode_recurrent_layers.default) == 1


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-7b", "glm4-9b",
                                  "phi3-medium-14b",
                                  "granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
                                  "xlstm-350m", "whisper-large-v3",
                                  "internvl2-1b"])
def test_full_width_parameters_and_kv_blocks_match(arch):
    """At full width, without allocating: the port's parameters on the meta
    device have the reference's names, shapes and dtypes (Zamba2's
    unstacked ``shared_attn``, Whisper's encoder and cross weights,
    InternVL2's ``vis_proj`` included), and a request's KV block the
    reference's bytes (Llama-3.2-3B: k + v = 2·28·Sc·8·128·2, plus pos
    4 B and kv_pos 4·Sc; Zamba2: 9 K/V layers, conv windows and SSM
    states; xLSTM: its recurrent states only, whatever the cache length;
    Whisper: k + v, and the cross cache ck + cv = 2·32·1500·20·64·2 B
    whatever the cache length; the dense models' k + v = 2·L·Sc·K·D·2 B:
    Qwen2-7B 28 layers of 4 kv heads, GLM-4-9B 40 of 2, Phi-3-medium 40
    of 10; Phi-3.5-MoE 32 of 8, or 8 at the depth it runs on one card).
    The three dense models fit one 80 GB card in bf16 at full depth
    (15.23, 18.80 and 29.32 GB), one at a time."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = _shapes(init_params(cfg, device="meta"))
    want = _shapes(jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0))))
    assert got == want
    for cache_len in (96, 2048):
        assert kv_block_bytes(cfg, cache_len) == \
            jax_kv_block_bytes(jcfg, cache_len)
    # the MoE models' sizes with the vocab padded to a multiple of 128
    # (the config's param_count: 1 384 912 896 and 41 872 261 120 over the
    # logical vocab): Granite-3.0-1B-A400M fits one 80 GB card in bf16
    # (2.77 GB), Phi-3.5-MoE does not (83.75 GB)
    n = sum(int(np.prod(shape)) for shape, _ in got.values())
    assert n == {"qwen2-7b": 7_615_616_512,
                 "glm4-9b": 9_399_767_040,
                 "phi3-medium-14b": 14_659_507_200,
                 "granite-moe-1b-a400m": 1_385_219_072,
                 "phi3.5-moe-42b-a6.6b": 41_873_051_648,
                 "zamba2-2.7b": 2_422_386_848,
                 "xlstm-350m": 212_300_880,
                 "whisper-large-v3": 2_022_319_360,
                 "internvl2-1b": 630_626_176}.get(arch, n)
    blocks = {"qwen2-7b": (5_505_412, 117_448_708),
              "glm4-9b": (3_932_548, 83_894_276),
              "phi3-medium-14b": (19_661_188, 419_438_596),
              "phi3.5-moe-42b-a6.6b": (12_583_300, 268_443_652),
              "zamba2-2.7b": (81_326_980, 261_231_108),
              "xlstm-350m": (21_118_980, 21_118_980),
              "whisper-large-v3": (261_489_028, 581_312_516),
              "internvl2-1b": (1_180_036, 25_174_020)}
    if arch == "phi3.5-moe-42b-a6.6b":     # 8 of 32 layers, as on the card
        cut = cfg.replace(num_layers=8)
        assert kv_block_bytes(cut, 96) == 3_146_116
        assert sum(int(np.prod(t.shape)) for t in _leaves(init_params(
            cut, device="meta"))) == 10_665_660_416
    if arch == "internvl2-1b":
        # its served cache: 256 patch rows + prompt + new tokens fit 320
        assert kv_block_bytes(cfg, 320) == 3_933_444
    if arch in blocks:
        assert (kv_block_bytes(cfg, 96), kv_block_bytes(cfg, 2048)) == \
            blocks[arch]
    if arch == "llama3.2-3b":
        assert kv_block_bytes(cfg, 96) == 11_010_436
        assert kv_block_bytes(cfg, 2048) == 234_889_220
        c = init_cache(cfg, 4, 2048, device="meta")
        assert tuple(c["k"].shape) == (28, 4, 2048, 8, 128)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


# Narrow twins of the four largest registered LLMs (2 layers, heads of 16,
# float32) that keep what sets each apart: its GQA group (Qwen2 7, GLM-4
# 16, Phi-3-medium and Phi-3.5-MoE 4), Qwen2's QKV bias, Phi-3.5-MoE's 16
# experts top 2, and each model's RoPE theta and vocabulary rule
NARROW = {"qwen2-7b": dict(num_heads=14, num_kv_heads=2),
          "glm4-9b": dict(num_heads=16, num_kv_heads=1),
          "phi3-medium-14b": dict(num_heads=8, num_kv_heads=2),
          "phi3.5-moe-42b-a6.6b": dict(num_heads=8, num_kv_heads=2)}


@pytest.mark.parametrize("arch", sorted(NARROW))
def test_narrow_twins_of_the_large_models_match_the_reference(
        arch, monkeypatch):
    """Prefill of B 2 x S 9 at cache 12, then four teacher-forced decode
    steps (the cache fills at the third), the port against the JAX
    package on the reference's ``init_params(PRNGKey(0))``: logits within
    ``rtol=1e-4, atol=1e-5·max|ref|`` (float32 sums in other orders, as
    the smoke configs' tests).  Then the card's route on CPU tensors (the
    kernels' wrappers on their plain versions): K8 receives the model's
    whole group of query heads per kv head and gives the CPU route's
    logits."""
    changes = dict(NARROW[arch], num_layers=2, head_dim=16, d_ff=64,
                   vocab_size=512, attn_chunk=16, dtype="float32")
    changes["d_model"] = 16 * changes["num_heads"]
    jcfg = jax_get_config(arch).replace(**changes)
    cfg = get_config(arch).replace(**changes)
    assert cfg.qkv_bias == (arch == "qwen2-7b")
    assert cfg.num_experts == (16 if cfg.is_moe else 0)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    if cfg.qkv_bias:    # drawn as zeros: seeded values, so that they count
        blocks = dict(jparams["blocks"])
        for name in ("bq", "bk", "bv"):
            blocks[name] = jnp.asarray(0.5 * rng.standard_normal(
                blocks[name].shape), blocks[name].dtype)
        jparams = dict(jparams, blocks=blocks)
    params = llm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams))
    jmodel, model = JaxModel(jcfg), Model(cfg)
    toks = rng.integers(0, 512, (2, 9)).astype(np.int32)
    fed = rng.integers(0, 512, (4, 2)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=12))(
        jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                               cache_len=12)
    _close(log.numpy(), jlog)
    want = [log]
    step = jax.jit(jmodel.decode_step)
    for t in fed:
        jlog, jcache = step(jparams, jcache, jnp.asarray(t))
        log, cache = model.decode_step(params, cache, torch.as_tensor(t))
        _close(log.numpy(), jlog)
        want.append(log)
    groups = []

    def decode(q, k_cache, v_cache, lengths):
        groups.append(q.shape[1] // k_cache.shape[2])
        return decode_ops.decode_attention(q, k_cache, v_cache, lengths)
    monkeypatch.setattr(kernels, "decode_attention", decode)
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                               cache_len=12)
    got = [log]
    for t in fed:
        got.append(model.decode_step(params, cache, torch.as_tensor(t))[0])
    assert groups == [cfg.num_heads // cfg.num_kv_heads] * (4 * 2)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_sliding_window_runs_on_the_card_route(twins, monkeypatch):
    """A windowed model on the card's route (CUDA tensors faked, so the
    kernels' wrappers run their plain versions on the CPU data) no longer
    raises: prefill hands K7 the window, each decode step hands K8 the
    ring's prefix, and the logits are the CPU route's."""
    cfg, params, _, _ = twins
    model = Model(cfg.with_sliding_window(8))
    toks = {"tokens": torch.as_tensor(_prompt(1, 12, seed=2))}
    want = [model.prefill(params, toks)]
    for t in (3, 7, 11):
        want.append(model.decode_step(params, want[-1][1], torch.tensor([t])))
    windows, lengths = [], []

    def flash(q, k, v, *, causal, window=0):
        windows.append(window)
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)

    def decode(q, k_cache, v_cache, lens):
        lengths.append(lens.tolist())
        return decode_ops.decode_attention(q, k_cache, v_cache, lens)
    monkeypatch.setattr(kernels, "flash_attention", flash)
    monkeypatch.setattr(kernels, "decode_attention", decode)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = [model.prefill(params, toks)]
    for t in (3, 7, 11):
        got.append(model.decode_step(params, got[-1][1], torch.tensor([t])))
    monkeypatch.undo()
    assert windows == [8] * cfg.num_layers
    assert lengths == [[8]] * (3 * cfg.num_layers)
    for (g, _), (w, _) in zip(got, want):
        _close(g.numpy(), w.numpy())
