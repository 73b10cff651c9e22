"""The port's sharded model against the JAX package, on the CPU: four
gloo ranks on a (2, 2) ("data", "model") mesh (``make_local_mesh(2,
device="cpu")``), started once for the module (``ranks``: every case in
one spawn, while the references run here), the reference's
``init_params(PRNGKey(0))`` carried across by ``llm_params_from_numpy``
and placed by ``param_specs``.  ``test_torch_mesh_train.py`` holds a
sharded train step the same way.

Serving cases: prefill of B 4 × S 8 at cache 16, then three decode steps
on fixed tokens, the logits of each against the reference's unsharded
prefill and steps — Llama in both KV modes; Llama with a window of 8
after an 11-token prompt (ROADMAP R8's case) against the reference's
windowed prefill of the same tokens, as ``test_torch_window.py`` holds
the unsharded port; context-parallel prefill (``act_shard="cp"``),
also of 11 rows, which two ranks split 6 / 5;
Zamba2, xLSTM, and Whisper on the data pipeline's seeded frames.
Granite's expert-parallel MoE reckons capacity per data shard, so it is
held against the reference's own sharded run (a subprocess with four
forced host devices and an Auto-axes ``Mesh``: its ``make_local_mesh``
gives Explicit axes that its ``_shard`` refuses, ROADMAP R9), and the
reference's unsharded run must differ from it.

Tolerance ``rtol=1e-4, atol=1e-5·max|ref|``, or where larger twice the
unsharded port's own distance from the reference or twice its logits'
float32 rounding spread (``_port_floor``): xLSTM's smoke logits move by
~2e-5 of max|logit| when the parameters move by one float32 rounding,
and the unsharded port lies ~6e-5 from the reference on these inputs
(the sLSTM's exponential gates), so the sharded port is held to be no
farther from the reference than twice that."""
import multiprocessing as mp
import os
import queue as queue_mod
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import Model
from repro_torch.params import llm_params_from_numpy
from repro_torch.training.optimizer import tree_map


torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, CACHE, STEPS, W = 4, 8, 16, 3, 8
LLAMA, GRANITE = "llama3.2-3b@smoke", "granite-moe-1b-a400m@smoke"
# name: (arch, config changes, prompt tokens)
SERVE = {
    "llama-heads": (LLAMA, {"kv_mode": "heads"}, S),
    "llama-sequence": (LLAMA, {"kv_mode": "sequence"}, S),
    "llama-window-heads": (LLAMA, {"sliding_window": W, "kv_mode": "heads"},
                           11),
    "llama-window-sequence": (LLAMA, {"sliding_window": W,
                                      "kv_mode": "sequence"}, 11),
    "llama-cp": (LLAMA, {"act_shard": "cp"}, S),
    "llama-cp-uneven": (LLAMA, {"act_shard": "cp"}, 11),
    "zamba2": ("zamba2-2.7b@smoke", {}, S),
    "xlstm": ("xlstm-350m@smoke", {}, S),
    "whisper": ("whisper-large-v3@smoke", {}, S),
    "granite": (GRANITE, {}, S),
}


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def _items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(p.key for p in path), np.asarray(leaf))
            for path, leaf in flat]


def _close(got, want, what="", atol=None):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), want, rtol=1e-4,
        atol=1e-5 * float(np.abs(want).max()) if atol is None else atol,
        err_msg=what)


def _serve_inputs(name):
    arch, changes, prompt = SERVE[name]
    cfg = get_config(arch).replace(**changes)
    rng = np.random.default_rng(3)
    feed = {"tokens": rng.integers(0, cfg.vocab_size, (B, prompt))
            .astype(np.int32)}
    if cfg.arch_type == "audio":
        feed["frames"] = SyntheticLMDataset(cfg, B, prompt, 2).batch(0)[
            "frames"]
    fed = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return arch, changes, feed, fed


_REFERENCE_SERVE = {}


def _reference_serve(name):
    """The reference's logits (prefill, then each fed step), unsharded;
    with a window, its windowed prefill of the tokens so far.  Without a
    mesh ``kv_mode`` and ``act_shard`` change nothing: cases that differ
    only there share one run."""
    arch, changes, feed, fed = _serve_inputs(name)
    key = (arch, changes.get("sliding_window", 0), SERVE[name][2])
    if key in _REFERENCE_SERVE:
        return _REFERENCE_SERVE[key]
    jcfg = jax_get_config(arch).replace(**changes)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = JaxModel(jcfg)
    prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=CACHE))
    step = jax.jit(model.decode_step)
    logits, cache = prefill(jparams, {k: jnp.asarray(v)
                                      for k, v in feed.items()})
    out = [np.asarray(logits)]
    toks = feed["tokens"]
    for t in fed:
        if jcfg.sliding_window:
            toks = np.concatenate([toks, t[:, None]], 1)
            logits, _ = prefill(jparams, dict(feed, tokens=jnp.asarray(toks)))
        else:
            logits, cache = step(jparams, cache, jnp.asarray(t))
        out.append(np.asarray(logits))
    _REFERENCE_SERVE[key] = _np(jparams), out
    return _REFERENCE_SERVE[key]


def _port_floor(name, nparams, want):
    """Per step, the larger of how far the port's unsharded logits lie
    from the reference's ``want`` and how far they move when every
    parameter moves by one float32 rounding (``x·(1 + 2^-24·n)``, n
    standard normal, seeded: ``test_torch_training._rounding_spread``'s
    rule for the logits)."""
    arch, changes, feed, fed = _serve_inputs(name)
    cfg = get_config(arch).replace(**changes)
    params = llm_params_from_numpy(cfg, nparams)
    gen = torch.Generator().manual_seed(7)
    moved = tree_map(lambda t: (t * (1 + 2.0 ** -24 * torch.randn(
        t.shape, generator=gen))).to(t.dtype), params)
    runs = [_port_logits(Model(cfg), p, feed, fed) for p in (params, moved)]
    return [max(float(np.abs(a - w).max()), float(np.abs(a - b).max()))
            for a, b, w in zip(*runs, want)]


def _port_logits(model, params, feed, fed):
    """Prefill ``feed`` at ``CACHE``, then decode the ``fed`` tokens: the
    logits of each, whole, as numpy."""
    from repro_torch.models.sharding import full
    logits, cache = model.prefill(
        params, {k: torch.as_tensor(v) for k, v in feed.items()},
        cache_len=CACHE)
    got = [full(logits).numpy()]
    for t in fed:
        logits, cache = model.decode_step(params, cache,
                                          torch.as_tensor(t).long())
        got.append(full(logits).numpy())
    return got


# the reference's sharded serving of Granite: four forced host devices
# and an Auto-axes mesh (ROADMAP R9); writes the logits of the prefill and
# of each fed step to the npz of argv[1]
REFERENCE_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.models.model import Model, init_params, param_specs
out, arch, cache_len = sys.argv[1], sys.argv[2], int(sys.argv[3])
feed_tokens, fed = np.load(sys.argv[4]), np.load(sys.argv[5])
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = get_config(arch)
model = Model(cfg, mesh)
params = jax.tree_util.tree_map(
    lambda t, s: jax.device_put(t, NamedSharding(mesh, s)),
    init_params(cfg, jax.random.PRNGKey(0)), param_specs(cfg, mesh))
logits, cache = jax.jit(lambda p, t: model.prefill(
    p, {"tokens": t}, cache_len=cache_len))(params, jnp.asarray(feed_tokens))
res = {"logits0": np.asarray(logits)}
step = jax.jit(model.decode_step)
for i, t in enumerate(fed):
    logits, cache = step(params, cache, jnp.asarray(t))
    res[f"logits{i + 1}"] = np.asarray(logits)
np.savez(out, **res)
"""


def start_script(script: str, tmp: Path, *args) -> subprocess.Popen:
    """A reference script in a process of its own (its ``XLA_FLAGS`` must
    come before JAX starts), writing ``tmp/ref.npz``; ``finish_script``
    reads it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "ref.npz"),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_script(proc: subprocess.Popen, tmp: Path):
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _tree(res, prefix):
    """The nested tree of the ``prefix`` keys of ``res``."""
    out = {}
    for key, v in res.items():
        if key.startswith(prefix):
            node = out
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


# finish_ranks polls the queue and the ranks' exit codes this often (s),
# and gives the ranks this long in all (s)
RANK_POLL, RANK_TIMEOUT = 2.0, 600.0


def _rank(rank, world, rendezvous, work, payload, queue):
    """One CPU rank: ``work(mesh, payload)`` on the (2, 2) mesh; rank 0
    puts its result on ``queue``, a rank that raises its traceback.  The
    ranks meet through the file ``rendezvous`` (a ``FileStore``): no port
    is picked and let go before a rank binds it."""
    import traceback
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_local_mesh
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                                rank=rank, world_size=world)
        try:
            res = work(make_local_mesh(2, device="cpu"), payload)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            queue.put(("ok", res))
    except BaseException:
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise


def start_ranks(work, payload, tmp: Path):
    """Four spawned CPU ranks running ``work``, meeting through a new file
    in the directory ``tmp``; ``finish_ranks`` waits."""
    rendezvous = tmp / "rendezvous"
    assert not rendezvous.exists(), rendezvous      # a FileStore's, fresh
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 4, rendezvous, work, payload,
                                             queue)) for r in range(4)]
    for p in procs:
        p.start()
    return procs, queue


def finish_ranks(procs, queue):
    """Rank 0's result.  Polls the queue and the ranks' exit codes every
    ``RANK_POLL`` seconds: a rank that raised fails it with its
    traceback, a rank that died without a word (killed) with the exit
    codes, at once; after ``RANK_TIMEOUT`` seconds it fails too.  Every
    rank still running at the end is killed."""
    t0 = time.monotonic()
    try:
        while True:
            # read before the wait: what a rank put before it exited is
            # on the queue by then
            codes = [p.exitcode for p in procs]
            try:
                status, res = queue.get(timeout=RANK_POLL)
                break
            except queue_mod.Empty:
                assert not any(codes) and None in codes, \
                    f"a rank exited without a result: exit codes {codes}"
                assert time.monotonic() - t0 < RANK_TIMEOUT, \
                    f"the ranks took over {RANK_TIMEOUT} s: exit codes " \
                    f"{codes}"
        assert status == "ok", \
            f"{res}\nexit codes {[p.exitcode for p in procs]}"
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return res


def _serve_cases(mesh, serve):
    from repro_torch.models.model import shard_params
    out = {}
    for name, (arch, changes, feed, fed, nparams) in serve.items():
        cfg = get_config(arch).replace(**changes)
        params = shard_params(llm_params_from_numpy(cfg, nparams), cfg, mesh)
        out[name] = _port_logits(Model(cfg, mesh), params, feed, fed)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(port logits, reference logits, floors): the reference's sharded
    Granite run and the four ranks started first, the references and
    the port's unsharded floors computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh")
    _, _, feed, fed = _serve_inputs("granite")
    np.save(tmp / "feed.npy", feed["tokens"])
    np.save(tmp / "fed.npy", fed)
    script = start_script(REFERENCE_SHARDED, tmp, GRANITE, CACHE,
                          tmp / "feed.npy", tmp / "fed.npy")
    serve = {}
    for name in SERVE:
        arch, changes, feed, fed = _serve_inputs(name)
        jcfg = jax_get_config(arch).replace(**changes)
        nparams = _np(jax_init_params(jcfg, jax.random.PRNGKey(0)))
        serve[name] = (arch, changes, feed, fed, nparams)
    procs, queue = start_ranks(_serve_cases, serve, tmp)
    want, floor = {}, {}
    for name in SERVE:
        _, want[name] = _reference_serve(name)
        floor[name] = _port_floor(name, serve[name][4], want[name])
    sharded = finish_script(script, tmp)
    want["granite-sharded"] = [sharded[f"logits{i}"]
                               for i in range(STEPS + 1)]
    return finish_ranks(procs, queue), want, floor


def _serve_atol(w, floor):
    """1e-5·max|ref|, or twice the port's floor (``_port_floor``) where
    larger."""
    return max(1e-5 * float(np.abs(w).max()), 2 * floor)


@pytest.mark.parametrize("name", [n for n in SERVE if n != "granite"])
def test_sharded_serving_matches_the_reference(ranks, name):
    got, want, floor = ranks
    for i, (g, w, f) in enumerate(zip(got[name], want[name], floor[name])):
        _close(g, w, f"{name} step {i}", atol=_serve_atol(w, f))


def test_expert_parallel_moe_matches_the_references_sharded_run(ranks):
    """Capacity per data shard: B 4 over data 2 gives each shard 2 rows'
    tokens and its own capacity, as the reference's sharded run reckons
    it; at the default capacity factor its unsharded run drops other
    tokens, and the port's sharded logits leave that run by far more
    than the tolerance."""
    got, want, floor = ranks
    for i, (g, w, f) in enumerate(zip(got["granite"],
                                      want["granite-sharded"],
                                      floor["granite"])):
        _close(g, w, f"granite step {i}", atol=_serve_atol(w, f))
    rel = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in zip(got["granite"], want["granite"]))
    assert rel > 1e-2, rel


R9 = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_local_mesh
from repro.models.model import Model, init_params
cfg = get_config("llama3.2-3b@smoke")
mesh = make_local_mesh(2)
print([t.name for t in mesh.axis_types])
try:
    Model(cfg, mesh).prefill(init_params(cfg, jax.random.PRNGKey(0)),
                             {"tokens": jnp.zeros((4, 8), jnp.int32)})
except ValueError as e:
    print("ValueError", e)
"""


def test_r9_the_references_local_mesh_refuses_its_own_constraints():
    """ROADMAP R9: on jax 0.9.0 the reference's ``make_local_mesh``
    (``jax.make_mesh``) gives Explicit axes, and its model's first
    ``_shard`` (``with_sharding_constraint``) refuses them; its sharded
    runs above use an Auto-axes ``Mesh``.  The port's ``make_local_mesh``
    takes its constraints (every case above)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", R9], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "['Explicit', 'Explicit']"
    assert lines[1].startswith("ValueError") and \
        "can only refer to Auto axes" in lines[1]
