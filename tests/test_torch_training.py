"""The port's training substrate against the JAX package, on the CPU:
``Model.loss_fn`` (loss, ``ce``, ``aux`` and every gradient) of the six
smoke architectures, one ``make_train_step`` step (parameters, moments,
step and metrics), ``cosine_lr`` and ``adamw_update`` against
``repro.models.Model`` / ``repro.training``, with the reference's
``init_params(PRNGKey(0))`` carried across by ``llm_params_from_numpy``
and the optimizer state by ``adamw_state_from_numpy``.  Batches come from
``repro_torch.data.SyntheticLMDataset`` (seeded tokens, frames and
patches).  Tolerance ``rtol=1e-4, atol=1e-5·max|ref|`` (float sums in
other orders), as ``test_torch_llm.py``'s.  Then the intents of
``tests/test_training.py`` on the port alone, checkpoints crossing
between the packages (bf16 too, which the reference cannot restore:
ROADMAP R7), and the step under ``test_torch_capture.py``'s host-read
mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import init_params as jax_init_params
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import cosine_lr as jax_cosine_lr
from repro.training import make_train_step as jax_make_train_step
from repro.training import train_state_init as jax_train_state_init
from repro.training.checkpoint import restore_checkpoint as jax_restore
from repro.training.checkpoint import save_checkpoint as jax_save

import repro_torch.kernels as kernels
import repro_torch.models.model as model_mod
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.params import adamw_state_from_numpy, llm_params_from_numpy
from repro_torch.training import (AdamWState, TrainState, adamw_init,
                                  adamw_update, cosine_lr, make_train_step,
                                  train_state_init)
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import tree_items, tree_leaves, tree_map

from test_torch_capture import no_host_reads

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

ARCHS = ("llama3.2-3b@smoke", "granite-moe-1b-a400m@smoke",
         "zamba2-2.7b@smoke", "xlstm-350m@smoke", "whisper-large-v3@smoke",
         "internvl2-1b@smoke")


def _close(got, want, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _np(tree):
    """A JAX pytree as numpy (bf16 leaves widened exactly to float32)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def _jax_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(p.key for p in path), leaf) for path, leaf in flat]


def _twins(arch, key=0, **changes):
    jcfg = jax_get_config(arch).replace(**changes)
    jparams = jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(key))
    cfg = get_config(arch).replace(**changes)
    params = tree_map(lambda t: t.requires_grad_(),
                      llm_params_from_numpy(cfg, _np(jparams)))
    return cfg, params, jcfg, jparams


def _batch(cfg, B=4, S=32, seed=0):
    return SyntheticLMDataset(cfg, B, S, seed).batch(0)


def clone_state(state):
    """A copy of ``state`` that a step can update in place without
    touching it."""
    def copy(t):
        return t.detach().clone()
    params = tree_map(lambda t: copy(t).requires_grad_(), state.params)
    return TrainState(params, AdamWState(copy(state.opt.step),
                                         tree_map(copy, state.opt.mu),
                                         tree_map(copy, state.opt.nu)))


def _grads(model, params, batch, remat=True):
    loss, metrics = model.loss_fn(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), metrics, grads


def _rounding_spread(model, params, batch, grads):
    """Per leaf, how far the port's own gradients move when every
    parameter moves by one float32 rounding (x·(1 + 2^-24·n), n standard
    normal, seeded): the floor below which no float32 evaluation of this
    loss can pin its gradient."""
    gen = torch.Generator().manual_seed(7)
    moved = tree_map(lambda t: (t.detach() * (1 + 2.0 ** -24 * torch.randn(
        t.shape, generator=gen))).to(t.dtype).requires_grad_(), params)
    return [float((a - b).abs().max())
            for a, b in zip(_grads(model, moved, batch)[2], grads)]


@pytest.mark.parametrize("arch,changes", [(a, {}) for a in ARCHS] + [
    ("llama3.2-3b@smoke", {"sliding_window": 8}),
    ("llama3.2-3b@smoke", {"tie_embeddings": True})],
    ids=list(ARCHS) + ["llama-window8", "llama-tied"])
def test_loss_and_gradients_match_the_reference(arch, changes):
    """``loss_fn`` with remat at B 4 × S 32 (InternVL2: 8 patch rows and 24
    tokens; Whisper over 16 frames): loss, ``ce``, ``aux`` and every
    gradient leaf against ``jax.value_and_grad(Model.loss_fn)``.  The
    window case trains Llama with ``sliding_window`` 8 (the chunked
    path's window, on either device), the tied case with the embedding
    as the head (no registered config ties them).

    A gradient leaf's ``atol`` is 1e-5·max|ref| or, where it is larger,
    twice the leaf's ``_rounding_spread``: Zamba2's and xLSTM's smoke
    gradients move by up to 1.3e-3 and 5.4e-5 of max|ref| (embed,
    ``mlstm/w_v``) when the parameters move by one float32 rounding, so
    neither package's float32 gradient is closer than that to the exact
    one; the other four architectures' spread is below 1e-5·max|ref|."""
    cfg, params, jcfg, jparams = _twins(arch, **changes)
    batch = _batch(cfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JaxModel(jcfg).loss_fn(p, b, remat=True),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg)
    loss, metrics, grads = _grads(model, params, batch)
    _close(loss, jloss, "loss")
    for k in ("ce", "aux"):
        _close(metrics[k], jm[k], k)
    if cfg.is_moe:
        assert float(metrics["aux"].detach()) > 0
    want = _jax_items(_np(jgrads))
    assert [k for k, _ in want] == [k for k, _ in tree_items(params)]
    spread = _rounding_spread(model, params, batch, grads)
    for (key, w), g, (_, p), sp in zip(want, grads, tree_items(params),
                                       spread):
        assert g.dtype == p.dtype, key
        w = np.asarray(w, dtype=np.float64)
        np.testing.assert_allclose(
            g.double().numpy(), w, rtol=1e-4,
            atol=max(1e-5 * float(np.abs(w).max()), 2 * sp), err_msg=key)


@pytest.mark.parametrize("arch,microbatches", [("llama3.2-3b@smoke", 1),
                                               ("granite-moe-1b-a400m@smoke",
                                                2)])
def test_one_train_step_matches_the_reference(arch, microbatches):
    """Two reference steps make a state with non-zero moments (so the
    compared step is not AdamW's sign-like first one); from it, one step
    of each package on the next batch: every parameter, ``mu``, ``nu``,
    ``step`` and the metrics."""
    kw = dict(peak_lr=3e-3, warmup=1, total_steps=10, remat=True)
    cfg, _, jcfg, _ = _twins(arch)
    jmodel = JaxModel(jcfg)
    jstate = jax.jit(jax_train_state_init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jmodel, microbatches=microbatches,
                                        **kw))
    ds = SyntheticLMDataset(cfg, 4, 32, seed=0)
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in ds.batch(i).items()})
    state = TrainState(
        tree_map(lambda t: t.requires_grad_(),
                 llm_params_from_numpy(cfg, _np(jstate.params))),
        adamw_state_from_numpy(cfg, _np(jstate.opt.mu), _np(jstate.opt.nu),
                               jstate.opt.step))
    batch = ds.batch(2)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(Model(cfg), microbatches=microbatches, **kw)
    state, m = step(state, batch)
    assert sorted(m) == sorted(jm)
    for k in m:
        _close(m[k], jm[k], k)
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    for name, got, want in (("params", state.params, jstate.params),
                            ("mu", state.opt.mu, jstate.opt.mu),
                            ("nu", state.opt.nu, jstate.opt.nu)):
        for (key, w), (_, g) in zip(_jax_items(_np(want)), tree_items(got)):
            _close(g, w, f"{name} {key}")


def test_cosine_lr_matches_the_reference():
    for step in (0, 10, 55, 100):
        got = cosine_lr(torch.tensor(step, dtype=torch.int32), peak=1.0,
                        warmup=10, total=100)
        want = jax_cosine_lr(jnp.int32(step), peak=1.0, warmup=10,
                             total=100)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(cosine_lr(torch.tensor(0), peak=1.0, warmup=10,
                           total=100)) == 0.0


def test_adamw_update_matches_the_reference():
    """Two updates of a tree with 1-D (no decay), 2-D and bf16 leaves,
    bf16 gradients among them, the second clipped (global norm > 1)."""
    rng = np.random.default_rng(0)
    shapes = {"b": (5,), "w": {"a": (4, 6), "h": (3, 2, 4)}}
    dtypes = {"b": jnp.float32, "w": {"a": jnp.float32, "h": jnp.bfloat16}}

    def tree(scale):
        return jax.tree_util.tree_map(
            lambda s, d: jnp.asarray(rng.standard_normal(s) * scale, d),
            shapes, dtypes, is_leaf=lambda s: isinstance(s, tuple))

    jparams = tree(1.0)
    params = tree_map(torch.tensor, _np(jparams))
    params["w"]["h"] = params["w"]["h"].to(torch.bfloat16)
    jstate, state = jax_adamw_init(jparams), adamw_init(params)
    for scale, lr in ((0.1, 1e-2), (3.0, 3e-2)):
        jgrads = tree(scale)
        grads = tree_map(torch.tensor, _np(jgrads))
        grads["w"]["h"] = grads["w"]["h"].to(torch.bfloat16)
        jparams, jstate, jm = jax_adamw_update(jparams, jgrads, jstate,
                                               lr=jnp.float32(lr))
        params, state, m = adamw_update(params, grads, state,
                                        lr=torch.tensor(lr))
        _close(m["grad_norm"], jm["grad_norm"], "grad_norm")
        for name, got, want in (("params", params, jparams),
                                ("mu", state.mu, jstate.mu),
                                ("nu", state.nu, jstate.nu)):
            for (key, w), (_, g) in zip(_jax_items(_np(want)),
                                        tree_items(got)):
                _close(g, w, f"{name} {key}")
    assert params["w"]["h"].dtype == torch.bfloat16
    assert int(state.step) == 2 and state.step.dtype == torch.int32


def test_loss_decreases_on_markov_data():
    """tests/test_training.py's intent: 30 steps at B 8 × S 64, the mean of
    the last five losses below the first five's minus 0.25."""
    cfg = get_config("llama3.2-3b@smoke")
    state = train_state_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = SyntheticLMDataset(cfg, batch_size=8, seq_len=64, seed=0)
    step = make_train_step(Model(cfg), peak_lr=3e-3, warmup=5,
                           total_steps=60, remat=False)
    losses = []
    for i in range(30):
        state, metrics = step(state, ds.batch(i))
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.25, (first, last)


def test_microbatching_matches_a_single_batch():
    """tests/test_training.py's intent, on its model and data (the
    reference's ``init_params(PRNGKey(1))`` carried across): two
    microbatches of 4 against one batch of 8 of Granite-MoE, the loss
    within rtol 1e-4 (each microbatch routes and averages its own
    load-balance loss, as in the reference); a batch that does not split
    raises."""
    cfg, params, _, _ = _twins("granite-moe-1b-a400m@smoke", key=1)
    state = TrainState(params, adamw_init(params))
    batch = SyntheticLMDataset(cfg, batch_size=8, seq_len=32,
                               seed=1).batch(0)
    model = Model(cfg)
    _, m1 = make_train_step(model, remat=False, microbatches=1)(
        clone_state(state), batch)
    _, m2 = make_train_step(model, remat=False, microbatches=2)(
        clone_state(state), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, microbatches=3)(state, batch)


def test_microbatches_split_the_batch_in_contiguous_pieces():
    """Without experts (no capacity per microbatch) two microbatches give
    the mean of the two halves' losses and gradients exactly as the
    reference forms it: every parameter after the step equal to the
    step from the two halves' summed gradients."""
    cfg = get_config("llama3.2-3b@smoke")
    model = Model(cfg)
    state = train_state_init(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = SyntheticLMDataset(cfg, 4, 16, seed=3).batch(0)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    parts = [_grads(model, state.params, h, remat=False) for h in halves]
    grads = [(a.float() + b.float()) / 2
             for a, b in zip(parts[0][2], parts[1][2])]
    want = clone_state(state)
    adamw_update(want.params, grads, want.opt,
                 lr=cosine_lr(want.opt.step, peak=3e-4, warmup=0,
                              total=10))
    got, m = make_train_step(model, remat=False, microbatches=2, warmup=0,
                             total_steps=10)(state, batch)
    assert float(m["loss"]) == float((parts[0][0] + parts[1][0]) / 2)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["llama3.2-3b@smoke",
                                  "zamba2-2.7b@smoke", "xlstm-350m@smoke",
                                  "whisper-large-v3@smoke"])
def test_remat_matches_no_remat(arch):
    """Checkpointed bodies (one a layer; one a group for Zamba2 and
    xLSTM) recompute on the same route: loss and every gradient within
    rtol 1e-5 of the run without remat."""
    cfg = get_config(arch)
    params = tree_map(lambda t: t.requires_grad_(),
                      train_state_init(cfg, torch.Generator().manual_seed(2),
                                       "cpu").params)
    batch = SyntheticLMDataset(cfg, 4, 32, seed=2).batch(0)
    model = Model(cfg)
    la, _, ga = _grads(model, params, batch, remat=False)
    lb, _, gb = _grads(model, params, batch, remat=True)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
    for (key, _), a, b in zip(tree_items(params), ga, gb):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7, msg=key)


def test_checkpoint_roundtrip(tmp_path):
    """xLSTM's float32 tree, and a bf16 Llama tree, through the port's
    save and restore; ``latest_checkpoint`` finds the newer file;
    a missing key and a wrong shape raise as in the reference."""
    for arch, step in (("xlstm-350m@smoke", 7), ("llama3.2-3b@smoke", 8)):
        cfg = get_config(arch)
        if step == 8:
            cfg = cfg.replace(dtype="bfloat16")
        state = train_state_init(cfg, torch.Generator().manual_seed(3),
                                 "cpu")
        f = save_checkpoint(str(tmp_path), state.params, step=step)
        assert latest_checkpoint(str(tmp_path)) == f
        restored = restore_checkpoint(f, state.params)
        for (key, a), (_, b) in zip(tree_items(state.params),
                                    tree_items(restored)):
            assert b.dtype == a.dtype and b.requires_grad, key
            assert torch.equal(a, b), key
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(f, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(f, {"final_norm": torch.zeros(3)})


def test_float32_checkpoints_cross_both_ways(tmp_path):
    """The port's file has the reference's keys and bytes (``<f4``) and
    the reference restores it; the reference's file restores in the
    port; both exactly."""
    jcfg = jax_get_config("xlstm-350m@smoke")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    cfg = get_config("xlstm-350m@smoke")
    params = llm_params_from_numpy(cfg, _np(jparams))
    mine = save_checkpoint(str(tmp_path / "port"), params, step=5)
    theirs = jax_save(str(tmp_path / "ref"), jparams, step=5)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype == np.dtype("<f4"), k
            assert a[k].tobytes() == b[k].tobytes(), k
    for key, leaf in _jax_items(jax_restore(mine, jparams)):
        np.testing.assert_array_equal(
            np.asarray(leaf), np.asarray(dict(_jax_items(jparams))[key]))
    for (key, a), (_, b) in zip(tree_items(restore_checkpoint(theirs,
                                                              params)),
                                tree_items(params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=key)


def test_bf16_checkpoint_of_the_reference_restores_bit_for_bit(tmp_path):
    """R7: the reference writes bf16 leaves as ``|V2`` and cannot restore
    them; the port reads them into its bf16 tree, bit for bit, and
    writes its own bf16 leaves the same way."""
    jcfg = jax_get_config("llama3.2-3b@smoke").replace(dtype="bfloat16")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(4))
    cfg = get_config("llama3.2-3b@smoke").replace(dtype="bfloat16")
    template = llm_params_from_numpy(cfg, _np(jparams))
    theirs = jax_save(str(tmp_path / "ref"), jparams, step=1)
    with pytest.raises(ValueError, match="cast"):
        jax_restore(theirs, jparams)            # the reference's own fault
    restored = restore_checkpoint(theirs, template)
    want = dict(_jax_items(jparams))
    for key, t in tree_items(restored):
        bits = np.asarray(want[key]).view(
            np.int16 if t.dtype == torch.bfloat16 else np.int32)
        got = t.view(torch.int16 if t.dtype == torch.bfloat16
                     else torch.int32).numpy()
        np.testing.assert_array_equal(got, bits, err_msg=key)
    mine = save_checkpoint(str(tmp_path / "port"), restored, step=1)
    with np.load(mine) as a, np.load(theirs) as b:
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_makes_no_host_read(arch, microbatches, monkeypatch):
    """One step of each smoke architecture, with one and two
    microbatches and remat, under the dispatch mode that fails on a host
    read, a data-dependent shape or host data copied in: the loss, the
    backward and the update, all of which the captured step replays.
    The batch is already on the device."""
    cfg = get_config(arch)
    state = train_state_init(cfg, torch.Generator().manual_seed(5), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLMDataset(cfg, 4, 16, seed=5).batch(0).items()}
    step = make_train_step(Model(cfg), microbatches=microbatches, warmup=0,
                           remat=True)
    with no_host_reads(monkeypatch):
        state, m = step(state, batch)
    assert all(torch.isfinite(v) for v in m.values())
    assert int(state.opt.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_never_stashes_the_rng_state(arch, monkeypatch):
    """The checkpointed bodies (a layer or a group, and each CE chunk)
    draw no random number, so they do not stash the generators' state:
    on the card that reads the CUDA generator's seed and offset
    (``torch.utils.checkpoint.get_device_states``), which a graph
    capture refuses.  With CUDA taken as initialised, a step with remat
    never reaches it, nor the CPU generator's state."""
    import torch.utils.checkpoint as ckpt

    def refuse(*args, **kwargs):
        raise AssertionError("a checkpointed body stashed an RNG state")
    cfg = get_config(arch)
    state = train_state_init(cfg, torch.Generator().manual_seed(5), "cpu")
    batch = SyntheticLMDataset(cfg, 2, 16, seed=5).batch(0)
    step = make_train_step(Model(cfg), warmup=0, remat=True)
    monkeypatch.setattr(torch.cuda, "_initialized", True)
    monkeypatch.setattr(ckpt, "get_device_states", refuse)
    monkeypatch.setattr(torch, "get_rng_state", refuse)
    state, m = step(state, batch)
    assert torch.isfinite(m["loss"]) and int(state.opt.step) == 1


def test_the_launcher_has_no_production_mesh():
    """The reference's ``--production-mesh`` (a 16×16 mesh) needs 256
    ranks: without them the launcher raises ``make_production_mesh``'s
    ``RuntimeError``, naming the world it needs and the fake process
    group the dry-run uses (``test_torch_mesh.py`` builds the mesh under
    that group)."""
    with pytest.raises(RuntimeError, match="need 256 ranks.*fake"):
        launch_train.main(["--production-mesh", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["llama3.2-3b@smoke",
                                  "whisper-large-v3@smoke",
                                  "zamba2-2.7b@smoke"])
def test_training_never_reaches_k7_or_k8(arch, monkeypatch):
    """On the card's routing (``_on_card`` forced, a sliding window set,
    which the card's prefill refuses) the loss and its backward run the
    chunked attention, as the reference trains: K7 and K8 are never
    called, and no ``UnsupportedConfigError`` is raised for the window."""
    cfg = get_config(arch).replace(sliding_window=8)
    monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel without a backward in training")
    monkeypatch.setattr(kernels, "flash_attention", refuse)
    monkeypatch.setattr(kernels, "decode_attention", refuse)
    params = tree_map(lambda t: t.requires_grad_(), train_state_init(
        cfg, torch.Generator().manual_seed(6), "cpu").params)
    loss, _, grads = _grads(Model(cfg), params, _batch(cfg, 2, 16))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
