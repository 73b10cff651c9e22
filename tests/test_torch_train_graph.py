"""The train step as a captured CUDA graph (``training.GraphedTrainStep``,
the counterpart of the reference's ``jax.jit(make_train_step(...))``),
checked on the CPU with the CUDA calls replaced by plain ones
(``test_torch_capture.py``'s ``_fake_cuda``): a warm-up runs the step, the
recording returns the step's outputs and leaves the state as it was (on
the card recording launches nothing), and a replay reruns the recorded
step and copies its results into the recorded output tensors, as a
replay rewrites them.

* graphed steps equal eager ``make_train_step`` steps bit for bit over
  five steps, each with its own batch, and each step's metrics stay as
  they were after later steps (Llama smoke; Granite smoke with two
  microbatches);
* three graphed steps against the reference's jitted step, from a state
  carried by ``params.adamw_state_from_numpy``, within
  ``test_torch_training.py``'s tolerances;
* ``state.opt.step`` counts every call, warm-ups included;
* another shape, key set or dtype, a batch off the step's device and
  another state's tensors raise ``ValueError``; the CPU and a mesh raise
  ``CaptureError``;
* a failed warm-up, capture or replay raises ``CaptureError`` naming the
  train step, and nothing reruns eagerly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import Model as JaxModel
from repro.training import make_train_step as jax_make_train_step
from repro.training import train_state_init as jax_train_state_init

from repro_torch import cuda_graphs
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.errors import CaptureError
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.params import adamw_state_from_numpy, llm_params_from_numpy
from repro_torch.training import (GraphedTrainStep, TrainState,
                                  make_train_step, train_state_init)
from repro_torch.training import graphed as graphed_mod
from repro_torch.training.optimizer import tree_items, tree_map

from test_torch_capture import _FakeGraph, _fake_cuda
from test_torch_training import _close, _jax_items, _np, _twins, clone_state

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

STEPS = 5
WARMUPS = cuda_graphs.WARMUP_RUNS


def _record_without_running(state):
    """A fake recording: the step runs (its outputs are the recorded
    tensors) and the state is put back as it was, since recording on the
    card launches nothing."""
    leaves = graphed_mod._state_leaves(state)

    def record(fn, device):
        saved = [t.detach().clone() for t in leaves]
        out = fn()
        with torch.no_grad():
            for t, s in zip(leaves, saved):
                t.copy_(s)
        return _FakeGraph(fn, out), out
    return record


def _graphed(step, state, monkeypatch, record=None):
    monkeypatch.setattr(graphed_mod, "_capturable", lambda device: True)
    _fake_cuda(monkeypatch, record or _record_without_running(state))
    return GraphedTrainStep(step, "cpu")


def _batch(ds, i):
    return {k: torch.as_tensor(v) for k, v in ds.batch(i).items()}


def _state_equal(a, b):
    for name, x, y in (("params", a.params, b.params),
                       ("mu", a.opt.mu, b.opt.mu),
                       ("nu", a.opt.nu, b.opt.nu)):
        for (key, u), (_, v) in zip(tree_items(x), tree_items(y)):
            assert torch.equal(u, v), f"{name} {key}"
    assert torch.equal(a.opt.step, b.opt.step)


@pytest.mark.parametrize("arch,microbatches",
                         [("llama3.2-3b@smoke", 1),
                          ("granite-moe-1b-a400m@smoke", 2)])
def test_graphed_steps_equal_eager_steps_bit_for_bit(arch, microbatches,
                                                     monkeypatch):
    """Five steps from the same state, each with its own batch: two
    warm-ups, the capture's step and two replays, every parameter,
    moment, ``step`` and metric equal to the eager step's; the metrics
    of every earlier step unchanged by the later replays."""
    cfg = get_config(arch)
    model = Model(cfg)
    kw = dict(peak_lr=3e-3, warmup=2, total_steps=10,
              microbatches=microbatches, remat=True)
    state = train_state_init(cfg, torch.Generator().manual_seed(1), "cpu")
    want_state = clone_state(state)
    eager = make_train_step(model, **kw)
    step = _graphed(make_train_step(model, **kw), state, monkeypatch)
    ds = SyntheticLMDataset(cfg, 4, 16, seed=1)
    replays, kept = _FakeGraph.replays, []
    for i in range(STEPS):
        batch = _batch(ds, i)
        out, got = step(state, batch)
        want_state, want = eager(want_state, batch)
        assert out is state
        assert int(state.opt.step) == i + 1 == step.calls
        assert (step.graph is None) == (i < WARMUPS)
        assert sorted(got) == sorted(want) == ["aux", "ce", "grad_norm",
                                               "loss", "lr"]
        kept.append((got, {k: v.clone() for k, v in want.items()}))
        for g, w in kept:
            for k in w:
                assert torch.equal(g[k], w[k]), (i, k)
        _state_equal(state, want_state)
    assert _FakeGraph.replays - replays == STEPS - WARMUPS
    assert step.capture_ms is not None and step.warmup_ms > 0


def test_graphed_steps_match_the_reference_jitted_step(monkeypatch):
    """Two reference steps make a state with non-zero moments (AdamW's
    first step is sign-like); carried into the port, three graphed steps
    (two warm-ups and the capture's) against three steps of the
    reference's ``jax.jit(make_train_step)``: the metrics of each step,
    then every parameter, ``mu``, ``nu`` and ``step``, within
    ``rtol=1e-4, atol=1e-5·max|ref|``."""
    arch = "llama3.2-3b@smoke"
    kw = dict(peak_lr=3e-3, warmup=1, total_steps=10, remat=True)
    cfg, _, jcfg, _ = _twins(arch)
    jstate = jax.jit(jax_train_state_init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(JaxModel(jcfg), **kw))
    ds = SyntheticLMDataset(cfg, 4, 32, seed=0)
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in ds.batch(i).items()})
    state = TrainState(
        tree_map(lambda t: t.requires_grad_(),
                 llm_params_from_numpy(cfg, _np(jstate.params))),
        adamw_state_from_numpy(cfg, _np(jstate.opt.mu), _np(jstate.opt.nu),
                               jstate.opt.step))
    step = _graphed(make_train_step(Model(cfg), **kw), state, monkeypatch)
    for i in range(2, 5):
        batch = ds.batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        for k in m:
            _close(m[k], jm[k], f"step {i} {k}")
    assert step.graph is not None
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    for name, got, want in (("params", state.params, jstate.params),
                            ("mu", state.opt.mu, jstate.opt.mu),
                            ("nu", state.opt.nu, jstate.opt.nu)):
        for (key, w), (_, g) in zip(_jax_items(_np(want)), tree_items(got)):
            _close(g, w, f"{name} {key}")


@pytest.fixture
def smoke():
    cfg = get_config("llama3.2-3b@smoke")
    state = train_state_init(cfg, torch.Generator().manual_seed(2), "cpu")
    return cfg, Model(cfg), state, SyntheticLMDataset(cfg, 4, 16, seed=2)


@pytest.mark.parametrize("change", ["shape", "keys", "dtype"])
def test_one_graph_holds_one_batch_shape(change, smoke, monkeypatch):
    """A batch with another shape, another key set or another dtype than
    the first call's raises ``ValueError`` before anything runs, at a
    warm-up and after the capture alike."""
    cfg, model, state, ds = smoke
    step = _graphed(make_train_step(model), state, monkeypatch)
    n = 0
    for i in range(WARMUPS + 3):
        batch = _batch(ds, i)
        if i in (1, WARMUPS + 2):
            if change == "shape":
                batch = {"tokens": batch["tokens"][:, :8]}
            elif change == "keys":
                batch["frames"] = torch.zeros(4, 2, 3)
            else:
                batch = {"tokens": batch["tokens"].long()}
            with pytest.raises(ValueError, match="one graph holds one "
                               "shape"):
                step(state, batch)
            assert int(state.opt.step) == n
        else:
            state, _ = step(state, batch)
            n += 1
    assert step.graph is not None
    assert int(state.opt.step) == step.calls == n == WARMUPS + 1


@pytest.mark.parametrize("where", ["numpy", "meta"])
def test_a_batch_off_the_device_raises(where, smoke, monkeypatch):
    """The graph reads its batch from device buffers: a batch of host
    arrays, or of tensors on another device, raises ``ValueError``."""
    cfg, model, state, ds = smoke
    step = _graphed(make_train_step(model), state, monkeypatch)
    batch = ds.batch(0)
    if where == "meta":
        batch = {k: torch.empty(v.shape, device="meta")
                 for k, v in batch.items()}
    with pytest.raises(ValueError, match="copy it there first"):
        step(state, batch)
    assert int(state.opt.step) == 0


def test_another_states_tensors_raise(smoke, monkeypatch):
    """The graph updates the first call's state in place: a call with a
    copy of it raises ``ValueError``; the state it returned goes on."""
    cfg, model, state, ds = smoke
    step = _graphed(make_train_step(model), state, monkeypatch)
    state, _ = step(state, _batch(ds, 0))
    with pytest.raises(ValueError, match="in place"):
        step(clone_state(state), _batch(ds, 1))
    state, _ = step(TrainState(state.params, state.opt), _batch(ds, 1))
    assert int(state.opt.step) == 2


def test_the_cpu_and_a_mesh_raise_capture_error(smoke, monkeypatch):
    """Without the fake: a CPU device raises ``CaptureError`` (the step
    runs eagerly there), and so does a model on a mesh."""
    cfg, model, state, ds = smoke
    with pytest.raises(CaptureError, match="on the card only"):
        GraphedTrainStep(make_train_step(model), "cpu")
    monkeypatch.setattr(graphed_mod, "_capturable", lambda device: True)
    step = make_train_step(model)
    monkeypatch.setattr(model, "mesh", object())
    with pytest.raises(CaptureError, match="mesh runs eagerly"):
        GraphedTrainStep(step, "cpu")


@pytest.mark.parametrize("stage", ["warm-up", "capture", "replay"])
def test_a_failure_raises_capture_error_and_nothing_reruns(stage, smoke,
                                                           monkeypatch):
    """A warm-up, a recording or a replay that fails raises
    ``CaptureError`` naming the train step (arch, B x S, microbatches)
    and the layer that was running; the step is not run eagerly in its
    place, and a later call after a failed capture raises again without
    running anything."""
    cfg, model, state, ds = smoke
    plain = make_train_step(model)
    ran = []

    def step_fn(state, batch):
        ran.append(int(state.opt.step))
        if stage == "warm-up" and len(ran) == 2:
            e = RuntimeError("operation not permitted")
            e.add_note("layer 1")
            raise e
        return plain(state, batch)
    step_fn.model, step_fn.microbatches = model, 1

    def broken_record(fn, device):
        e = RuntimeError("operation not permitted when stream is capturing")
        e.add_note("layer 1")
        raise e

    class Lost(_FakeGraph):
        def replay(self):
            raise RuntimeError("device lost")

    def lost_record(fn, device):
        _, out = _record_without_running(state)(fn, device)
        return Lost(), out

    record = {"capture": broken_record, "replay": lost_record}.get(stage)
    step = _graphed(step_fn, state, monkeypatch, record)
    fails = {"warm-up": 1, "capture": WARMUPS, "replay": WARMUPS}[stage]
    for i in range(fails):
        state, _ = step(state, _batch(ds, i))
    n = len(ran)
    what = (rf"{stage} of the train step \({cfg.name}, B 4 x S 16, "
            rf"microbatches 1\) failed")
    with pytest.raises(CaptureError, match=what + (
            r" \(layer 1\)" if stage != "replay" else "")):
        step(state, _batch(ds, fails))
    # the recording (and its stand-in here) ran the step; nothing ran
    # eagerly after the failure
    assert len(ran) == n + {"warm-up": 1, "capture": 0, "replay": 1}[stage]
    assert int(state.opt.step) == fails
    if stage == "capture":
        with pytest.raises(CaptureError, match="captured earlier"):
            step(state, _batch(ds, fails + 1))
        assert len(ran) == n and int(state.opt.step) == fails


def test_the_launcher_captures_on_the_card_only():
    """``launch.train`` on the CPU runs the plain step and carries no
    capture times; on the card it wraps the step in
    ``GraphedTrainStep`` (``chip_smoke.py``'s ``phase train-graph``)."""
    run = launch_train.main(["--arch", "llama3.2-3b@smoke", "--steps", "1",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu"])
    assert not isinstance(run.step_fn, GraphedTrainStep)
    assert run.capture_ms is None and run.warmup_ms is None
    assert run.steps[0]["reserved_bytes"] is None
