"""A sharded train step of the port against the JAX package, on the CPU:
four gloo ranks on a (2, 2) ("data", "model") mesh, started once for the
module (``test_torch_mesh_model.start_ranks``).

Two reference steps make a state with non-zero moments; from it one step
of each package, the port's state sharded as the reference's launcher
shards it (parameters by ``param_specs``, moments by
``param_specs(moe_fsdp=True)``): the loss, every gradient leaf and every
parameter after the step, against the reference's jitted unsharded step
(Llama, Zamba2, xLSTM) or its sharded step (Granite, whose
expert-parallel capacity is reckoned per data shard: a subprocess with
four forced host devices and an Auto-axes ``Mesh``, ROADMAP R9).

Tolerance ``rtol=1e-4, atol=1e-5·max|ref|``.  A gradient leaf's atol is
at least twice its float32 rounding spread
(``test_torch_training._rounding_spread``: Zamba2's and xLSTM's
gradients move by up to ~1e-3 of max|g| when the parameters move by one
float32 rounding).  A parameter may then move by what a gradient within
that atol moves AdamW's update, element by element from the reference's
moments (``_adamw_allowance``): where a gradient is near 0 the update
m̂/√v̂ turns fast."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.training import make_train_step as jax_make_train_step
from repro.training import train_state_init as jax_train_state_init

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import Model
from repro_torch.params import llm_params_from_numpy
from repro_torch.training import cosine_lr
from repro_torch.training.optimizer import tree_items, tree_map

from test_torch_mesh_model import (GRANITE, _close, _items, _np, _tree,
                                   finish_ranks, finish_script, start_ranks,
                                   start_script)
from test_torch_training import _grads, _rounding_spread

torch.set_num_threads(1)

TRAIN_KW = dict(peak_lr=3e-3, warmup=1, total_steps=10, remat=True)
TRAIN = ("llama3.2-3b@smoke", "zamba2-2.7b@smoke", "xlstm-350m@smoke",
         GRANITE)
B1, B2, EPS = 0.9, 0.95, 1e-8       # the AdamW of both packages

# the reference's sharded train steps of argv[2]: four forced host devices
# and an Auto-axes mesh; two steps, then the third step's loss, gradients
# and parameters, into the npz of argv[1] (the keys of _reference_train)
REFERENCE_SHARDED_TRAIN = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.data import SyntheticLMDataset
from repro.models.model import Model, param_specs
from repro.training import make_train_step, train_state_init
out, arch, kw = sys.argv[1], sys.argv[2], eval(sys.argv[3])
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = get_config(arch)
model = Model(cfg, mesh)
specs = param_specs(cfg, mesh)
def shard(tree):
    return jax.tree_util.tree_map(
        lambda t, s: jax.device_put(t, NamedSharding(mesh, s)), tree, specs)
state = train_state_init(cfg, jax.random.PRNGKey(0))
state = state._replace(params=shard(state.params), opt=state.opt._replace(
    mu=shard(state.opt.mu), nu=shard(state.opt.nu)))
tstep = jax.jit(make_train_step(model, **kw))
ds = SyntheticLMDataset(cfg, 4, 32, seed=0)
for i in range(2):
    state, _ = tstep(state, {k: jnp.asarray(v)
                             for k, v in ds.batch(i).items()})
res = {}
def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(p.key for p in path)] = np.asarray(
            leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)
flat("p0:", state.params); flat("mu0:", state.opt.mu)
flat("nu0:", state.opt.nu); res["step0"] = np.asarray(state.opt.step)
batch = {k: jnp.asarray(v) for k, v in ds.batch(2).items()}
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p, b: model.loss_fn(p, b, remat=True), has_aux=True))(
    state.params, batch)
res["loss"] = np.asarray(loss); flat("g:", grads)
state, m = tstep(state, batch)
flat("p1:", state.params)
np.savez(out, **res)
"""


def _reference_train(arch):
    """Two unsharded reference steps, then the third's loss, gradients
    and parameters (``REFERENCE_SHARDED_TRAIN``'s keys)."""
    jcfg = jax_get_config(arch)
    model = JaxModel(jcfg)
    state = jax.jit(jax_train_state_init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    tstep = jax.jit(jax_make_train_step(model, **TRAIN_KW))
    ds = SyntheticLMDataset(get_config(arch), 4, 32, seed=0)
    for i in range(2):
        state, _ = tstep(state, {k: jnp.asarray(v)
                                 for k, v in ds.batch(i).items()})
    res = {f"p0:{k}": v for k, v in _items(_np(state.params))}
    res.update({f"mu0:{k}": v for k, v in _items(state.opt.mu)})
    res.update({f"nu0:{k}": v for k, v in _items(state.opt.nu)})
    res["step0"] = np.asarray(state.opt.step)
    batch = {k: jnp.asarray(v) for k, v in ds.batch(2).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, remat=True), has_aux=True))(
        state.params, batch)
    res["loss"] = np.asarray(loss)
    res.update({f"g:{k}": v for k, v in _items(_np(grads))})
    state, _ = tstep(state, batch)
    res.update({f"p1:{k}": v for k, v in _items(_np(state.params))})
    return res


def _train_cases(mesh, train):
    """Each arch's third step on the mesh from the reference's state."""
    from repro_torch.models.model import shard_params
    from repro_torch.models.sharding import full
    from repro_torch.params import adamw_state_from_numpy
    from repro_torch.training import TrainState, make_train_step
    out = {}
    for arch, ref in train.items():
        cfg = get_config(arch)
        params = tree_map(lambda t: t.requires_grad_(), shard_params(
            llm_params_from_numpy(cfg, _tree(ref, "p0:")), cfg, mesh))
        opt = adamw_state_from_numpy(cfg, _tree(ref, "mu0:"),
                                     _tree(ref, "nu0:"), ref["step0"])
        moments = cfg.replace(moe_fsdp=True)
        state = TrainState(params, opt._replace(
            mu=shard_params(opt.mu, moments, mesh),
            nu=shard_params(opt.nu, moments, mesh)))
        model = Model(cfg, mesh)
        batch = SyntheticLMDataset(cfg, 4, 32, seed=0).batch(2)
        loss, _ = model.loss_fn(params, batch, remat=True)
        grads = torch.autograd.grad(loss, [p for _, p in
                                           tree_items(params)])
        state, _ = make_train_step(model, **TRAIN_KW)(state, batch)
        out[arch] = {"loss": float(full(loss)),
                     "grads": [full(g).double().numpy() for g in grads],
                     "params": [full(p).detach().double().numpy()
                                for _, p in tree_items(state.params)],
                     "step": int(state.opt.step)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(port results, reference results): Granite's sharded reference in
    its subprocess beside the unsharded ones here, then four ranks."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    script = start_script(REFERENCE_SHARDED_TRAIN, tmp, GRANITE,
                          repr(TRAIN_KW))
    train = {a: _reference_train(a) for a in TRAIN if a != GRANITE}
    train[GRANITE] = finish_script(script, tmp)
    return finish_ranks(*start_ranks(_train_cases, train, tmp)), train


def _adamw_allowance(mu0, nu0, g, g_atol, scale, step, lr):
    """Per element, how far the parameter's AdamW step moves when its
    gradient moves anywhere within ``g_atol`` (sampled at nine points):
    lr · max |u(g') - u(g)|, u the bias-corrected m̂/(√v̂ + eps) of one
    step from ``mu0``/``nu0`` with the clip ``scale``."""
    t = step + 1

    def u(gg):
        gg = gg * scale
        m = B1 * mu0 + (1 - B1) * gg
        v = B2 * nu0 + (1 - B2) * gg * gg
        return (m / (1 - B1 ** t)) / (np.sqrt(v / (1 - B2 ** t)) + EPS)
    base = u(g)
    dev = np.zeros_like(base)
    for d in np.linspace(-1.0, 1.0, 9):
        dev = np.maximum(dev, np.abs(u(g + d * g_atol) - base))
    return lr * dev


@pytest.mark.parametrize("arch", TRAIN)
def test_a_sharded_train_step_matches_the_reference(ranks, arch):
    got, train = ranks
    ref, mine = train[arch], got[arch]
    _close(mine["loss"], ref["loss"], "loss")
    step = int(ref["step0"])
    assert mine["step"] == step + 1
    cfg = get_config(arch)
    params = tree_map(lambda t: t.requires_grad_(),
                      llm_params_from_numpy(cfg, _tree(ref, "p0:")))
    model, batch = Model(cfg), SyntheticLMDataset(cfg, 4, 32, seed=0).batch(2)
    spread = _rounding_spread(model, params, batch,
                              _grads(model, params, batch)[2])
    keys = [k for k, _ in tree_items(params)]
    gnorm = np.sqrt(sum(float(np.sum(np.square(ref[f"g:{k}"].astype(
        np.float64)))) for k in keys))
    scale = min(1.0, 1.0 / max(gnorm, 1e-9))
    lr = float(cosine_lr(torch.tensor(step), peak=TRAIN_KW["peak_lr"],
                         warmup=TRAIN_KW["warmup"],
                         total=TRAIN_KW["total_steps"]))
    for key, g, sp, p in zip(keys, mine["grads"], spread, mine["params"]):
        w = ref[f"g:{key}"].astype(np.float64)
        g_atol = max(1e-5 * float(np.abs(w).max()), 2 * sp)
        _close(g, w, f"grad {key}", atol=g_atol)
        want = ref[f"p1:{key}"].astype(np.float64)
        allow = _adamw_allowance(ref[f"mu0:{key}"].astype(np.float64),
                                 ref[f"nu0:{key}"].astype(np.float64), w,
                                 g_atol, scale, step, lr)
        bound = 1e-4 * np.abs(want) + 1e-5 * float(np.abs(want).max()) \
            + allow
        over = np.abs(p - want) > bound
        assert not over.any(), (key, int(over.sum()),
                                float(np.abs(p - want)[over].max()))
