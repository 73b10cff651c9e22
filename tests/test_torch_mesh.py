"""The port's mesh code against the JAX package's, without devices:
``param_specs`` and ``cache_specs`` leaf for leaf against the reference's
on ``jax.sharding.AbstractMesh`` (the port's own ``AbstractMesh`` beside
it) for every registered architecture, three meshes and the dry-run's four
variants; ``resolve_kv_mode`` on the same grid; ``placements`` and its
inverse; ``make_production_mesh`` without 256 ranks and under the fake
process group (in a subprocess: a process group is started once per
process)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models.model import cache_specs as jax_cache_specs
from repro.models.model import param_specs as jax_param_specs
from repro.models.model import resolve_kv_mode as jax_resolve_kv_mode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import VARIANTS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import (cache_specs, param_specs,
                                      resolve_kv_mode)
from repro_torch.models.sharding import (AbstractMesh, P, placements,
                                         spec_of)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _reference_variants():
    """``repro.launch.dryrun.VARIANTS``, read from its source: importing
    that module sets ``XLA_FLAGS`` to 512 host devices for the process."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "VARIANTS":
            return ast.literal_eval(node.value)
    raise LookupError("VARIANTS")


JAX_VARIANTS = _reference_variants()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


def _cfgs(arch, variant):
    over = VARIANTS[variant]
    return jax_get_config(arch).replace(**over), get_config(arch).replace(
        **over)


def test_the_grid_is_the_references():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert VARIANTS == JAX_VARIANTS


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh, variant):
    jcfg, cfg = _cfgs(arch, variant)
    jm, m = _meshes(mesh)
    want = _flat(jax_param_specs(jcfg, jm))
    got = _flat(param_specs(cfg, m))
    assert got == want
    assert all(isinstance(s, P) for s in _flat_specs(param_specs(cfg, m)))


def _flat_specs(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_specs(v)
        else:
            yield v


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_cache_specs_and_kv_mode_equal_the_references(arch, mesh, variant):
    """At the default batch (every batch axis), at batch 128 (the decode
    shapes') and at batch 1 (long_500k's, which replicates the batch)."""
    jcfg, cfg = _cfgs(arch, variant)
    jm, m = _meshes(mesh)
    assert resolve_kv_mode(cfg, m) == jax_resolve_kv_mode(jcfg, jm)
    for batch in (0, 128, 1):
        want = _flat(jax_cache_specs(jcfg, jm, batch_size=batch))
        assert _flat(cache_specs(cfg, m, batch_size=batch)) == want, batch


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_without_a_mesh_every_spec_is_empty(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert _flat(param_specs(cfg, None)) == _flat(jax_param_specs(jcfg, None))
    assert _flat(cache_specs(cfg, None)) == _flat(jax_cache_specs(jcfg, None))
    assert resolve_kv_mode(cfg, None) == jax_resolve_kv_mode(jcfg, None) \
        == "heads"


def test_a_spec_normalises_as_jax_does():
    from jax.sharding import PartitionSpec as JP
    for entries in ((("data",), None), ((), "model"),
                    (("pod", "data"), None, "model"), ()):
        assert tuple(P(*entries)) == tuple(JP(*entries))


@pytest.mark.parametrize("spec,ndim", [
    (P(None, "data", "model", None), 4),
    (P("model", "data"), 2),
    (P(("pod", "data"), None, "model"), 3),
    (P(None, None), 2),
    (P(), 0),
])
def test_placements_round_trip(spec, ndim):
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh(*MESHES["2x16x16"][::1])
    pl = placements(spec, mesh)
    assert len(pl) == 3
    assert all(isinstance(p, (Shard, Replicate)) for p in pl)
    full = tuple(spec) + (None,) * (ndim - len(spec))
    assert tuple(spec_of(pl, mesh, ndim)) == full


def test_two_axes_on_one_dimension_split_pod_major():
    """``("pod", "data")`` is two ``Shard(0)`` in mesh order; DTensor splits
    the outer mesh dimension first, as JAX splits the first axis named:
    the rank at pod 1, data 3 of a (2, 4, 2) mesh holds rows 7·n/8 ..."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    mesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    pl = placements(P(("pod", "data"), "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(1))
    for pod in range(2):
        for data in range(4):
            shape, off = _compute_local_shape_and_global_offset(
                (64, 8), (2, 4, 2), [pod, data, 1], pl)
            assert shape == (8, 4)
            assert off == ((pod * 4 + data) * 8, 4)
    with pytest.raises(ValueError, match="axis order"):
        placements(P(("data", "pod")), mesh)


def test_the_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="need 256 ranks.*fake"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True)


def test_the_production_mesh_builds_under_the_fake_process_group():
    code = (
        "from repro_torch.launch.mesh import make_production_mesh, "
        "start_fake_world\n"
        "start_fake_world(512, rank=300)\n"
        "m = make_production_mesh(multi_pod=True)\n"
        "print(tuple(m.shape), m.mesh_dim_names, m.device_type, "
        "list(m.get_coordinate()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == \
        "(2, 16, 16) ('pod', 'data', 'model') cpu [1, 2, 12]"


@pytest.mark.parametrize("rows,window", [((6, 5), 0), ((6, 5), 4),
                                         ((4, 4, 3), 0), ((4, 4, 3), 3)])
def test_context_parallel_rows_read_the_keys_up_to_their_own(rows, window):
    """A context-parallel rank's query rows at offset o: ``_attend_seq``
    with ``card=True`` hands K7 the keys ``k[:, :o + Sq]``, whose last
    rows its causal mask aligns with the queries.  On CPU tensors K7's
    wrapper runs its plain version, so each rank's rows must equal those
    rows of the whole sequence's attention on the chunked path."""
    from repro_torch.models.layers import rope_angles
    from repro_torch.models.model import _attend_seq
    cfg = get_config("llama3.2-3b@smoke")
    S, H, K, D = sum(rows), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, S, n, D), generator=gen) for n in (H, K, K))
    rope = rope_angles(torch.arange(S), D, cfg.rope_theta)
    whole = _attend_seq(cfg, q, k, v, rope, causal=True, window=window,
                        card=False)[0]
    o = 0
    for n in rows:
        got = _attend_seq(cfg, q[:, o:o + n], k, v, rope, causal=True,
                          window=window, card=True, q_offset=o)[0]
        torch.testing.assert_close(got, whole[:, o:o + n], rtol=1e-5,
                                   atol=1e-6)
        o += n
