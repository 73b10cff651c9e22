"""Partition specs and their DTensor placements: the port's counterpart of
``jax.sharding.PartitionSpec`` / ``NamedSharding`` as the reference's
model code uses them.

A spec (``P``) names, for each dimension of a tensor, the mesh axis that
shards it, a tuple of axes (``("pod", "data")``: pod-major, as JAX splits
it), or None.  ``P`` normalises its entries as JAX does (an empty tuple is
None, a one-name tuple is that name), so a spec tree of the port compares
equal, leaf for leaf, with ``tuple()`` of the reference's.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, or an ``AbstractMesh`` (names and sizes only, for the spec
functions, as the reference's ``jax.sharding.AbstractMesh``).
``placements(spec, mesh)`` gives one DTensor placement per mesh
dimension: ``Shard(d)`` where the spec names that mesh axis at tensor
dimension ``d``, ``Replicate()`` where it names it nowhere.  Two mesh
axes on one tensor dimension become two ``Shard(d)`` in mesh order, which
DTensor splits the outer mesh dimension first: JAX's order when the
spec's tuple lists them in mesh order, the only order accepted here.

``distribute`` places a tensor that every rank holds whole (parameters
drawn from one seed, a zeroed cache) by slicing each rank's piece, with
no communication; ``shard`` is the reference's
``with_sharding_constraint``: a ``redistribute`` to the spec's placements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: one entry per tensor dimension (an axis name, a
    tuple of names, or None); trailing dimensions left out are None."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else (e[0] if len(e) == 1 else e)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices (``mesh_dim_names`` and
    ``shape`` as a ``DeviceMesh`` has them)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order (the reference's
    ``mesh.shape``); {} without a mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension."""
    from torch.distributed.tensor import Replicate, Shard
    axes = tuple(mesh.mesh_dim_names)
    where: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if [a for a in axes if a in names] != list(names):
            raise ValueError(f"spec {spec}: {names} is not in the mesh's "
                             f"axis order {axes}")
        for a in names:
            if a in where:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            where[a] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axes)


def spec_of(placements_: Sequence, mesh, ndim: int) -> P:
    """The spec of DTensor ``placements_`` on ``mesh`` for a tensor of
    ``ndim`` dimensions (``placements``' inverse)."""
    from torch.distributed.tensor import Shard
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements_):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(name)
    return P(*entries)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """The rank's piece of a DTensor; any other value as it is."""
    return t.to_local() if is_dtensor(t) else t


def full(t):
    """The whole of a DTensor on every rank (``full_tensor``); any other
    value as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _local_shape(shape, mesh, pl):
    """(this rank's piece's shape, its offset in the whole): each
    ``Shard(d)`` in mesh order splits what is left of dimension ``d`` as
    ``torch.chunk`` does (DTensor's rule), at the mesh's coordinate,
    which it keeps.  Plain arithmetic: it runs under ``FakeTensorMode``
    too."""
    from torch.distributed.tensor import Shard
    size, off = list(shape), [0] * len(shape)
    for n, c, p in zip(tuple(mesh.shape), mesh.get_coordinate(), pl):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            chunk = -(-size[d] // n)
            lo = min(c * chunk, size[d])
            off[d] += lo
            size[d] = min(chunk, size[d] - lo)
    return tuple(size), tuple(off)


def distribute(t: torch.Tensor, mesh, spec: Sequence):
    """``t``, which every rank holds whole, as a DTensor placed by
    ``spec``: each rank keeps its slice, nothing is sent."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    shape, offset = _local_shape(t.shape, mesh, pl)
    piece = t
    for dim, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[dim]:
            piece = piece.narrow(dim, o, n)
    return DTensor.from_local(piece.contiguous(), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def empty_like_spec(shape, mesh, spec: Sequence, *, dtype, device,
                    fill=0):
    """A DTensor of global ``shape`` placed by ``spec``, each rank's piece
    made on ``device`` and filled with ``fill``."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    local_shape, _ = _local_shape(shape, mesh, pl)
    piece = torch.full(local_shape, fill, dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(piece, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def shard(x, mesh, spec: Sequence):
    """The reference's ``_shard``: ``x`` redistributed to ``spec``'s
    placements (a no-op where it has them, the identity without a
    mesh)."""
    if mesh is None:
        return x
    pl = placements(spec, mesh)
    if is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute(x, mesh, spec)


def replicate(t, mesh):
    """A tensor every rank holds whole, as a replicated DTensor (no
    communication); a DTensor or any value without a mesh as it is."""
    if mesh is None or is_dtensor(t) or not isinstance(t, torch.Tensor):
        return t
    return distribute(t, mesh, P())


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def all_reduce(t: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """The reference's ``lax.psum`` / ``pmax`` over one mesh axis, inside a
    mapped body: a functional collective over that axis's group."""
    import torch.distributed._functional_collectives as fc
    if axis_sizes(mesh)[axis] == 1:
        return t
    return fc.wait_tensor(fc.all_reduce(t, op, mesh.get_group(axis)))


def _placements_of(spec, mesh):
    if spec is None:
        return None
    return placements(spec, mesh) if isinstance(spec, P) else tuple(spec)


def _grad_placements(ins, outs):
    """The placement of each input's gradient: where every output is
    sharded or a partial sum along a mesh dimension, a body that reads a
    replicated input computes part of that input's gradient on each rank
    there, so the gradient is a partial sum (``Partial()``); elsewhere it
    has the input's placement."""
    from torch.distributed.tensor import Partial, Replicate
    outs = [o for o in outs if o is not None]
    if not outs:
        return tuple(ins)
    ndim = len(outs[0])
    split = [all(not isinstance(o[i], Replicate) for o in outs)
             for i in range(ndim)]
    return tuple(None if pl is None else tuple(
        Partial() if split[i] and isinstance(p, Replicate) else p
        for i, p in enumerate(pl)) for pl in ins)


def local_map(fn, mesh, in_specs, out_specs, shapes=None):
    """The reference's ``shard_map``: ``fn`` runs on each rank's pieces.
    Its tensor arguments are redistributed to ``in_specs`` (None: a plain
    value, passed as it is), its results come back as DTensors placed by
    ``out_specs`` (a list for several results).  A spec may also be a
    tuple of placements (``Partial()`` for a sum the caller reduces).
    Under autograd each input's gradient is placed by
    ``_grad_placements``.  A result's global shape is its pieces' times
    the ranks that split it unless ``shapes`` gives it (a shape, or a
    list like ``out_specs``): a dimension that does not split evenly
    needs it."""
    from torch.distributed.tensor.experimental import local_map as _lm
    ins = tuple(_placements_of(s, mesh) for s in in_specs)
    several = isinstance(out_specs, list)
    outs = [_placements_of(s, mesh) for s in out_specs] \
        if several else [_placements_of(out_specs, mesh)]
    mapped = _lm(fn, out_placements=tuple(outs),
                 in_placements=ins,
                 in_grad_placements=_grad_placements(ins, outs),
                 device_mesh=mesh, redistribute_inputs=True)
    if shapes is None:
        return mapped

    def run(*args):
        from torch.distributed.tensor import DTensor
        res = mapped(*args)
        fixed = [DTensor.from_local(
            r.to_local().contiguous(), mesh, r.placements, run_check=False,
            shape=torch.Size(s),
            stride=torch.empty(s, device="meta").stride())
            for r, s in zip(res if several else [res],
                            shapes if several else [shapes])]
        return fixed if several else fixed[0]
    return run


def gathered(t, mesh) -> P:
    """The spec of DTensor ``t`` without its batch axes ("data", "pod"):
    what a mapped body reads of a weight stored sharded over them
    (FSDP), all-gathered first, as the reference's GSPMD gathers it."""
    spec = spec_of(t.placements, mesh, t.ndim)
    return P(*(tuple(a for a in _names(e) if a not in ("data", "pod"))
               for e in spec))


__all__ = ["AbstractMesh", "P", "all_reduce", "axis_rank", "axis_sizes",
           "distribute", "empty_like_spec", "full", "gathered", "is_dtensor",
           "local", "local_map", "placements", "replicate", "shard",
           "spec_of"]
