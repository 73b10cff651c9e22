"""Mesh construction: ``src/repro/launch/mesh.py`` on PyTorch.

Functions, not module-level constants: importing this module touches no
process group and no device.

Production target, as the reference's: 256 chips a pod as a (16, 16)
("data", "model") mesh; two pods as (2, 16, 16) ("pod", "data",
"model").  Batch shards over ("pod", "data"); "model" carries tensor and
expert sharding.  The mesh is a ``DeviceMesh`` over the default process
group, which the caller starts (``torch.distributed.init_process_group``
with its address, world size and rank).  The dry-run
(``launch/dryrun.py``) starts a fake process group of that size in one
process (``torch.testing._internal.distributed.fake_pg.FakeStore``,
backend ``"fake"``): no device and no peer is needed to shape the
programs.
"""
from __future__ import annotations

import math
import torch

from repro_torch.device import resolve_device


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device) -> str:
    import torch.distributed as dist
    if device is not None:
        return torch.device(device).type
    if dist.is_initialized() and dist.get_backend() == "fake":
        return "cpu"
    return resolve_device(None).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the first 256 / 512 ranks of the
    default process group; on the card unless ``device`` says otherwise
    (the fake process group's mesh lies on the CPU).  Raises
    ``RuntimeError`` when the world is smaller."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, world = math.prod(shape), _world()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks, have {world}: start the default process "
            f"group with world_size={n} first; the dry-run starts the fake "
            f"one (backend 'fake', store "
            f"torch.testing._internal.distributed.fake_pg.FakeStore(), "
            f"world_size={n})")
    if world > n:
        raise RuntimeError(f"the mesh takes {n} ranks, the world has "
                           f"{world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device=None):
    """A (data, model) mesh over the ranks there are: ``model_parallel``
    (at most the world) ranks along "model", the rest along "data"; on
    the card unless ``device="cpu"``.  Its axes take ``_shard``'s
    constraints as they are (the port has no Explicit / Auto axis kinds:
    ROADMAP R9)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _world()
    m = max(1, min(model_parallel, world))
    if world % m:
        raise RuntimeError(f"{world} ranks do not split into model "
                           f"parallel {m}")
    dev = torch.device("cpu") if device is not None and \
        torch.device(device).type == "cpu" else resolve_device(device)
    return init_device_mesh(dev.type, (world // m, m),
                            mesh_dim_names=("data", "model"))


def start_fake_world(world: int, rank: int = 0) -> None:
    """Start the fake process group of ``world`` ranks in this process, as
    rank ``rank`` (the dry-run's; collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


__all__ = ["make_local_mesh", "make_production_mesh", "start_fake_world"]
