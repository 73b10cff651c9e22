"""Flat-npz checkpointing of parameter trees: ``src/repro/training/
checkpoint.py``'s files, keys and checks on PyTorch.

Leaves are flattened to ``path/to/leaf`` keys (``blocks/wq``) in sorted
key order and written by ``np.savez`` to ``ckpt_{step:08d}.npz`` through
a ``.tmp`` file renamed into place.  A float32 or integer leaf is written
as the reference writes it (``<f4``, ``<i4``), byte for byte.  A bfloat16
leaf is written as the reference's ``ml_dtypes`` arrays come out of
``np.savez``, ``|V2`` with the same two bytes, through
``tensor.view(torch.int16)`` (no ``ml_dtypes`` needed).  Restore reads a
``|V2`` array into a bfloat16 template by reinterpreting its bytes, so
the port restores the reference's bf16 files and its own, which the
reference cannot do (ROADMAP R7: its ``astype(bfloat16)`` of a ``|V2``
array raises).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .optimizer import Tree, tree_items

_BF16_BYTES = np.dtype("V2")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BYTES)
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise ValueError(f"raw {arr.dtype} bytes restore only into a "
                             f"bfloat16 leaf, not {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in tree_items(tree)}


def save_checkpoint(path: str, tree: Tree, step: int) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    tmp = fname + ".tmp"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, fname)
    return fname


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    files = sorted(f for f in os.listdir(path)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(path, files[-1]) if files else None


def restore_checkpoint(fname: str, template: Tree) -> Tree:
    """A tree like ``template`` (dtypes, devices, ``requires_grad``) with
    the values of ``fname``.  Raises ``KeyError`` on a key the file lacks,
    ``ValueError`` on a shape that differs."""
    with np.load(fname) as data:
        flat = {}
        for key, leaf in tree_items(template):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            flat[key] = _to_tensor(arr, leaf).requires_grad_(
                leaf.requires_grad)

    def rebuild(tree, prefix=""):
        return {k: rebuild(v, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"] for k, v in tree.items()}
    return rebuild(template)


__all__ = ["latest_checkpoint", "restore_checkpoint", "save_checkpoint"]
