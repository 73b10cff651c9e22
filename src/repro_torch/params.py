"""Parameters carried into the port from outside: numpy arrays and Python
scalars in, the port's graphs out.

The port builds its own weights (``cnn_ops._weight``, seeded from
``hash(name)``, which Python salts per process), so a comparison with
another implementation of the same network — the JAX package, a trained
checkpoint — hands the values over explicitly:

* ``apply_params`` overwrites per-op attrs (``weight``, ``weight_q``,
  ``mult``, zero points, ...) on a float or int8 graph and rebuilds each
  touched op's semantics and ``SliceSpec``;
* ``quantized_model_from_qparams`` builds the int8 rewrite of a float graph
  from given per-tensor (scale, zero_point) pairs, through the same rewrite
  as ``quantize_graph`` but without calibrating;
* ``llm_params_from_numpy`` turns an LLM parameter tree of numpy arrays
  (the reference's ``init_params`` pytree, or a checkpoint) into the
  port's ``models.init_params`` layout, checked name by name;
  ``adamw_state_from_numpy`` the optimizer's moments and step beside
  them.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.partition import PEX_ATTR
from repro_torch.graphs.cnn_ops import op_semantics, pex_spec
from repro_torch.graphs.quantize import (QParams, QuantizedModel,
                                         build_quantized)


def apply_params(graph: Graph,
                 params: Mapping[str, Mapping[str, Any]]) -> Graph:
    """Overwrite ``{op_name: {attr: value}}`` on ``graph`` in place and
    rebuild each named op's ``fn`` and ``SliceSpec``; returns ``graph``.
    Weight arrays must keep their shape (the graph's tensors do not
    change)."""
    for name, values in params.items():
        op = graph.op_by_name(name)
        for key, value in values.items():
            if key in ("weight", "weight_q"):
                value = np.asarray(value)
                old = op.attrs.get(key)
                if old is not None and np.shape(old) != value.shape:
                    raise ValueError(
                        f"{name}.{key}: shape {value.shape} != "
                        f"{np.shape(old)}")
                op.attrs["weight_bytes"] = value.nbytes
            op.attrs[key] = value
        out_shape = graph.tensors[op.output].shape
        in_shape = graph.tensors[op.inputs[0]].shape if op.inputs else ()
        if len(out_shape) == 3:
            spec = pex_spec(op.kind, tuple(out_shape),
                            in_shape[-1] if in_shape else 1,
                            op.attrs.get("k", 1), op.attrs.get("stride", 1))
            if spec is not None:
                op.attrs[PEX_ATTR] = spec
        op.fn = op_semantics(op.kind, op.attrs)
    return graph


def quantized_model_from_qparams(
        float_graph: Graph,
        qparams: Mapping[str, Tuple[float, int]]) -> QuantizedModel:
    """The port's ``QuantizedModel`` of ``float_graph`` at the given
    ``{tensor: (scale, zero_point)}``, without calibration."""
    return build_quantized(float_graph, {
        n: QParams(float(s), int(zp)) for n, (s, zp) in qparams.items()})


def llm_params_from_numpy(cfg, tree: Mapping[str, Any],
                          device="cpu") -> dict:
    """The port's LLM parameters from a tree of numpy arrays with the
    reference's names and layout: every tensor of ``models.init_params``
    for ``cfg`` (stacked ``[L, ...]`` blocks, as the reference stacks
    them), cast to its dtype (bfloat16 arrays arrive through float32,
    exactly) and put on ``device``.  Raises on a missing or extra name or
    a shape that differs."""
    return _llm_tree_from_numpy(cfg, tree, device)


def adamw_state_from_numpy(cfg, mu: Mapping[str, Any],
                           nu: Mapping[str, Any], step, device="cpu"):
    """The port's ``training.AdamWState`` from the reference's: the float32
    moment trees ``mu``/``nu`` of numpy arrays in the parameters' layout
    (checked as ``llm_params_from_numpy`` checks it) and the int32
    ``step``, all on ``device``."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        mu=_llm_tree_from_numpy(cfg, mu, device, torch.float32),
        nu=_llm_tree_from_numpy(cfg, nu, device, torch.float32))


def _llm_tree_from_numpy(cfg, tree, device, dtype=None) -> dict:
    """``tree`` checked against ``models.init_params(cfg)``'s names and
    shapes, each leaf as a tensor of the parameter's dtype (or
    ``dtype``) on ``device``."""
    from repro_torch.models.model import init_params
    want = init_params(cfg, device="meta")

    def convert(spec, node, path):
        if isinstance(spec, dict):
            got = sorted(node) if isinstance(node, Mapping) else type(node)
            if got != sorted(spec):
                raise ValueError(f"{path or 'params'}: names {got} != "
                                 f"{sorted(spec)}")
            return {k: convert(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        arr = np.asarray(node)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"{tuple(spec.shape)}")
        dt = dtype or spec.dtype
        t = torch.from_numpy(np.array(
            arr, dtype=np.float32 if dt == torch.bfloat16 else None))
        return t.to(device=device, dtype=dt)

    return convert(want, tree, "")


__all__ = ["adamw_state_from_numpy", "apply_params", "llm_params_from_numpy",
           "quantized_model_from_qparams"]
