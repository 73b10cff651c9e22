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
  as ``quantize_graph`` but without calibrating.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np

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


__all__ = ["apply_params", "quantized_model_from_qparams"]
