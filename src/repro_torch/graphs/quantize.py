"""Post-training int8 quantization of CNN graphs.

``quantize_graph`` takes the float graph the builders produce, runs a
calibration batch through its f32 semantics on the build device to observe
per-tensor activation ranges, and rewrites the graph with

* int8 tensors (1 byte per element — a 4x cut of every activation the
  planner, Pex cost model and arena executor account for), and
* quantized operator semantics (``graphs/cnn_ops.py``: ``qconv`` /
  ``qdwconv`` / ``qmaxpool`` / ``qadd`` / ``qmul`` / ``qavgpool`` /
  ``qfc`` / ``qconcat``) with per-tensor (scale, zero-point)
  requantization, exact integer accumulation and round-half-even.  A
  conv's clamp activation (``act``) becomes its int8 pair ``lo, hi``
  (``int8_clamp``), as TFLite's ``activation_min/max``.  A table
  activation (h-swish, h-sigmoid) becomes a 256-entry int8 table
  (``activation_table``): the conv requantizes to the params of its
  output *before* the activation, whose range calibration records too
  (under ``pre_activation(name)``), and maps that through the table to
  the output's params.

Topology, tensor names and operator names are preserved, so any schedule
found for the float graph maps 1:1, and the scheduling/partition machinery
runs unchanged on the quantized graph — just over 4x smaller byte sizes.
``QParams``, ``activation_qparams``, ``weight_qparams`` and
``int8_scheduling_graph`` are numpy, as in the reference, but for
``QParams.quantize``, the client edge's input quantize: it runs one pass
of a host kernel (``kernels/host_quant``), bit-identical to the
reference's numpy expression.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.partition import PEX_ATTR
from repro_torch.device import resolve_device
from repro_torch.kernels.host_quant import quantize_int8

from .cnn_ops import (INT8_MAX, INT8_MIN, TABLE_ACTIVATIONS, activate,
                      op_semantics, pex_spec)


@dataclasses.dataclass(frozen=True)
class QParams:
    """Per-tensor affine quantization: real = scale * (q - zero_point)."""

    scale: float
    zero_point: int

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """``clip(round(x / scale) + zero_point)`` in float32, as int8."""
        return quantize_int8(x, self.scale, self.zero_point)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        return ((np.asarray(q, np.float32) - self.zero_point)
                * np.float32(self.scale))


def activation_qparams(lo: float, hi: float) -> QParams:
    """Asymmetric int8 params for an observed [lo, hi] range.  The range is
    widened to include 0 (standard practice: zero padding / relu zero must
    be exactly representable, which is what lets SAME padding and the relu
    clamp use the zero-point directly)."""
    lo, hi = min(0.0, float(lo)), max(0.0, float(hi))
    scale = (hi - lo) / (INT8_MAX - INT8_MIN)
    if scale == 0.0:
        scale = 1.0    # degenerate all-zero tensor
    zp = int(round(INT8_MIN - lo / scale))
    return QParams(scale, max(INT8_MIN, min(INT8_MAX, zp)))


def int8_clamp(act: str, out: QParams) -> Tuple[int, int]:
    """The int8 ``(lo, hi)`` a conv ending in ``act`` clamps its
    requantized output to, at the output's params: ReLU ``[zp, 127]``,
    ReLU6 ``[zp, min(127, zp + round(6 / scale))]`` (``round`` half to
    even), none ``[-128, 127]``.

    A calibrated ReLU6 range is ``[0, m]`` with ``0 < m <= 6``, so its
    ceiling is the grid's top.  ``hi`` is kept for where it is not: a
    ReLU6 tensor that calibrated all zero gets scale 1.0 and ``hi`` = zp +
    6, and params set other than by calibration may give a range wider
    than 6; there the ceiling must still be real 6.0, as TFLite's
    ``activation_max`` keeps it."""
    zp = out.zero_point
    if act == "relu":
        return zp, INT8_MAX
    if act == "relu6":
        return zp, min(INT8_MAX, zp + int(round(6.0 / out.scale)))
    if act == "none":
        return INT8_MIN, INT8_MAX
    raise ValueError(f"no int8 clamp for activation {act!r}")


def pre_activation(tensor: str) -> str:
    """The key under which calibration keeps the range, and quantization
    the params, of a table-activated conv's output before its activation
    (a value the program never stores)."""
    return f"{tensor}:pre"


def activation_table(act: str, pre: QParams, out: QParams) -> np.ndarray:
    """The 256 int8 values a table activation maps a requantized
    pre-activation ``q`` (index ``q + 128``) to: element-wise in float32,
    ``x = s_pre * (q - zp_pre)``, ``f(x)`` by the float pass's own
    ``activate``, then ``clip(round(f(x) / s_out) + zp_out, -128, 127)``
    (half to even)."""
    if act not in TABLE_ACTIVATIONS:
        raise ValueError(f"no int8 table for activation {act!r}")
    q = torch.arange(INT8_MIN, INT8_MAX + 1, dtype=torch.float32)
    x = torch.tensor(np.float32(pre.scale)) * (q - pre.zero_point)
    y = activate(x, act) / torch.tensor(np.float32(out.scale))
    y = torch.round(y) + out.zero_point
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8).numpy()


def weight_qparams(w: np.ndarray) -> Tuple[np.ndarray, float]:
    """Symmetric per-tensor weight quantization: (w_q int8, scale)."""
    scale = float(max(np.abs(w).max(), 1e-8)) / INT8_MAX
    wq = np.clip(np.round(w / scale), -INT8_MAX, INT8_MAX).astype(np.int8)
    return wq, scale


def calibrate(graph: Graph, batches: Sequence[Dict[str, np.ndarray]],
              device: Union[str, torch.device] = "cpu"
              ) -> Dict[str, Tuple[float, float]]:
    """Observed [min, max] per tensor over an eager run of the float graph
    on each calibration batch, on ``device``; a conv ending in a table
    activation also has its output's range before the activation, under
    ``pre_activation(output)``."""
    ranges: Dict[str, Tuple[float, float]] = {}

    def track(name: str, value: torch.Tensor) -> None:
        lo, hi = float(value.min()), float(value.max())
        if name in ranges:
            plo, phi = ranges[name]
            lo, hi = min(lo, plo), max(hi, phi)
        ranges[name] = (lo, hi)

    for inputs in batches:
        bufs: Dict[str, Any] = {}
        for name, value in inputs.items():
            bufs[name] = torch.as_tensor(np.asarray(value, np.float32),
                                         device=device)
            track(name, bufs[name])
        for op in graph.default_schedule():
            if op.fn is None:
                raise ValueError(
                    f"cannot calibrate: operator {op.name!r} has no "
                    f"semantics")
            args = [bufs[i] for i in op.inputs]
            act = op.attrs.get("act")
            if act in TABLE_ACTIVATIONS:
                # the same conv linear, then the activation on its output:
                # what op.fn computes, with the value in between kept
                pre = op_semantics(op.kind, {**op.attrs, "act": "none"})(
                    *args)
                track(pre_activation(op.output), pre)
                out = activate(pre, act)
            else:
                out = op.fn(*args)
            bufs[op.output] = out
            track(op.output, out)
    return ranges


@dataclasses.dataclass
class QuantizedModel:
    """The int8 rewrite of a float graph plus everything needed to use it:
    per-tensor ``QParams`` (quantize inputs / dequantize outputs) and the
    original float graph for reference comparisons."""

    graph: Graph
    qparams: Dict[str, QParams]
    float_graph: Graph

    def quantize_inputs(self, inputs: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        return {n: self.qparams[n].quantize(v) for n, v in inputs.items()}

    def dequantize_outputs(self, outputs: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
        return {n: self.qparams[n].dequantize(v) for n, v in outputs.items()}


def _int8_tensors(old: Graph, new: Graph) -> None:
    for name, t in old.tensors.items():
        new.add_tensor(name, t.elements, t.shape, dtype="int8")


def quantize_graph(graph: Graph,
                   calibration: Union[None, Dict[str, np.ndarray],
                                      Sequence[Dict[str, np.ndarray]]] = None,
                   *, device=None) -> QuantizedModel:
    """Post-training quantization: calibrate activation ranges on the float
    graph (on ``device``; None = the card), then rebuild it with int8
    tensors and quantized semantics.

    ``calibration``: one input dict, a sequence of them, or None for a
    deterministic synthetic batch (``graphs.random_input``).
    """
    dev = resolve_device(device)
    if calibration is None:
        from . import random_input
        batches: List[Dict[str, np.ndarray]] = [random_input(graph)]
    elif isinstance(calibration, dict):
        batches = [calibration]
    else:
        batches = list(calibration)
    ranges = calibrate(graph, batches, dev)
    return build_quantized(graph, {n: activation_qparams(*ranges[n])
                                   for n in ranges})


def build_quantized(graph: Graph, qparams: Dict[str, QParams]
                    ) -> QuantizedModel:
    """The int8 rewrite of ``graph`` at the given activation qparams (the
    step of ``quantize_graph`` after calibration)."""
    qp = dict(qparams)
    # pass-through kinds reuse the input's params (max/avg pooling are
    # order/mean-preserving in the quantized domain)
    for op in graph.default_schedule():
        if op.kind in ("maxpool", "avgpool"):
            qp[op.output] = qp[op.inputs[0]]
    new = Graph()
    _int8_tensors(graph, new)
    for op in graph.operators:
        _quantize_op(graph, new, op, qp)
    new.set_outputs(graph.outputs)
    return QuantizedModel(new, qp, graph)


def int8_scheduling_graph(graph: Graph) -> Graph:
    """The int8 rewrite's *memory model* only: tensors shrink to 1 byte per
    element, operators keep their kinds/attrs (weights dropped,
    ``weight_bytes`` divided by the source element width) but carry no
    semantics.  The full ``quantize_graph`` produces identical sizes, so
    peaks/plans computed here are exactly the quantized model's."""
    new = Graph()
    _int8_tensors(graph, new)
    for op in graph.operators:
        attrs = {k: v for k, v in op.attrs.items() if k != "weight"}
        if "weight_bytes" in attrs:
            attrs["weight_bytes"] //= graph.itemsize(op.output)
        new.add_operator(op.name, list(op.inputs), op.output, kind=op.kind,
                         fn=None, **attrs)
    new.set_outputs(graph.outputs)
    return new


def _quantize_op(old: Graph, new: Graph, op, qp: Dict[str, QParams]) -> None:
    """Emit the int8 counterpart of ``op`` onto ``new``."""
    kind = "q" + op.kind
    ins, out = list(op.inputs), op.output
    out_shape = old.tensors[out].shape
    attrs: Dict[str, Any] = {}

    if op.kind in ("conv", "dwconv"):
        wq, sw = weight_qparams(op.attrs["weight"])
        s_in, zp_in = qp[ins[0]].scale, qp[ins[0]].zero_point
        s_out, zp_out = qp[out].scale, qp[out].zero_point
        act = op.attrs.get("act", "relu")
        attrs = dict(weight_q=wq, weight_bytes=wq.nbytes, k=op.attrs["k"],
                     stride=op.attrs["stride"], zp_in=zp_in, act=act)
        if act in TABLE_ACTIVATIONS:
            # requantize to the pre-activation's params over the whole
            # grid, then the table to the output's
            pre = qp[pre_activation(out)]
            attrs.update(mult=s_in * sw / pre.scale, zp_out=pre.zero_point,
                         lo=INT8_MIN, hi=INT8_MAX,
                         table=activation_table(act, pre, qp[out]))
        else:
            lo, hi = int8_clamp(act, qp[out])
            attrs.update(mult=s_in * sw / s_out, zp_out=zp_out, lo=lo, hi=hi)
    elif op.kind == "maxpool":
        attrs = dict(k=op.attrs["k"], stride=op.attrs["stride"])
    elif op.kind == "avgpool":
        pass
    elif op.kind == "add":
        s_out, zp_out = qp[out].scale, qp[out].zero_point
        attrs = dict(mult_a=qp[ins[0]].scale / s_out,
                     mult_b=qp[ins[1]].scale / s_out,
                     zp_a=qp[ins[0]].zero_point, zp_b=qp[ins[1]].zero_point,
                     zp_out=zp_out)
    elif op.kind == "mul":
        x, g = qp[ins[0]], qp[ins[1]]
        attrs = dict(mult=x.scale * g.scale / qp[out].scale,
                     zp_x=x.zero_point, zp_g=g.zero_point,
                     zp_out=qp[out].zero_point)
    elif op.kind == "concat":
        s_out, zp_out = qp[out].scale, qp[out].zero_point
        attrs = dict(mults=tuple(qp[i].scale / s_out for i in ins),
                     zps=tuple(qp[i].zero_point for i in ins), zp_out=zp_out)
    elif op.kind == "fc":
        wq, sw = weight_qparams(op.attrs["weight"])
        s_in, zp_in = qp[ins[0]].scale, qp[ins[0]].zero_point
        s_out, zp_out = qp[out].scale, qp[out].zero_point
        attrs = dict(weight_q=wq, weight_bytes=wq.nbytes,
                     mult=s_in * sw / s_out, zp_in=zp_in, zp_out=zp_out)
    else:
        raise ValueError(
            f"quantize_graph: unsupported operator kind {op.kind!r} "
            f"({op.name!r})")
    fn = op_semantics(kind, attrs)

    h, w = (out_shape[0], out_shape[1]) if len(out_shape) == 3 else (1, 1)
    cin = (old.tensors[ins[0]].shape[-1]
           if old.tensors[ins[0]].shape else 1)
    spec = pex_spec(kind, tuple(out_shape) if len(out_shape) == 3
                    else (h, w, out_shape[-1] if out_shape else 1),
                    cin, attrs.get("k", 1), attrs.get("stride", 1))
    if spec is not None:
        attrs[PEX_ATTR] = spec
    new.add_operator(op.name, ins, out, kind=kind, fn=fn, **attrs)
