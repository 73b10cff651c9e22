"""Executable semantics of the CNN graph operators, on PyTorch tensors.

Weights are per-op numpy constants kept in ``Operator.attrs`` — they model
NOR-Flash residency (paper §2.2: parameters are immutable static data, only
activations occupy SRAM), so they are *not* tensors of the scheduling
graph.  Every function takes NHWC tensors with an optional leading batch
dimension (the arena executor passes ``[lanes, H, W, C]``) and runs on the
tensor's device.

This module also classifies operators for **partial execution** (Pex-style
spatial slicing, ``core/partition.py``): elementwise ``add``, depthwise /
regular convolution and max-pooling are sliceable (``pex_spec``); global
``avgpool``, ``fc`` and ``concat`` are not.  ``op_semantics`` rebuilds an
op's callable from its attrs; builders, the int8 rewrite, the
receptive-field edits and ``params.apply_params`` all go through it.

Numerics: int8 ops are bit-identical to the JAX package's.  Integer
convolutions accumulate as an exact float64 convolution (``kernels/
conv_quant/ref.py``), requantization replays ``round(f32(acc) *
f32(mult)) + zp_out`` literally, and ``qadd`` (also in ``ref.py``, as the
plain half of the fused conv→add kernels) is the same integer fixed-point
sequence.  ``qconv2d``/``qdwconv2d`` go through the kernel wrappers, so on
the card the int8 ops run the Hopper kernels.  Float32 ops agree
with XLA within accumulation order; TF32 is switched off for them on the
card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import Graph, Operator
from repro_torch.core.partition import PEX_ATTR, SliceSpec, same_pads
from repro_torch.kernels.conv_pointwise.ops import conv1x1_fused
from repro_torch.kernels.conv_quant.ops import (RingWindow, qconv_fused,
                                                qdwconv_fused)
from repro_torch.kernels.conv_quant.ref import (INT8_MAX, INT8_MIN,
                                                f32_scalar, qadd, requantize)


def _weight(name: str, shape: Tuple[int, ...], scale: float = 0.1):
    rng = np.random.default_rng(abs(hash(name)) % (2 ** 32))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def conv_out_hw(h: int, w: int, stride: int) -> Tuple[int, int]:
    return math.ceil(h / stride), math.ceil(w / stride)


def _pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    _, beg, end = same_pads(n, k, stride)
    return beg, end


# ----------------------------------------------------- slice-spec factories
def _windowed_slice_fn(kernel_name: str, attr_names: Tuple[str, ...]):
    """make_fn factory for windowed kernels: reads the kernel's extra args
    from op.attrs and rebuilds it with explicit height padding — and, for
    2-D tile clones, explicit width padding."""
    def make(op: Operator, pad_top: int, pad_bottom: int,
             pad_left: Optional[int] = None, pad_right: Optional[int] = None):
        kernel = globals()[kernel_name]
        args = tuple(op.attrs[a] for a in attr_names)

        if pad_left is None:
            def fn(x, kernel=kernel, args=args, hpad=(pad_top, pad_bottom)):
                return kernel(x, *args, hpad=hpad)
        else:
            def fn(x, kernel=kernel, args=args, hpad=(pad_top, pad_bottom),
                   wpad=(pad_left, pad_right)):
                return kernel(x, *args, hpad=hpad, wpad=wpad)
        return fn
    return make


def _elementwise_slice_fn(op: Operator, pad_top: int, pad_bottom: int,
                          pad_left: int = 0, pad_right: int = 0):
    assert pad_top == 0 and pad_bottom == 0
    assert pad_left in (0, None) and pad_right in (0, None)
    return op.fn


_QCONV_ATTRS = ("weight_q", "stride", "mult", "zp_in", "zp_out")


def pex_spec(kind: str, out_shape: Tuple[int, int, int], cin: int,
             k: int = 1, stride: int = 1) -> Optional[SliceSpec]:
    """The partial-execution classification of a CNN operator kind.  The
    int8 kinds (``q*``) slice exactly like their float counterparts: the
    row map only depends on kernel/stride, and requantization is per-tensor
    so every slice applies the same (scale, zero-point)."""
    oh, ow, cout = out_shape
    if kind == "conv":
        return SliceSpec(k, stride, (0,),
                         _windowed_slice_fn("conv2d", ("weight", "stride")),
                         macs_per_row=ow * cout * k * k * cin)
    if kind == "dwconv":
        return SliceSpec(k, stride, (0,),
                         _windowed_slice_fn("dwconv2d", ("weight", "stride")),
                         macs_per_row=ow * cout * k * k)
    if kind == "maxpool":
        return SliceSpec(k, stride, (0,),
                         _windowed_slice_fn("maxpool2d", ("k", "stride")),
                         macs_per_row=ow * cout * k * k)
    if kind == "add":
        return SliceSpec(1, 1, None, _elementwise_slice_fn,
                         macs_per_row=ow * cout)
    if kind == "qconv":
        return SliceSpec(k, stride, (0,),
                         _windowed_slice_fn("qconv2d", _QCONV_ATTRS),
                         macs_per_row=ow * cout * k * k * cin)
    if kind == "qdwconv":
        return SliceSpec(k, stride, (0,),
                         _windowed_slice_fn("qdwconv2d", _QCONV_ATTRS),
                         macs_per_row=ow * cout * k * k)
    if kind == "qmaxpool":
        return SliceSpec(k, stride, (0,),
                         _windowed_slice_fn("qmaxpool2d", ("k", "stride")),
                         macs_per_row=ow * cout * k * k)
    if kind == "qadd":
        return SliceSpec(1, 1, None, _elementwise_slice_fn,
                         macs_per_row=ow * cout)
    return None    # concat / avgpool / fc: not spatially sliceable


def op_semantics(kind: str, attrs: Dict[str, Any]
                 ) -> Optional[Callable[..., torch.Tensor]]:
    """The executable semantics of a ``kind`` operator with ``attrs``, as a
    closure over the attr values (None for kinds without semantics)."""
    a = dict(attrs)
    if kind == "conv":
        return lambda x: conv2d(x, a["weight"], a["stride"])
    if kind == "dwconv":
        return lambda x: dwconv2d(x, a["weight"], a["stride"])
    if kind == "maxpool":
        return lambda x: maxpool2d(x, a["k"], a["stride"])
    if kind == "add":
        return lambda x, y: x + y
    if kind == "concat":
        return lambda *xs: torch.cat(xs, dim=-1)
    if kind == "avgpool":
        return avgpool
    if kind == "fc":
        return lambda x: fc(x, a["weight"])
    if kind in ("qconv", "qdwconv"):
        kern = qconv2d if kind == "qconv" else qdwconv2d
        return lambda x: kern(x, a["weight_q"], a["stride"], a["mult"],
                              a["zp_in"], a["zp_out"])
    if kind == "qmaxpool":
        return lambda x: qmaxpool2d(x, a["k"], a["stride"])
    if kind == "qavgpool":
        return qavgpool
    if kind == "qadd":
        return lambda x, y: qadd(x, y, a["mult_a"], a["mult_b"], a["zp_a"],
                                 a["zp_b"], a["zp_out"])
    if kind == "qfc":
        return lambda x: qfc(x, a["weight_q"], a["mult"], a["zp_in"],
                             a["zp_out"])
    if kind == "qconcat":
        return lambda *xs: qconcat(*xs, mults=a["mults"], zps=a["zps"],
                                   zp_out=a["zp_out"])
    if kind == "quant":
        return lambda x: quantize_array(x, a["scale"], a["zp"])
    if kind == "dequant":
        return lambda x: dequantize_array(x, a["scale"], a["zp"])
    return None


# Each builder registers a tensor + operator on the graph and returns the
# output tensor name.  The builder models the *float* network, so tensors
# are float32 and sizes are honest bytes (4 * H * W * C); the post-training
# int8 path (``graphs/quantize.py``) rewrites the graph with int8 tensors
# at 1 byte per element.
F32 = 4   # bytes per float32 element


class CNNBuilder:
    def __init__(self, graph: Graph):
        self.g = graph
        self.shapes: Dict[str, Tuple[int, int, int]] = {}
        self._n = 0

    def _next(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}{self._n}"

    def input(self, name: str, h: int, w: int, c: int) -> str:
        self.g.add_tensor(name, F32 * h * w * c, (h, w, c), dtype="float32")
        self.shapes[name] = (h, w, c)
        return name

    def _emit(self, kind: str, inputs: Sequence[str], out_shape,
              cin: int = 0, **attrs):
        name = self._next(kind)
        out = f"{name}_out"
        h, w, c = out_shape
        self.g.add_tensor(out, F32 * h * w * c, out_shape, dtype="float32")
        self.shapes[out] = out_shape
        spec = pex_spec(kind, out_shape, cin, attrs.get("k", 1),
                        attrs.get("stride", 1))
        if spec is not None:
            attrs[PEX_ATTR] = spec
        self.g.add_operator(name, list(inputs), out, kind=kind,
                            fn=op_semantics(kind, attrs), **attrs)
        return out

    def conv(self, x: str, cout: int, k: int = 1, stride: int = 1) -> str:
        h, w, cin = self.shapes[x]
        oh, ow = conv_out_hw(h, w, stride)
        wgt = _weight(f"conv{self._n + 1}_w", (k, k, cin, cout))
        return self._emit("conv", [x], (oh, ow, cout), cin=cin,
                          weight_bytes=wgt.nbytes, weight=wgt, k=k,
                          stride=stride)

    def dwconv(self, x: str, k: int = 3, stride: int = 1) -> str:
        h, w, cin = self.shapes[x]
        oh, ow = conv_out_hw(h, w, stride)
        wgt = _weight(f"dw{self._n + 1}_w", (k, k, cin, 1))
        return self._emit("dwconv", [x], (oh, ow, cin), cin=cin,
                          weight_bytes=wgt.nbytes, weight=wgt, k=k,
                          stride=stride)

    def maxpool(self, x: str, k: int = 2, stride: int = 2) -> str:
        h, w, c = self.shapes[x]
        oh, ow = conv_out_hw(h, w, stride)
        return self._emit("maxpool", [x], (oh, ow, c), cin=c, k=k,
                          stride=stride)

    def concat(self, xs: Sequence[str]) -> str:
        shapes = [self.shapes[x] for x in xs]
        h, w = shapes[0][0], shapes[0][1]
        c = sum(s[2] for s in shapes)
        return self._emit("concat", xs, (h, w, c))

    def add(self, a: str, b: str) -> str:
        return self._emit("add", [a, b], self.shapes[a],
                          cin=self.shapes[a][2])

    def avgpool(self, x: str) -> str:
        h, w, c = self.shapes[x]
        return self._emit("avgpool", [x], (1, 1, c))

    def fc(self, x: str, nout: int) -> str:
        h, w, c = self.shapes[x]
        wgt = _weight(f"fc{self._n + 1}_w", (h * w * c, nout))
        return self._emit("fc", [x], (1, 1, nout), weight=wgt,
                          weight_bytes=wgt.nbytes)


# ---------------------------------------------------------- float32 ops
def _const(w, like: torch.Tensor) -> torch.Tensor:
    """An op constant (numpy or tensor) on ``like``'s device."""
    return torch.as_tensor(w, device=like.device)


def _conv_f32(x: torch.Tensor, w_oihw: torch.Tensor, stride: int,
              hp: Tuple[int, int], wp: Tuple[int, int],
              groups: int) -> torch.Tensor:
    squeeze = x.dim() == 3
    x4 = (x[None] if squeeze else x).permute(0, 3, 1, 2)
    x4 = F.pad(x4, (wp[0], wp[1], hp[0], hp[1]))
    # TF32 off: full float32 products, as on the reference
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x4, w_oihw, stride=stride, groups=groups)
    y = torch.clamp_min(y.permute(0, 2, 3, 1), 0.0)
    return y[0] if squeeze else y


def conv2d(x, w, stride: int, hpad: Optional[Tuple[int, int]] = None,
           wpad: Optional[Tuple[int, int]] = None):
    """x: (..., H, W, Cin) f32; w: (k, k, Cin, Cout); SAME padding; relu.

    ``hpad``/``wpad`` override the height/width padding with explicit
    (before, after) pairs — a Pex slice or 2-D tile clone gets its halo
    rows and columns from the input window instead of zero padding."""
    k = w.shape[0]
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else \
        tuple(wpad)
    return _conv_f32(x, _const(w, x).permute(3, 2, 0, 1), stride, hp, wp, 1)


def dwconv2d(x, w, stride: int, hpad: Optional[Tuple[int, int]] = None,
             wpad: Optional[Tuple[int, int]] = None):
    """Depthwise: w (k, k, Cin, 1)."""
    k = w.shape[0]
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else \
        tuple(wpad)
    return _conv_f32(x, _const(w, x).permute(2, 3, 0, 1), stride, hp, wp,
                     x.shape[-1])


def _window_max(x, k: int, stride: int, hp: Tuple[int, int],
                wp: Tuple[int, int], fill) -> torch.Tensor:
    """Max over k x k windows, padding taking the identity ``fill``."""
    xp = F.pad(x, (0, 0, wp[0], wp[1], hp[0], hp[1]), value=fill)
    oh = (xp.shape[-3] - k) // stride + 1
    ow = (xp.shape[-2] - k) // stride + 1
    out = None
    for dy in range(k):
        for dx in range(k):
            win = xp[..., dy:dy + (oh - 1) * stride + 1:stride,
                     dx:dx + (ow - 1) * stride + 1:stride, :]
            out = win if out is None else torch.maximum(out, win)
    return out


def maxpool2d(x, k: int, stride: int,
              hpad: Optional[Tuple[int, int]] = None,
              wpad: Optional[Tuple[int, int]] = None):
    """SAME max-pooling over (H, W); padding takes the -inf identity, so
    explicit-pad slices are bit-identical to the full op."""
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], k, stride) if wpad is None else tuple(wpad)
    return _window_max(x, k, stride, hp, wp, float("-inf"))


def avgpool(x):
    """Global average over (H, W), kept as a 1x1 map: the float32 sum
    divided by the count, as ``jnp.mean`` computes it."""
    return x.sum(dim=(-3, -2), keepdim=True) / (x.shape[-3] * x.shape[-2])


def fc(x, w):
    """Explicit mul+reduce over the flattened (H, W, C) map (the
    reference's formulation); output (..., 1, 1, nout)."""
    lead = x.shape[:-3]
    y = (x.reshape(*lead, -1, 1) * _const(w, x)).sum(dim=-2)
    return y.reshape(*lead, 1, 1, y.shape[-1])


# ------------------------------------------------------ int8 (quantized) ops
# Per-tensor affine quantization (TFLite-Micro convention): real = scale *
# (q - zero_point), q int8 in [-128, 127].  Convolutions subtract the input
# zero-point, accumulate exactly, then requantize through a single float32
# multiplier ``mult = s_in * s_w / s_out`` with round-half-even.  SAME
# padding in the quantized domain pads with the input zero-point, which
# the (x - zp) -> pad-with-0 formulation gives for free, so Pex slices of
# int8 ops stay bit-identical too.
def quantize_array(x, scale: float, zp: int):
    """f32 -> int8 at (scale, zp).  Also the semantics of ``quant`` ops."""
    s = f32_scalar(scale, x.device)
    q = torch.round(x.to(torch.float32) / s) + zp
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize_array(q, scale: float, zp: int):
    """int8 -> f32; the semantics of ``dequant`` ops."""
    s = f32_scalar(scale, q.device)
    return (q.to(torch.float32) - zp) * s


def qconv2d(x, w, stride: int, mult: float, zp_in: int, zp_out: int,
            hpad: Optional[Tuple[int, int]] = None,
            wpad: Optional[Tuple[int, int]] = None):
    """x: (..., H, W, Cin) int8; w: (k, k, Cin, Cout) int8; SAME padding;
    fused relu (lower clamp at ``zp_out``).  Through ``qconv_fused``: K1 or
    K3 on a CUDA tensor, their plain versions on a CPU one."""
    return qconv_fused(x, _const(w, x), stride=stride, mult=mult,
                       zp_in=zp_in, zp_out=zp_out, hpad=hpad, wpad=wpad)


def qdwconv2d(x, w, stride: int, mult: float, zp_in: int, zp_out: int,
              hpad: Optional[Tuple[int, int]] = None,
              wpad: Optional[Tuple[int, int]] = None):
    """Depthwise twin of ``qconv2d``: w (k, k, C, 1) int8; K2 on a CUDA
    tensor."""
    return qdwconv_fused(x, _const(w, x), stride=stride, mult=mult,
                         zp_in=zp_in, zp_out=zp_out, hpad=hpad, wpad=wpad)


def qmaxpool2d(x, k: int, stride: int,
               hpad: Optional[Tuple[int, int]] = None,
               wpad: Optional[Tuple[int, int]] = None):
    """Max-pooling is order-preserving, so scale/zero-point pass through;
    padding takes the int8 identity -128 (mirrors the f32 -inf)."""
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], k, stride) if wpad is None else tuple(wpad)
    return _window_max(x, k, stride, hp, wp, INT8_MIN)


def qavgpool(x):
    """Global average in the quantized domain (scale/zp pass through: the
    mean of q-values represents the mean of reals at the same params)."""
    m = avgpool(x.to(torch.float32))
    return torch.clamp(torch.round(m), INT8_MIN, INT8_MAX).to(torch.int8)


def qfc(x, w, mult: float, zp_in: int, zp_out: int):
    """int8 fully-connected: exact integer mul+reduce, then requantize."""
    lead = x.shape[:-3]
    xi = (x.to(torch.int32) - zp_in).reshape(*lead, -1, 1)
    acc = (xi * _const(w, x).to(torch.int32)).sum(dim=-2).to(torch.int32)
    return requantize(acc.reshape(*lead, 1, 1, acc.shape[-1]), mult, zp_out)


def qconcat(*xs, mults: Sequence[float], zps: Sequence[int], zp_out: int):
    """Channel concat with per-input requantization to the output params."""
    parts = []
    for x, m, zp in zip(xs, mults, zps):
        mt = f32_scalar(m, x.device)
        y = torch.round((x.to(torch.float32) - zp) * mt) + zp_out
        parts.append(torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8))
    return torch.cat(parts, dim=-1)


# ----------------------------------------- receptive-field redistribution
# MCUNetV2's "receptive field redistribution" (the planner option
# ``cascade_graph(..., rf_redistribute=(shrink_op, grow_op))``): shrink an
# early kernel to its center tap (a flagged MODEL EDIT) and grow a late
# kernel by zero-embedding (function-preserving: a zero tap contributes
# exactly 0 to the accumulation).
_RF_KINDS = ("conv", "dwconv", "qconv", "qdwconv")


def _rf_op(graph: Graph, op_name: str) -> Operator:
    for op in graph.operators:
        if op.name == op_name:
            if op.kind not in _RF_KINDS:
                raise ValueError(
                    f"receptive-field edit needs a conv kind, {op_name!r} "
                    f"is {op.kind!r}")
            return op
    raise KeyError(op_name)


def _rf_rebuild(graph: Graph, op: Operator, new_w: Optional[np.ndarray],
                new_k: int, rf_edit: str) -> Graph:
    """Copy of ``graph`` with ``op`` rebuilt at kernel size ``new_k``:
    weights/attrs/fn/SliceSpec all refreshed so the planner's halo maps and
    the executable semantics agree on the new reach."""
    wkey = "weight_q" if op.kind.startswith("q") else "weight"
    attrs = {a: v for a, v in op.attrs.items() if a != PEX_ATTR}
    old_k = attrs["k"]
    attrs["k"] = new_k
    attrs["rf_edit"] = rf_edit
    if new_w is not None:
        attrs[wkey] = new_w
        attrs["weight_bytes"] = new_w.nbytes
    elif "weight_bytes" in attrs:
        # scheduling-only graphs carry no weights: scale flash accounting
        attrs["weight_bytes"] = (attrs["weight_bytes"] * new_k * new_k
                                 // (old_k * old_k))
    out_shape = tuple(graph.tensors[op.output].shape)
    in_shape = graph.tensors[op.inputs[0]].shape
    cin = in_shape[-1] if in_shape else 1
    spec = pex_spec(op.kind, out_shape, cin, new_k, attrs["stride"])
    if spec is not None:
        attrs[PEX_ATTR] = spec
    fn = (op_semantics(op.kind, attrs)
          if new_w is not None and op.fn is not None else None)
    new = Graph()
    for tname, t in graph.tensors.items():
        new.add_tensor(tname, t.size, t.shape, t.dtype)
    for o in graph.operators:
        if o.name == op.name:
            new.add_operator(o.name, list(o.inputs), o.output, kind=o.kind,
                             fn=fn, **attrs)
        else:
            new.add_operator(o.name, list(o.inputs), o.output, kind=o.kind,
                             fn=o.fn, **o.attrs)
    new.set_outputs(graph.outputs)
    return new


def grow_kernel(graph: Graph, op_name: str,
                new_k: Optional[int] = None) -> Graph:
    """Zero-embed ``op_name``'s kernel into a ``new_k``×``new_k`` one
    (default k+2).  Function-preserving — bit-identical outputs."""
    op = _rf_op(graph, op_name)
    k, stride = op.attrs["k"], op.attrs["stride"]
    new_k = k + 2 if new_k is None else new_k
    if new_k < k:
        raise ValueError(f"grow_kernel: new_k {new_k} < k {k}")
    h_in, w_in = graph.tensors[op.inputs[0]].shape[:2]
    eh = same_pads(h_in, new_k, stride)[1] - same_pads(h_in, k, stride)[1]
    ew = same_pads(w_in, new_k, stride)[1] - same_pads(w_in, k, stride)[1]
    assert 0 <= eh <= new_k - k and 0 <= ew <= new_k - k, (eh, ew, k, new_k)
    wkey = "weight_q" if op.kind.startswith("q") else "weight"
    old_w = op.attrs.get(wkey)
    new_w = None
    if old_w is not None:
        new_w = np.zeros((new_k, new_k) + old_w.shape[2:], old_w.dtype)
        new_w[eh:eh + k, ew:ew + k] = old_w
    return _rf_rebuild(graph, op, new_w, new_k, "grow")


def shrink_kernel(graph: Graph, op_name: str) -> Graph:
    """Shrink ``op_name``'s kernel to its center tap (k -> 1).  A flagged
    MODEL EDIT (``attrs['rf_edit'] == 'shrink'``)."""
    op = _rf_op(graph, op_name)
    k, stride = op.attrs["k"], op.attrs["stride"]
    if k == 1:
        return graph
    h_in, w_in = graph.tensors[op.inputs[0]].shape[:2]
    # the tap that reads input row i*stride — what a 1x1 SAME kernel reads
    pb_h = same_pads(h_in, k, stride)[1]
    pb_w = same_pads(w_in, k, stride)[1]
    assert 0 <= pb_h < k and 0 <= pb_w < k, (pb_h, pb_w, k)
    wkey = "weight_q" if op.kind.startswith("q") else "weight"
    old_w = op.attrs.get(wkey)
    new_w = None
    if old_w is not None:
        new_w = np.ascontiguousarray(old_w[pb_h:pb_h + 1, pb_w:pb_w + 1])
    return _rf_rebuild(graph, op, new_w, 1, "shrink")


def redistribute_receptive_field(graph: Graph, shrink: str, grow: str,
                                 grow_k: Optional[int] = None) -> Graph:
    """Move kernel reach from an early op (``shrink`` -> center tap) to a
    later one (``grow`` zero-embedded to ``grow_k``, default its k plus the
    reach the shrink dropped)."""
    s_op = _rf_op(graph, shrink)
    g_op = _rf_op(graph, grow)
    if grow_k is None:
        grow_k = g_op.attrs["k"] + max(0, s_op.attrs["k"] - 1)
    out = shrink_kernel(graph, shrink)
    return grow_kernel(out, grow, grow_k)


# ------------------------------------------------- compiled-executor lowering
# Rules for the arena executor (mcu/compile.py) live next to the semantics
# they mirror.  Each rebuilds the op's computation from attrs (weights from
# the executor's device cache, plus the explicit pads a partial-execution
# clone carries in ``pex_pads``/``pex_wpads``).  The int8 convs and the
# k=1, stride-1 f32 convs go through the kernel wrappers, which launch the
# Hopper kernels on a CUDA arena and run the plain versions on a CPU one —
# writing straight into the output's arena view either way.  Every other
# f32 conv is ``F.conv2d`` with TF32 off, as the reference computes those
# outside any Pallas kernel.  A zero-copy ring read reaches qconv/qdwconv/
# qmaxpool as a ``RingWindow``: the int8 conv drop-ins hand it to K2/K3 in
# place on the card, qmaxpool gathers it.
from repro_torch.mcu.compile import register_lowering  # noqa: E402


@register_lowering("conv")
def _lower_conv(ctx, op: Operator, x, *, out):
    a = op.attrs
    if a.get("k", 1) == 1 and a["stride"] == 1:
        # the reference's use_pallas branch: every k=1, stride-1 f32 conv is
        # the pointwise kernel K6 (ReLU, no bias), writing into the arena
        for key in ("pex_pads", "pex_wpads"):
            assert tuple(a.get(key) or (0, 0)) == (0, 0), (op.name, key)
        return conv1x1_fused(x, ctx.param(op, "weight")[0, 0], relu=True,
                             out=out)
    return conv2d(x, ctx.param(op, "weight"), a["stride"],
                  hpad=a.get("pex_pads"), wpad=a.get("pex_wpads"))


@register_lowering("dwconv")
def _lower_dwconv(ctx, op: Operator, x, *, out):
    return dwconv2d(x, ctx.param(op, "weight"), op.attrs["stride"],
                    hpad=op.attrs.get("pex_pads"),
                    wpad=op.attrs.get("pex_wpads"))


@register_lowering("maxpool")
def _lower_maxpool(ctx, op: Operator, x, *, out):
    return maxpool2d(x, op.attrs["k"], op.attrs["stride"],
                     hpad=op.attrs.get("pex_pads"),
                     wpad=op.attrs.get("pex_wpads"))


@register_lowering("add")
def _lower_add(ctx, op: Operator, x, y, *, out):
    return x + y


@register_lowering("concat")
def _lower_concat(ctx, op: Operator, *xs, out):
    return torch.cat(xs, dim=-1)


@register_lowering("avgpool")
def _lower_avgpool(ctx, op: Operator, x, *, out):
    return avgpool(x)


@register_lowering("fc")
def _lower_fc(ctx, op: Operator, x, *, out):
    return fc(x, ctx.param(op, "weight"))


@register_lowering("qconv")
def _lower_qconv(ctx, op: Operator, x, *, out):
    a = op.attrs
    return qconv_fused(x, ctx.param(op, "weight_q"), stride=a["stride"],
                       mult=a["mult"], zp_in=a["zp_in"], zp_out=a["zp_out"],
                       hpad=a.get("pex_pads"), wpad=a.get("pex_wpads"),
                       out=out)


@register_lowering("qdwconv")
def _lower_qdwconv(ctx, op: Operator, x, *, out):
    a = op.attrs
    return qdwconv_fused(x, ctx.param(op, "weight_q"), stride=a["stride"],
                         mult=a["mult"], zp_in=a["zp_in"],
                         zp_out=a["zp_out"], hpad=a.get("pex_pads"),
                         wpad=a.get("pex_wpads"), out=out)


@register_lowering("qmaxpool")
def _lower_qmaxpool(ctx, op: Operator, x, *, out):
    if isinstance(x, RingWindow):     # a zero-copy ring read: gathered
        x = x.gather()
    return qmaxpool2d(x, op.attrs["k"], op.attrs["stride"],
                      hpad=op.attrs.get("pex_pads"),
                      wpad=op.attrs.get("pex_wpads"))


@register_lowering("qadd")
def _lower_qadd(ctx, op: Operator, x, y, *, out):
    a = op.attrs
    return qadd(x, y, a["mult_a"], a["mult_b"], a["zp_a"], a["zp_b"],
                a["zp_out"])


@register_lowering("qavgpool")
def _lower_qavgpool(ctx, op: Operator, x, *, out):
    return qavgpool(x)


@register_lowering("qfc")
def _lower_qfc(ctx, op: Operator, x, *, out):
    a = op.attrs
    return qfc(x, ctx.param(op, "weight_q"), a["mult"], a["zp_in"],
               a["zp_out"])


@register_lowering("qconcat")
def _lower_qconcat(ctx, op: Operator, *xs, out):
    a = op.attrs
    return qconcat(*xs, mults=a["mults"], zps=a["zps"], zp_out=a["zp_out"])


@register_lowering("quant")
def _lower_quant(ctx, op: Operator, x, *, out):
    return quantize_array(x, op.attrs["scale"], op.attrs["zp"])


@register_lowering("dequant")
def _lower_dequant(ctx, op: Operator, x, *, out):
    return dequantize_array(x, op.attrs["scale"], op.attrs["zp"])
