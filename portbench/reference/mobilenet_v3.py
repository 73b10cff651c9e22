"""Plain reference of MobileNetV3-Large (Howard et al., "Searching for
MobileNetV3", arXiv:1905.02244, Table 1): the float network, its
post-training per-tensor quantization and the quantized forward pass.

It stands apart from the program under test and imports none of it.  It
works over whole tensors (NHWC), with no schedule, no slices and no
arena: what the program computes by parts, this computes whole.  The float
network, whose ranges calibrate the quantization, runs in float32 (no
TF32) one image at a time, as a calibration pass over single images does;
the quantized network runs on batches of images.

The network: a 3x3 stride-2 convolution to 16 channels with h-swish, then
15 bottleneck blocks ``(k, exp, out, se, nl, s)``.  A block expands its
input to ``exp`` channels by a 1x1 convolution (none where ``exp`` equals
the input's width) and filters it by a k x k depthwise convolution of
stride s, both ending in the block's nonlinearity ``nl``.  A
squeeze-and-excite block then pools the depthwise output globally, runs a
1x1 convolution to ``make_divisible(exp / 4)`` channels with a ReLU and a
1x1 convolution back to ``exp`` with h-sigmoid, and multiplies the
depthwise output by that gate, channel by channel.  A linear 1x1
convolution projects to ``out`` channels; a stride-1 block whose input and
output widths are equal adds its input.  Then a 1x1 convolution to 960
channels with h-swish, the global pool, a 1x1 convolution to 1 280
channels with h-swish and a fully connected layer.  Every convolution uses
SAME padding; there are no biases, batch norms or dropout.  Widths are
``c * alpha`` rounded to the nearest multiple of 8 (at least 8, never more
than 10 % below), the published code's rounding; the 1 280 channels are
not narrowed below alpha 1.

    h-swish(x)   = x * min(max(x + 3, 0), 6) / 6
    h-sigmoid(x) = min(max(x + 3, 0), 6) / 6

each step rounded to float32 in that order, the divisions true ones.

Each layer names the tensors it reads (``inputs``): 0 is the image, i + 1
the output of layer i.  Layers are listed in the order the network is
built, an order in which every input is made before it is read.

Quantization (TFLite-Micro's per-tensor scheme, with tables for the
activations that are not clamps):

* an activation tensor gets an asymmetric (scale, zero point) from the
  [min, max] its float forward pass reaches over the calibration images,
  the range widened to include 0: ``scale = (hi - lo) / (2**bits - 1)``,
  ``zp = round(qmin - lo / scale)``; a convolution ending in h-swish or
  h-sigmoid also gets one for its output *before* the activation (``pre``),
  from that value's range;
* a weight tensor gets a symmetric scale ``max|w| / qmax`` and
  ``w_q = clip(round(f32(w) / f32(scale)), -qmax, qmax)``;
* an input is quantized as ``clip(round(f32(x) / f32(scale)) + zp)``;
* a convolution accumulates ``(x_q - zp_in) * w_q`` exactly (padding
  holds ``x_q = zp_in``) and requantizes through one float32 multiplier
  ``mult = s_in * s_w / s_out``: ``round(f32(acc) * f32(mult)) + zp_out``,
  clipped to ``[zp_out, qmax]`` for a ReLU and ``[qmin, qmax]`` for a
  linear one;
* a convolution ending in h-swish or h-sigmoid requantizes the same way to
  its ``pre`` params, clipped to ``[qmin, qmax]``, and maps the result
  ``q`` through its table: for every ``q`` of the grid, in float32,
  ``x = s_pre * (q - zp_pre)``, ``f(x)`` as above, and ``clip(round(f(x) /
  s_out) + zp_out, qmin, qmax)``;
* the squeeze-and-excite multiply: ``acc = (x_q - zp_x) * (g_q - zp_g)``
  exactly, then ``round(f32(acc) * f32(s_x * s_g / s_out)) + zp_out``,
  clipped to ``[qmin, qmax]``;
* an add rescales both legs to the output's scale in fixed point: with
  ``m = round(s_leg / s_out * 2**16)`` for each leg,
  ``acc = (a_q - zp_a) * m_a + (b_q - zp_b) * m_b`` (exact integers),
  ``z = acc / 2**16`` rounded half to even, and ``clip(z + zp_out, qmin,
  qmax)``;
* the average pools keep their input's parameters: ``round(mean(x_q))``,
  the mean the exact sum over a true division by the count;
* the fully connected layer requantizes like a linear convolution.

``round`` is half to even throughout.  Accumulators are float64: every
partial sum is an integer below 2**53, so any order of summation gives the
exact value.  ``bits`` gives the precision of every activation and weight
but the network's output, which keeps 8 bits so that answers of any
precision compare on one grid: ``bits=8`` is the configuration, ``bits=7``
the control that must fail the comparison.  Two faults the comparison must
catch too: ``relu6_for_hswish`` (a ReLU6 in place of every h-swish, the
MobileNetV2 activation) and ``no_se`` (every gate taken as 1: the
multiply passes its map on at its own scale).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# (k, exp, out, squeeze-and-excite, nonlinearity, stride) at alpha 1.0
BLOCKS = (
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1))
STEM, HEAD_CONV, HEAD = 16, 960, 1280
ADD_SHIFT = 16          # fractional bits of an add's two multipliers
TABLE_ACTS = ("hswish", "hsigmoid")
FAULTS = ("relu6_for_hswish", "no_se")


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer: ``kind`` is conv (the k x k stem), pw (1x1), dw
    (depthwise), add, avgpool, mul (squeeze-and-excite's channel scale;
    its second input is the 1 x 1 gate) or fc; ``act`` is relu, relu6,
    hswish, hsigmoid or none for the convolutions, "" otherwise (``one``
    on a mul under the ``no_se`` fault); ``inputs`` the tensors it reads;
    ``weight_shape`` is () for the add, the pool and the mul."""

    kind: str
    k: int
    stride: int
    cin: int
    cout: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    act: str
    inputs: Tuple[int, ...]

    @property
    def weight_shape(self) -> Tuple[int, ...]:
        if self.kind in ("conv", "pw"):
            return (self.k, self.k, self.cin, self.cout)
        if self.kind == "dw":
            return (self.k, self.k, self.cin, 1)
        if self.kind == "fc":
            return (self.h_in * self.w_in * self.cin, self.cout)
        return ()

    @property
    def fan_in(self) -> int:
        return {"conv": self.k * self.k * self.cin, "pw": self.cin,
                "dw": self.k * self.k, "avgpool": 1, "add": 1, "mul": 1,
                "fc": self.h_in * self.w_in * self.cin}[self.kind]

    @property
    def macs(self) -> int:
        """Multiply-accumulates of one image, every tap counted; 0 for the
        add, the pool and the multiply."""
        if self.kind in ("add", "avgpool", "mul"):
            return 0
        return self.h_out * self.w_out * self.cout * self.fan_in


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def layers(alpha: float, resolution: int, classes: int,
           fault: Optional[str] = None) -> List[Layer]:
    """The network's layers in order; ``fault`` one of ``FAULTS``."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; have {FAULTS}")
    out: List[Layer] = []
    shape = {0: (resolution, resolution, 3)}
    hs = "relu6" if fault == "relu6_for_hswish" else "hswish"

    def add(kind, x, k=1, stride=1, cout=None, act="", other=None):
        h, w, c = shape[x]
        oh, ow = -(-h // stride), -(-w // stride)
        if kind == "avgpool":
            oh = ow = 1
        cout = c if cout is None else cout
        ins = (x,) if other is None else (x, other)
        out.append(Layer(kind, k, stride, c, cout, h, w, oh, ow, act, ins))
        shape[len(out)] = (oh, ow, cout)
        return len(out)

    cin = make_divisible(STEM * alpha)
    x = add("conv", 0, k=3, stride=2, cout=cin, act=hs)
    for k, exp, c, se, nl, s in BLOCKS:
        nl = hs if nl == "hswish" else nl
        exp, cout = make_divisible(exp * alpha), make_divisible(c * alpha)
        y = x
        if exp != cin:
            y = add("pw", y, cout=exp, act=nl)
        y = add("dw", y, k=k, stride=s, act=nl)
        if se:
            g = add("avgpool", y)
            g = add("pw", g, cout=make_divisible(exp / 4), act="relu")
            g = add("pw", g, cout=exp, act="hsigmoid")
            y = add("mul", y, other=g,
                    act="one" if fault == "no_se" else "")
        y = add("pw", y, cout=cout, act="none")
        x = add("add", x, other=y) if s == 1 and cin == cout else y
        cin = cout
    x = add("pw", x, cout=make_divisible(HEAD_CONV * alpha), act=hs)
    x = add("avgpool", x)
    x = add("pw", x, cout=make_divisible(HEAD * max(1.0, alpha)), act=hs)
    add("fc", x, cout=classes)
    return out


def _pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, layer: Layer) -> torch.Tensor:
    """A float32 convolution of NHWC ``x`` by ``w`` (the layer's weight
    shape), SAME-padded with zeros, by cuDNN without TF32 (full float32
    products); NHWC out."""
    hp = _pads(layer.h_in, layer.k, layer.stride)
    wp = _pads(layer.w_in, layer.k, layer.stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (wp[0], wp[1], hp[0], hp[1]))
    groups = layer.cin if layer.kind == "dw" else 1
    w_oihw = w.permute(3, 2, 0, 1) if groups == 1 else w.permute(2, 3, 0, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xc, w_oihw, stride=layer.stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    # a true division: CUDA turns a division by a Python number into a
    # product with its float32 reciprocal
    six = torch.tensor(6.0, dtype=torch.float32, device=y.device)
    if act == "hswish":
        return y * torch.clamp(y + 3.0, 0.0, 6.0) / six
    if act == "hsigmoid":
        return torch.clamp(y + 3.0, 0.0, 6.0) / six
    return y


def float_forward(x: torch.Tensor, net: Sequence[Layer],
                  weights: Sequence[torch.Tensor],
                  pre: Optional[Dict[int, torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Every tensor of the float32 network on the NHWC batch ``x``: the
    input first, then each layer's output.  ``pre``, where given, gets
    each table-activated convolution's output before its activation,
    under the layer's index."""
    acts = [x.to(torch.float32)]
    for i, (layer, w) in enumerate(zip(net, weights)):
        a, w = acts[layer.inputs[0]], w.to(torch.float32)
        if layer.kind == "add":
            acts.append(a + acts[layer.inputs[1]])
        elif layer.kind == "mul":
            acts.append(a if layer.act == "one"
                        else a * acts[layer.inputs[1]])
        elif layer.kind == "avgpool":
            acts.append(a.sum(dim=(1, 2), keepdim=True)
                        / (layer.h_in * layer.w_in))
        elif layer.kind == "fc":
            # the fully connected layer as a product and a sum over the
            # flattened map
            y = (a.reshape(a.shape[0], -1, 1) * w).sum(dim=1)
            acts.append(y.reshape(a.shape[0], 1, 1, -1))
        else:
            y = _conv(a, w, layer)
            if pre is not None and layer.act in TABLE_ACTS:
                pre[i] = y
            acts.append(_activate(y, layer.act))
    return acts


class Ranges(list):
    """[min, max] of every tensor (input first, then each layer's output),
    with ``pre``: each table-activated layer's range before its activation,
    under the layer's index."""

    pre: Dict[int, Tuple[float, float]]


def calibrate(images: torch.Tensor, net: Sequence[Layer],
              weights: Sequence[torch.Tensor]) -> Ranges:
    """The ranges of the float32 network over ``images`` (NHWC), run one
    image at a time."""
    ranges = Ranges()
    ranges.pre = {}
    for i in range(images.shape[0]):
        pre: Dict[int, torch.Tensor] = {}
        acts = float_forward(images[i:i + 1], net, weights, pre)
        got = [(float(a.min()), float(a.max())) for a in acts]
        if not ranges:
            ranges.extend(got)
        else:
            ranges[:] = [(min(lo, a), max(hi, b))
                         for (lo, hi), (a, b) in zip(ranges, got)]
        for j, y in pre.items():
            lo, hi = float(y.min()), float(y.max())
            if j in ranges.pre:
                lo = min(lo, ranges.pre[j][0])
                hi = max(hi, ranges.pre[j][1])
            ranges.pre[j] = (lo, hi)
    return ranges


def qrange(bits: int) -> Tuple[int, int]:
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


@dataclasses.dataclass(frozen=True)
class QParams:
    scale: float
    zero_point: int
    bits: int


def activation_qparams(lo: float, hi: float, bits: int) -> QParams:
    qmin, qmax = qrange(bits)
    lo, hi = min(0.0, lo), max(0.0, hi)
    scale = (hi - lo) / (qmax - qmin) or 1.0
    zp = int(round(qmin - lo / scale))
    return QParams(scale, max(qmin, min(qmax, zp)), bits)


def weight_quantize(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, float]:
    """Symmetric per-tensor: (w_q as float64 integers, scale)."""
    qmax = qrange(bits)[1]
    scale = max(float(w.abs().max()), 1e-8) / qmax
    q = torch.round(w.to(torch.float32) / torch.tensor(
        scale, dtype=torch.float32, device=w.device))
    return torch.clamp(q, -qmax, qmax).to(torch.float64), scale


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def activation_table(act: str, pre: QParams, out: QParams,
                     device: torch.device) -> torch.Tensor:
    """What a table-activated convolution writes for each requantized
    value ``q`` of the ``pre`` grid (entry ``q - qmin``), float64
    integers."""
    qmin, qmax = qrange(pre.bits)
    q = torch.arange(qmin, qmax + 1, dtype=torch.float32, device=device)
    x = _f32(pre.scale, q) * (q - pre.zero_point)
    y = torch.round(_activate(x, act) / _f32(out.scale, q)) + out.zero_point
    omin, omax = qrange(out.bits)
    return torch.clamp(y, omin, omax).to(torch.float64)


@dataclasses.dataclass
class QuantizedNet:
    """The quantized network: per-tensor parameters (input first, then
    each layer's output), each table-activated layer's ``pre`` parameters
    and table, and per-layer integer weights."""

    net: List[Layer]
    act: List[QParams]
    weights_q: List[torch.Tensor]
    weight_scales: List[float]
    pre: Dict[int, QParams]
    tables: Dict[int, torch.Tensor]

    def mult(self, i: int) -> float:
        """Layer i's requantization multiplier, as a Python float: to its
        ``pre`` params where it has them."""
        s_in = self.act[self.net[i].inputs[0]].scale
        out = self.pre.get(i, self.act[i + 1])
        return s_in * self.weight_scales[i] / out.scale


def quantize(net: Sequence[Layer], weights: Sequence[torch.Tensor],
             ranges: Ranges, bits: int = 8) -> QuantizedNet:
    """Quantize the network at ``bits`` (the output tensor at 8) from the
    calibration ranges; the pools pass their input's parameters through."""
    act: List[QParams] = []
    for i, (lo, hi) in enumerate(ranges):
        b = 8 if i == len(ranges) - 1 else bits
        if i > 0 and net[i - 1].kind == "avgpool":
            act.append(act[net[i - 1].inputs[0]])
        else:
            act.append(activation_qparams(lo, hi, b))
    pre = {j: activation_qparams(lo, hi, bits)
           for j, (lo, hi) in ranges.pre.items()}
    device = weights[0].device
    tables = {j: activation_table(net[j].act, pre[j], act[j + 1], device)
              for j in pre}
    wq, ws = [], []
    for layer, w in zip(net, weights):
        if not layer.weight_shape:
            wq.append(torch.empty(0))
            ws.append(1.0)
            continue
        q, s = weight_quantize(w, bits)
        wq.append(q)
        ws.append(s)
    return QuantizedNet(list(net), act, wq, ws, pre, tables)


def quantize_input(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    qmin, qmax = qrange(qp.bits)
    q = torch.round(x.to(torch.float32) / _f32(qp.scale, x)) + qp.zero_point
    return torch.clamp(q, qmin, qmax).to(torch.float64)


def _requantize(acc: torch.Tensor, mult: float, out: QParams,
                relu: bool) -> torch.Tensor:
    qmin, qmax = qrange(out.bits)
    y = torch.round(acc.to(torch.float32) * _f32(mult, acc)) + out.zero_point
    return torch.clamp(y, out.zero_point if relu else qmin,
                       qmax).to(torch.float64)


def _add(a: torch.Tensor, b: torch.Tensor, qa: QParams, qb: QParams,
         out: QParams) -> torch.Tensor:
    """The fixed-point add of two quantized tensors (float64 integers)."""
    one = 1 << ADD_SHIFT
    ma = round(qa.scale / out.scale * one)
    mb = round(qb.scale / out.scale * one)
    acc = (a - qa.zero_point) * ma + (b - qb.zero_point) * mb
    qmin, qmax = qrange(out.bits)
    return torch.clamp(torch.round(acc / one) + out.zero_point, qmin, qmax)


def _mul(x: torch.Tensor, g: torch.Tensor, qx: QParams, qg: QParams,
         out: QParams, gate_one: bool) -> torch.Tensor:
    """The squeeze-and-excite multiply (float64 integers): the map times
    its gate, or, with ``gate_one``, times a gate of real value 1."""
    if gate_one:
        return _requantize(x - qx.zero_point, qx.scale / out.scale, out,
                           False)
    acc = (x - qx.zero_point) * (g - qg.zero_point)
    return _requantize(acc, qx.scale * qg.scale / out.scale, out, False)


def pool_mean(q: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The quantized global average pool of the NHWC batch ``q`` (float64
    integers): the mean rounded half to even, clipped to the grid.  The sum
    is exact and the division a true one, by a tensor on ``q``'s device:
    ``torch.mean`` on CUDA multiplies the sum by the count's reciprocal,
    which moves some ties off them (a sum of 294 over a 14 x 14 map)."""
    n = torch.tensor(float(q.shape[1] * q.shape[2]), dtype=torch.float64,
                     device=q.device)
    qmin, qmax = qrange(bits)
    return torch.clamp(torch.round(q.sum(dim=(1, 2), keepdim=True) / n),
                       qmin, qmax)


def int_forward(x: torch.Tensor, qn: QuantizedNet) -> torch.Tensor:
    """The quantized network's output on the NHWC float32 batch ``x``:
    the integer values of the output tensor (float64 holding integers),
    shape [N, 1, 1, classes]."""
    # the layer after which each tensor is read no more: it is dropped then
    last = {j: i for i, layer in enumerate(qn.net) for j in layer.inputs}
    qs: List = [quantize_input(x, qn.act[0])]
    for i, layer in enumerate(qn.net):
        src = layer.inputs[0]
        q, zp_in = qs[src], qn.act[src].zero_point
        if layer.kind == "add":
            other = layer.inputs[1]
            y = _add(q, qs[other], qn.act[src], qn.act[other], qn.act[i + 1])
        elif layer.kind == "mul":
            other = layer.inputs[1]
            y = _mul(q, qs[other], qn.act[src], qn.act[other],
                     qn.act[i + 1], layer.act == "one")
        elif layer.kind == "avgpool":
            y = pool_mean(q, qn.act[i + 1].bits)
        else:
            xi = q - zp_in
            if layer.kind == "fc":
                acc = (xi.reshape(xi.shape[0], -1)
                       @ qn.weights_q[i]).reshape(xi.shape[0], 1, 1, -1)
            else:
                acc = _conv(xi, qn.weights_q[i], layer)
            if i in qn.tables:
                pre = qn.pre[i]
                y = _requantize(acc, qn.mult(i), pre, False)
                y = qn.tables[i][(y - qrange(pre.bits)[0]).to(torch.int64)]
            else:
                y = _requantize(acc, qn.mult(i), qn.act[i + 1],
                                layer.act in ("relu", "relu6"))
                if layer.act == "relu6":
                    out = qn.act[i + 1]
                    y = torch.clamp(y, max=out.zero_point
                                    + int(round(6.0 / out.scale)))
        qs.append(y)
        for j in layer.inputs:
            if last[j] == i:
                qs[j] = None
    return qs[-1]


def outputs(images: torch.Tensor, qn: QuantizedNet, block: int = 32
            ) -> torch.Tensor:
    """``int_forward`` over ``images`` in blocks; int64 [N, classes]."""
    outs = [int_forward(images[i:i + block], qn).reshape(
        min(block, images.shape[0] - i), -1)
        for i in range(0, images.shape[0], block)]
    return torch.cat(outs).to(torch.int64)


def model_macs(net: Sequence[Layer]) -> int:
    """Multiply-accumulates of one image through the whole network."""
    return sum(layer.macs for layer in net)


def he_std(layer: Layer) -> float:
    """He initialisation's standard deviation for the layer's weights."""
    return math.sqrt(2.0 / layer.fan_in)


__all__ = ["ADD_SHIFT", "BLOCKS", "FAULTS", "HEAD", "HEAD_CONV", "Layer",
           "QParams", "QuantizedNet", "Ranges", "STEM", "activation_qparams",
           "activation_table", "calibrate", "float_forward", "he_std",
           "int_forward", "layers", "make_divisible", "model_macs",
           "outputs", "pool_mean", "quantize", "quantize_input", "qrange",
           "weight_quantize"]
