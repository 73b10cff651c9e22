"""Plain reference of MobileNetV2 (Sandler et al., arXiv:1801.04381,
Table 2): the float network, its post-training per-tensor quantization
and the quantized forward pass.

It stands apart from the program under test and imports none of it.  It
works over whole tensors (NHWC), with no schedule, no slices and no
arena: what the program computes by parts, this computes whole.  The float
network, whose ranges calibrate the quantization, runs in float32 (no
TF32) one image at a time, as a calibration pass over single images does;
the quantized network runs on batches of images.

The network: a 3x3 stride-2 convolution to 32 channels, then seven stages
of inverted residual blocks ``(t, c, n, s)``.  A block expands its input
t-fold by a 1x1 convolution (none where t = 1), filters it by a 3x3
depthwise convolution (stride s in a stage's first block, 1 after) and
projects it to c channels by a 1x1 convolution; a stride-1 block whose
input and output widths are equal adds its input to the projection.
Then a 1x1 convolution to 1 280 channels, a global average pool and a
fully connected layer.  The expansions, the depthwise convolutions, the
stem and the 1 280-channel convolution end in a ReLU6 (clamped at exactly
6.0); the projections are linear; the fully connected layer has no
activation.  Every convolution uses SAME padding; there are no biases and
no batch norms.  Widths are ``c * alpha`` rounded to the nearest multiple
of 8 (at least 8, never more than 10 % below), the published code's
rounding; the 1 280 channels are not narrowed below alpha 1.

Each layer names the tensors it reads (``inputs``): 0 is the image, i + 1
the output of layer i.  Layers are listed in the order the network is
built, which is an order in which every input is made before it is read.

Quantization (TFLite-Micro's per-tensor scheme):

* an activation tensor gets an asymmetric (scale, zero point) from the
  [min, max] its float forward pass reaches over the calibration images,
  the range widened to include 0: ``scale = (hi - lo) / (2**bits - 1)``,
  ``zp = round(qmin - lo / scale)``;
* a weight tensor gets a symmetric scale ``max|w| / qmax`` and
  ``w_q = clip(round(f32(w) / f32(scale)), -qmax, qmax)``;
* an input is quantized as ``clip(round(f32(x) / f32(scale)) + zp)``;
* a convolution accumulates ``(x_q - zp_in) * w_q`` exactly (padding
  holds ``x_q = zp_in``) and requantizes through one float32 multiplier
  ``mult = s_in * s_w / s_out``: ``round(f32(acc) * f32(mult)) + zp_out``,
  clipped to its activation's pair: ``[zp_out, qmax]`` for a ReLU,
  ``[zp_out, min(qmax, zp_out + round(6 / s_out))]`` for a ReLU6 and
  ``[qmin, qmax]`` for a linear one;
* an add rescales both legs to the output's scale in fixed point: with
  ``m = round(s_leg / s_out * 2**16)`` for each leg,
  ``acc = (a_q - zp_a) * m_a + (b_q - zp_b) * m_b`` (exact integers),
  ``z = acc / 2**16`` rounded half to even, and ``clip(z + zp_out, qmin,
  qmax)``; no activation;
* the average pool keeps its input's parameters: ``round(mean(x_q))``;
* the fully connected layer requantizes like a linear convolution.

``round`` is half to even throughout.  Accumulators are float64: every
partial sum is an integer below 2**53, so any order of summation gives the
exact value, and an add's ``acc / 2**16`` is exact too.  ``bits`` gives
the precision of every activation and weight but the network's output,
which keeps 8 bits so that answers of any precision compare on one grid:
``bits=8`` is the configuration, ``bits=4`` the control that must fail
the comparison.  ``relu_projections`` builds the fault the comparison must
also catch: the projections with a ReLU, as in a network without linear
bottlenecks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

# (expansion t, output channels c at alpha 1.0, blocks n, first stride s)
STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
STEM, HEAD = 32, 1280
ADD_SHIFT = 16          # fractional bits of an add's two multipliers


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer: ``kind`` is conv (the k x k stem), pw (1x1), dw
    (depthwise), add, avgpool or fc; ``act`` is relu, relu6 or none for
    the convolutions, "" otherwise; ``inputs`` the tensors it reads;
    ``weight_shape`` is () for the add and the pool."""

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
                "dw": self.k * self.k, "avgpool": 1, "add": 1,
                "fc": self.h_in * self.w_in * self.cin}[self.kind]

    @property
    def macs(self) -> int:
        """Multiply-accumulates of one image, every tap counted; 0 for the
        add and the pool."""
        if self.kind in ("add", "avgpool"):
            return 0
        return self.h_out * self.w_out * self.cout * self.fan_in


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def layers(alpha: float, resolution: int, classes: int,
           relu_projections: bool = False) -> List[Layer]:
    """The network's layers in order."""
    out: List[Layer] = []
    shape = {0: (resolution, resolution, 3)}

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

    proj = "relu" if relu_projections else "none"
    cin = make_divisible(STEM * alpha)
    x = add("conv", 0, k=3, stride=2, cout=cin, act="relu6")
    for t, c, n, s in STAGES:
        cout = make_divisible(c * alpha)
        for i in range(n):
            stride = s if i == 0 else 1
            y = x
            if t != 1:
                y = add("pw", y, cout=int(round(cin * t)), act="relu6")
            y = add("dw", y, k=3, stride=stride, act="relu6")
            y = add("pw", y, cout=cout, act=proj)
            x = add("add", x, other=y) if stride == 1 and cin == cout else y
            cin = cout
    x = add("pw", x, cout=make_divisible(HEAD * max(1.0, alpha)), act="relu6")
    x = add("avgpool", x)
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
    return y


def float_forward(x: torch.Tensor, net: Sequence[Layer],
                  weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor of the float32 network on the NHWC batch ``x``: the
    input first, then each layer's output."""
    acts = [x.to(torch.float32)]
    for layer, w in zip(net, weights):
        a, w = acts[layer.inputs[0]], w.to(torch.float32)
        if layer.kind == "add":
            acts.append(a + acts[layer.inputs[1]])
        elif layer.kind == "avgpool":
            acts.append(a.sum(dim=(1, 2), keepdim=True)
                        / (layer.h_in * layer.w_in))
        elif layer.kind == "fc":
            # the fully connected layer as a product and a sum over the
            # flattened map
            y = (a.reshape(a.shape[0], -1, 1) * w).sum(dim=1)
            acts.append(y.reshape(a.shape[0], 1, 1, -1))
        else:
            acts.append(_activate(_conv(a, w, layer), layer.act))
    return acts


def calibrate(images: torch.Tensor, net: Sequence[Layer],
              weights: Sequence[torch.Tensor]) -> List[Tuple[float, float]]:
    """[min, max] of every tensor of the float32 network over ``images``
    (NHWC), run one image at a time."""
    ranges: List[Tuple[float, float]] = []
    for i in range(images.shape[0]):
        acts = float_forward(images[i:i + 1], net, weights)
        got = [(float(a.min()), float(a.max())) for a in acts]
        ranges = got if not ranges else [
            (min(lo, a), max(hi, b)) for (lo, hi), (a, b) in zip(ranges, got)]
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


def clamp_pair(act: str, out: QParams) -> Tuple[int, int]:
    """The integer range a convolution's output is clipped to."""
    qmin, qmax = qrange(out.bits)
    if act == "relu":
        return out.zero_point, qmax
    if act == "relu6":
        return out.zero_point, min(qmax, out.zero_point
                                   + int(round(6.0 / out.scale)))
    return qmin, qmax


@dataclasses.dataclass
class QuantizedNet:
    """The quantized network: per-tensor parameters (input first, then
    each layer's output) and per-layer integer weights and multipliers."""

    net: List[Layer]
    act: List[QParams]
    weights_q: List[torch.Tensor]
    weight_scales: List[float]

    def mult(self, i: int) -> float:
        """Layer i's requantization multiplier, as a Python float."""
        s_in = self.act[self.net[i].inputs[0]].scale
        return s_in * self.weight_scales[i] / self.act[i + 1].scale


def quantize(net: Sequence[Layer], weights: Sequence[torch.Tensor],
             ranges: Sequence[Tuple[float, float]], bits: int = 8
             ) -> QuantizedNet:
    """Quantize the network at ``bits`` (the output tensor at 8) from the
    calibration ranges; the pool passes its input's parameters through."""
    act: List[QParams] = []
    for i, (lo, hi) in enumerate(ranges):
        b = 8 if i == len(ranges) - 1 else bits
        if i > 0 and net[i - 1].kind == "avgpool":
            act.append(act[net[i - 1].inputs[0]])
        else:
            act.append(activation_qparams(lo, hi, b))
    wq, ws = [], []
    for layer, w in zip(net, weights):
        if not layer.weight_shape:
            wq.append(torch.empty(0))
            ws.append(1.0)
            continue
        q, s = weight_quantize(w, bits)
        wq.append(q)
        ws.append(s)
    return QuantizedNet(list(net), act, wq, ws)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_input(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    qmin, qmax = qrange(qp.bits)
    q = torch.round(x.to(torch.float32) / _f32(qp.scale, x)) + qp.zero_point
    return torch.clamp(q, qmin, qmax).to(torch.float64)


def _requantize(acc: torch.Tensor, mult: float, out: QParams,
                act: str) -> torch.Tensor:
    lo, hi = clamp_pair(act, out)
    y = torch.round(acc.to(torch.float32) * _f32(mult, acc)) + out.zero_point
    return torch.clamp(y, lo, hi).to(torch.float64)


def _add(a: torch.Tensor, b: torch.Tensor, qa: QParams, qb: QParams,
         out: QParams) -> torch.Tensor:
    """The fixed-point add of two quantized tensors (float64 integers)."""
    one = 1 << ADD_SHIFT
    ma = round(qa.scale / out.scale * one)
    mb = round(qb.scale / out.scale * one)
    acc = (a - qa.zero_point) * ma + (b - qb.zero_point) * mb
    qmin, qmax = qrange(out.bits)
    return torch.clamp(torch.round(acc / one) + out.zero_point, qmin, qmax)


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
        elif layer.kind == "avgpool":
            qmin, qmax = qrange(qn.act[i + 1].bits)
            y = torch.clamp(torch.round(q.mean(dim=(1, 2), keepdim=True)),
                            qmin, qmax)
        else:
            xi = q - zp_in
            if layer.kind == "fc":
                acc = (xi.reshape(xi.shape[0], -1)
                       @ qn.weights_q[i]).reshape(xi.shape[0], 1, 1, -1)
            else:
                acc = _conv(xi, qn.weights_q[i], layer)
            y = _requantize(acc, qn.mult(i), qn.act[i + 1],
                            layer.act or "none")
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


__all__ = ["ADD_SHIFT", "HEAD", "Layer", "QParams", "QuantizedNet", "STAGES",
           "STEM", "activation_qparams", "calibrate", "clamp_pair",
           "float_forward", "he_std", "int_forward", "layers",
           "make_divisible", "model_macs", "outputs", "quantize",
           "quantize_input", "qrange", "weight_quantize"]
