"""Plain reference of MobileNet-v1 (Howard et al., arXiv:1704.04861) as the
benchmark serves it: the float network, its post-training per-tensor
quantization and the quantized forward pass.

It stands apart from the program under test and imports none of it.  It
works over whole tensors (NHWC), with no schedule, no slices and no
arena: what the program computes by parts, this computes whole.  The float
network, whose ranges calibrate the quantization, runs in float32 (no
TF32) one image at a time, as a calibration pass over single images does;
the quantized network runs on batches of images.

The network: a 3x3 stride-2 convolution, 13 blocks of a 3x3 depthwise
convolution and a 1x1 convolution, a global average pool and a fully
connected layer.  Every convolution uses SAME padding and is followed by a
ReLU; there are no biases and no batch norms (folded away in a deployed
model); the fully connected layer has no ReLU.

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
  clipped below at ``zp_out`` (the ReLU) and above at qmax;
* the average pool keeps its input's parameters: ``round(mean(x_q))``;
* the fully connected layer requantizes like a convolution, without the
  ReLU.

``round`` is half to even throughout.  Accumulators are float64: every
partial sum is an integer below 2**53, so any order of summation gives the
exact value.  ``bits`` gives the precision of every activation and weight
but the network's output, which keeps 8 bits so that answers of any
precision compare on one grid: ``bits=8`` is the configuration,
``bits=4`` the control that must fail the comparison.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

# (depthwise stride, 1x1 output channels at alpha 1.0) of the 13 blocks
BLOCKS = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
          (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024),
          (1, 1024))


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer: ``kind`` is conv, dw, pw, avgpool or fc; ``weight_shape``
    is () for the pool."""

    kind: str
    k: int
    stride: int
    cin: int
    cout: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int

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
                "dw": self.k * self.k, "avgpool": 1,
                "fc": self.h_in * self.w_in * self.cin}[self.kind]

    @property
    def macs(self) -> int:
        """Multiply-accumulates of one image, every tap counted."""
        return self.h_out * self.w_out * self.cout * (
            self.fan_in if self.kind != "avgpool" else 0)


def layers(alpha: float, resolution: int, classes: int) -> List[Layer]:
    """The network's layers in order."""
    out: List[Layer] = []
    h = w = resolution

    def add(kind, k, stride, cin, cout):
        nonlocal h, w
        oh, ow = -(-h // stride), -(-w // stride)
        if kind == "avgpool":
            oh = ow = 1
        out.append(Layer(kind, k, stride, cin, cout, h, w, oh, ow))
        h, w = oh, ow
        return cout

    c = add("conv", 3, 2, 3, int(32 * alpha))
    for stride, cout in BLOCKS:
        c = add("dw", 3, stride, c, c)
        c = add("pw", 1, 1, c, int(cout * alpha))
    c = add("avgpool", 1, 1, c, c)
    add("fc", 1, 1, c, classes)
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


def float_forward(x: torch.Tensor, net: Sequence[Layer],
                  weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor of the float32 network on the NHWC batch ``x``: the
    input first, then each layer's output."""
    acts = [x.to(torch.float32)]
    for layer, w in zip(net, weights):
        a, w = acts[-1], w.to(torch.float32)
        if layer.kind == "avgpool":
            acts.append(a.sum(dim=(1, 2), keepdim=True)
                        / (layer.h_in * layer.w_in))
        elif layer.kind == "fc":
            # the fully connected layer as a product and a sum over the
            # flattened map
            y = (a.reshape(a.shape[0], -1, 1) * w).sum(dim=1)
            acts.append(y.reshape(a.shape[0], 1, 1, -1))
        else:
            acts.append(torch.clamp_min(_conv(a, w, layer), 0.0))
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
        return (self.act[i].scale * self.weight_scales[i]
                / self.act[i + 1].scale)


def quantize(net: Sequence[Layer], weights: Sequence[torch.Tensor],
             ranges: Sequence[Tuple[float, float]], bits: int = 8
             ) -> QuantizedNet:
    """Quantize the network at ``bits`` (the output tensor at 8) from the
    calibration ranges; the pool passes its input's parameters through."""
    act: List[QParams] = []
    for i, (lo, hi) in enumerate(ranges):
        b = 8 if i == len(ranges) - 1 else bits
        if i > 0 and net[i - 1].kind == "avgpool":
            act.append(act[-1])
        else:
            act.append(activation_qparams(lo, hi, b))
    wq, ws = [], []
    for layer, w in zip(net, weights):
        if layer.kind == "avgpool":
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
                relu: bool) -> torch.Tensor:
    qmin, qmax = qrange(out.bits)
    y = torch.round(acc.to(torch.float32) * _f32(mult, acc)) + out.zero_point
    return torch.clamp(y, out.zero_point if relu else qmin, qmax).to(
        torch.float64)


def int_forward(x: torch.Tensor, qn: QuantizedNet) -> torch.Tensor:
    """The quantized network's output on the NHWC float32 batch ``x``:
    the integer values of the output tensor (float64 holding integers),
    shape [N, 1, 1, classes]."""
    q = quantize_input(x, qn.act[0])
    for i, layer in enumerate(qn.net):
        zp_in = qn.act[i].zero_point
        if layer.kind == "avgpool":
            qmin, qmax = qrange(qn.act[i + 1].bits)
            q = torch.clamp(torch.round(q.mean(dim=(1, 2), keepdim=True)),
                            qmin, qmax)
            continue
        xi = q - zp_in
        if layer.kind == "fc":
            acc = (xi.reshape(xi.shape[0], -1) @ qn.weights_q[i]).reshape(
                xi.shape[0], 1, 1, -1)
        else:
            acc = _conv(xi, qn.weights_q[i], layer)
        q = _requantize(acc, qn.mult(i), qn.act[i + 1],
                        relu=layer.kind != "fc")
    return q


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


__all__ = ["BLOCKS", "Layer", "QParams", "QuantizedNet", "activation_qparams",
           "calibrate", "float_forward", "he_std", "int_forward", "layers",
           "model_macs", "outputs", "quantize", "quantize_input", "qrange",
           "weight_quantize"]
