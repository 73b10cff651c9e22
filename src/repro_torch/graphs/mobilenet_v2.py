"""MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2): inverted
residual blocks with linear bottlenecks.

A 3x3 stride-2 conv to 32 channels, then seven stages of bottleneck
blocks ``(t, c, n, s)``: each block expands its input t-fold by a 1x1 conv
with ReLU6 (none where t = 1), filters it by a 3x3 depthwise conv with
ReLU6 (stride s in a stage's first block, 1 after), and projects it to c
channels by a linear 1x1 conv; a stride-1 block whose input and output
widths are equal adds its input to the projection (the residual: 10 of
the 17 blocks).  Then a 1x1 conv with ReLU6 to 1 280 channels, a global
average pool and a fully connected head.  No biases and no batch norms
(folded, as in a deployed model).  Widths are scaled by α and rounded as
the published code rounds them (``make_divisible``); the 1 280-channel
head conv is not narrowed below α 1.

Unlike MobileNet-v1's chain, a block's input stays live across its
expansion, depthwise conv and projection until the add consumes it: the
tensors the scheduler and the cascade's slices must keep.
"""
from __future__ import annotations

from repro_torch.core.graph import Graph
from .cnn_ops import CNNBuilder

# (expansion t, output channels c at alpha 1.0, blocks n, first stride s)
STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
STEM = 32
HEAD = 1280


def make_divisible(v: float, divisor: int = 8) -> int:
    """The published code's channel rounding: to the nearest multiple of
    ``divisor``, at least ``divisor``, and never more than 10 % below
    ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def mobilenet_v2_graph(alpha: float = 1.0, resolution: int = 224,
                       num_classes: int = 1000) -> Graph:
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", resolution, resolution, 3)
    cin = make_divisible(STEM * alpha)
    x = b.conv(x, cin, k=3, stride=2, act="relu6")
    for t, c, n, s in STAGES:
        cout = make_divisible(c * alpha)
        for i in range(n):
            stride = s if i == 0 else 1
            y = x
            if t != 1:
                y = b.conv(y, int(round(cin * t)), k=1, act="relu6")
            y = b.dwconv(y, k=3, stride=stride, act="relu6")
            y = b.conv(y, cout, k=1, act="none")
            x = b.add(x, y) if stride == 1 and cin == cout else y
            cin = cout
    x = b.conv(x, make_divisible(HEAD * max(1.0, alpha)), k=1, act="relu6")
    x = b.avgpool(x)
    x = b.fc(x, num_classes)
    g.set_outputs([x])
    return g


__all__ = ["HEAD", "STAGES", "STEM", "make_divisible", "mobilenet_v2_graph"]
