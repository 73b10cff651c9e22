"""MobileNetV3-Large (Howard et al., "Searching for MobileNetV3",
arXiv:1905.02244, Table 1): bottleneck blocks with squeeze-and-excite and
hard-swish.

A 3x3 stride-2 conv to 16 channels with h-swish, then 15 blocks ``(k,
exp, out, se, nl, s)``.  A block expands its input to ``exp`` channels by
a 1x1 conv (none where ``exp`` equals the input's width), filters it by a
k x k depthwise conv of stride s, and, in a squeeze-and-excite (SE) block,
gates the depthwise output channel by channel: a global average pool, a
1x1 conv to ``make_divisible(exp / 4)`` channels with ReLU, a 1x1 conv
back to ``exp`` with h-sigmoid, and the channel scale (``mul``).  A linear
1x1 conv projects it to ``out`` channels; a stride-1 block whose input and
output widths are equal adds its input (10 of the 15).  The expansion and
the depthwise conv end in the block's nonlinearity, ReLU (``RE``) or
h-swish (``HS``).  Then a 1x1 conv to 960 channels with h-swish, the
global pool, a 1x1 conv to 1 280 channels with h-swish and the fully
connected head.

Departures from the paper and its published code, as in the port's other
networks: no biases and no batch norms (folded, as in a deployed model),
so the head's 1 280-channel conv has no bias either; no dropout; the
classifier is ``fc`` on the 1 x 1 x 1 280 map.  Widths are scaled by α
and rounded as the published code rounds them (``make_divisible``, the
SE squeeze included); the 1 280-channel conv is not narrowed below α 1.

The SE pool needs the whole depthwise output before its gate exists, so
that output stays live while the squeeze path runs and until the gate
multiplies it: the first global reduction inside a network the port runs,
where a cascade's slices must end and start again.
"""
from __future__ import annotations

from repro_torch.core.graph import Graph
from .cnn_ops import CNNBuilder
from .mobilenet_v2 import make_divisible

# (kernel k, expansion width exp, output width out, squeeze-and-excite,
# nonlinearity, stride s) at alpha 1.0, Table 1
BLOCKS = ((3, 16, 16, False, "relu", 1),
          (3, 64, 24, False, "relu", 2),
          (3, 72, 24, False, "relu", 1),
          (5, 72, 40, True, "relu", 2),
          (5, 120, 40, True, "relu", 1),
          (5, 120, 40, True, "relu", 1),
          (3, 240, 80, False, "hswish", 2),
          (3, 200, 80, False, "hswish", 1),
          (3, 184, 80, False, "hswish", 1),
          (3, 184, 80, False, "hswish", 1),
          (3, 480, 112, True, "hswish", 1),
          (3, 672, 112, True, "hswish", 1),
          (5, 672, 160, True, "hswish", 2),
          (5, 960, 160, True, "hswish", 1),
          (5, 960, 160, True, "hswish", 1))
STEM = 16
HEAD_CONV = 960
HEAD = 1280
SE_DIVISOR = 4          # the squeeze is exp / 4 wide, before rounding


def se_width(exp: int) -> int:
    """The SE squeeze's width for an expansion of ``exp`` channels."""
    return make_divisible(exp / SE_DIVISOR)


def mobilenet_v3_large_graph(alpha: float = 1.0, resolution: int = 224,
                             num_classes: int = 1000) -> Graph:
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", resolution, resolution, 3)
    cin = make_divisible(STEM * alpha)
    x = b.conv(x, cin, k=3, stride=2, act="hswish")
    for k, exp, out, se, nl, s in BLOCKS:
        exp, cout = make_divisible(exp * alpha), make_divisible(out * alpha)
        y = x
        if exp != cin:
            y = b.conv(y, exp, k=1, act=nl)
        y = b.dwconv(y, k=k, stride=s, act=nl)
        if se:
            gate = b.avgpool(y)
            gate = b.conv(gate, se_width(exp), k=1, act="relu")
            gate = b.conv(gate, exp, k=1, act="hsigmoid")
            y = b.mul(y, gate)
        y = b.conv(y, cout, k=1, act="none")
        x = b.add(x, y) if s == 1 and cin == cout else y
        cin = cout
    x = b.conv(x, make_divisible(HEAD_CONV * alpha), k=1, act="hswish")
    x = b.avgpool(x)
    x = b.conv(x, make_divisible(HEAD * max(1.0, alpha)), k=1, act="hswish")
    x = b.fc(x, num_classes)
    g.set_outputs([x])
    return g


__all__ = ["BLOCKS", "HEAD", "HEAD_CONV", "STEM", "mobilenet_v3_large_graph",
           "se_width"]
