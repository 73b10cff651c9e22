"""A SwiftNet-Cell-like CNN (Cheng et al., VWW 2019 winning submission used in
the paper's Table 1).  The exact cell graph is not published; we reconstruct a
faithful *shape*: a branchy cell — 1x1 bottleneck feeding two asymmetric
paths (1x1→3x3dw→1x1 and 3x3dw→1x1) joined by concat — repeated over four
resolution stages on a 96×96×3 person-detection input, ≈250 KB of int8
parameters, with the same property the paper exploits: the embedded
(insertion) operator order is memory-suboptimal and reordering recovers tens
of KB of SRAM.
"""
from __future__ import annotations

from repro_torch.core.graph import Graph
from .cnn_ops import CNNBuilder


def _cell(b: CNNBuilder, x: str, mid: int, expand: int, out_a: int,
          out_b: int, stride: int = 1) -> str:
    if stride > 1:
        x = b.dwconv(x, k=3, stride=stride)
    t1 = b.conv(x, mid, k=1)
    # branch A (long, fat): 1x1 expand -> 3x3 dw -> 1x1 project
    a1 = b.conv(t1, expand, k=1)
    a2 = b.dwconv(a1, k=3)
    a3 = b.conv(a2, out_a, k=1)
    # branch B (short, thin): 1x1 project -> 3x3 dw
    b1 = b.conv(t1, out_b, k=1)
    b2 = b.dwconv(b1, k=3)
    return b.concat([a3, b2])


def swiftnet_cell_graph() -> Graph:
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", 96, 96, 3)
    x = b.conv(x, 12, k=3, stride=1)          # stem, 96x96x12 (108 KB)
    x = _cell(b, x, mid=22, expand=9, out_a=8, out_b=2)       # 96x96x10
    x = _cell(b, x, mid=40, expand=20, out_a=24, out_b=8, stride=2)   # 48² x32
    x = _cell(b, x, mid=80, expand=40, out_a=48, out_b=16, stride=2)  # 24² x64
    x = _cell(b, x, mid=160, expand=80, out_a=96, out_b=32, stride=2) # 12² x128
    x = b.dwconv(x, k=3, stride=2)                            # 6x6x128
    x = b.conv(x, 384, k=1)                                   # 6x6x384
    x = b.avgpool(x)
    x = b.fc(x, 2)
    g.set_outputs([x])
    return g
