"""MobileNet-v1 0.25x @ 96×96 (the TFLite-Micro person-detection model used
in the paper's Table 1 static-vs-dynamic allocation comparison).

This graph is a pure chain, so operator reordering cannot help — exactly the
paper's point: the 241 KB → 55 KB saving there comes from *dynamic allocation*
(freeing dead tensors) instead of static all-tensors-resident planning.
"""
from __future__ import annotations

from repro_torch.core.graph import Graph
from .cnn_ops import CNNBuilder

# (stride of dw, full-width output channels of pw) for the 13 blocks;
# alpha is applied at build time.
_BLOCKS = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
           (2, 512), (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
           (2, 1024), (1, 1024)]


def mobilenet_v1_graph(alpha: float = 0.25, resolution: int = 96,
                       num_classes: int = 2) -> Graph:
    """Width ``alpha`` at ``resolution``; the head is ``num_classes`` wide
    (the person detector's 2 by default, the published 1 000)."""
    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", resolution, resolution, 3)
    x = b.conv(x, int(32 * alpha), k=3, stride=2)
    for stride, cout in _BLOCKS:
        x = b.dwconv(x, k=3, stride=stride)
        x = b.conv(x, int(cout * alpha), k=1)
    x = b.avgpool(x)
    x = b.fc(x, num_classes)
    g.set_outputs([x])
    return g
