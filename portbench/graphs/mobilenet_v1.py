"""MobileNet-v1 (Howard et al., arXiv:1704.04861) as a graph of the port,
built through its graph API (``repro_torch.graphs.cnn_ops.CNNBuilder``).

The layers are those of the port's ``mobilenet_v1_graph``, operator for
operator; only the fully connected head takes the configuration's
``num_classes`` (the published 1 000), where the port's builder fixes it
at 2.  The builder's own weights are placeholders: the benchmark installs
its seeded weights afterwards.
"""
from __future__ import annotations

# (stride of the depthwise convolution, 1x1 output channels at alpha 1.0)
BLOCKS = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
          (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024),
          (1, 1024))


def build(alpha: float, resolution: int, num_classes: int):
    from repro_torch.core.graph import Graph
    from repro_torch.graphs.cnn_ops import CNNBuilder

    g = Graph()
    b = CNNBuilder(g)
    x = b.input("input", resolution, resolution, 3)
    x = b.conv(x, int(32 * alpha), k=3, stride=2)
    for stride, cout in BLOCKS:
        x = b.dwconv(x, k=3, stride=stride)
        x = b.conv(x, int(cout * alpha), k=1)
    x = b.avgpool(x)
    x = b.fc(x, num_classes)
    g.set_outputs([x])
    return g


__all__ = ["BLOCKS", "build"]
