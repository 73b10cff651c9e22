"""MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2): the port's
own ``mobilenet_v2_graph``, whose builder takes the width, the resolution
and the head's classes.  Its weights are placeholders: the benchmark
installs its seeded weights afterwards."""
from __future__ import annotations


def build(alpha: float, resolution: int, num_classes: int):
    from repro_torch.graphs import mobilenet_v2_graph
    return mobilenet_v2_graph(alpha, resolution, num_classes)


__all__ = ["build"]
