"""MobileNetV3-Large (Howard et al., arXiv:1905.02244, Table 1): the
port's own ``mobilenet_v3_large_graph``, whose builder takes the width,
the resolution and the head's classes.  Its weights are placeholders: the
benchmark installs its seeded weights afterwards."""
from __future__ import annotations


def build(alpha: float, resolution: int, num_classes: int):
    from repro_torch.graphs import mobilenet_v3_large_graph
    return mobilenet_v3_large_graph(alpha, resolution, num_classes)


__all__ = ["build"]
