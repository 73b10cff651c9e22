from .figure1 import (figure1_executable_graph, figure1_graph,
                      figure1_int8_graph)
from .swiftnet import swiftnet_cell_graph
from .mobilenet import mobilenet_v1_graph
from .quantize import (QParams, QuantizedModel, build_quantized,
                       int8_scheduling_graph, quantize_graph)


def graph_dtypes(graph) -> str:
    """Element-width tag for a graph: a single dtype name when uniform
    ("float32", "int8", ...), "mixed" otherwise."""
    kinds = {t.dtype for t in graph.tensors.values()}
    return kinds.pop() if len(kinds) == 1 else "mixed"


def random_input(graph, seed: int = 0):
    """{name: array} for the graph's (single consumed) input tensor, in the
    tensor's declared dtype — f32 normals for float graphs, uniform int8
    for quantized/int8 graphs.  numpy, so the port and the reference see
    the same inputs from the same seed."""
    import numpy as np

    name = next((c for c in graph.constants() if graph.consumers(c)), None)
    if name is None:
        raise ValueError(f"{graph!r} has no consumed input tensor")
    t = graph.tensors[name]
    shape = t.shape if t.shape else (t.elements,)
    rng = np.random.default_rng(seed)
    if t.dtype == "int8":
        return {name: rng.integers(-128, 128, shape).astype(np.int8)}
    return {name: rng.standard_normal(shape).astype(np.float32)}


__all__ = ["figure1_executable_graph", "figure1_graph", "figure1_int8_graph",
           "swiftnet_cell_graph", "mobilenet_v1_graph", "graph_dtypes",
           "random_input", "QParams", "QuantizedModel", "build_quantized",
           "int8_scheduling_graph", "quantize_graph"]
