"""PyTorch/CUDA port of the operator-reordering MCU inference system.

It mirrors ``src/repro/``'s layout and names and imports nothing of it:
the numpy scheduling core is a copy (``core/``), the graph semantics,
int8 quantization, arena executor, deploy facade and serving engine run on
PyTorch, and the int8 convolutions run on hand-written Hopper kernels
(``kernels/conv_quant/csrc``).  Entry points take ``device=None`` (the
card) or ``device="cpu"`` (the plain path)."""
