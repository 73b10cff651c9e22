"""2-D tiled cascades (row chunks x W-strips, ``pex_cols``/``pex_wpads``/
``pex_cstart``) on the port's arena executor, bit-exact against the
reference executor on MobileNet-0.25@96 int8."""
import torch

from test_torch_cascade import check_cascade

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)


def test_int8_strip_cascade_bit_identical():
    check_cascade((2,))
