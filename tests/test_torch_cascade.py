"""Cascaded Pex streaming on the port's arena executor: ring pushes and
reads lowered from their attrs, zero-copy ring reads and rolled loops,
held bit-exact against the reference executor on MobileNet-0.25@96 int8.
Row rings (1-D cascade) here; W-strip tiles in ``test_torch_cascade2d.py``
(one file each keeps each file's run short)."""
import torch

from repro.core import cascade_graph as jax_cascade
from repro.graphs import mobilenet_v1_graph as jax_mobilenet

from repro_torch.core import cascade_graph
from repro_torch.graphs import mobilenet_v1_graph, random_input

from test_torch_executor import check_twin_executors
from test_torch_params import int8_twins

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)


def check_cascade(strips):
    pf = mobilenet_v1_graph(0.25, 96)
    jq, pq = int8_twins(jax_mobilenet(0.25, 96), pf, random_input(pf))
    jg, pg = jq.graph, pq.graph
    budget = int(0.5 * pg.peak_usage(pg.default_schedule()))
    kw = {} if strips is None else {"strips_choices": strips}
    jc, pc = jax_cascade(jg, budget=budget, **kw), cascade_graph(
        pg, budget=budget, **kw)
    assert pc.cascades and len(pc.cascades) == len(jc.cascades)
    if strips is not None:
        assert all(c.strips == 2 for c in pc.cascades)
    ex = check_twin_executors(jc.graph, jc.graph.default_schedule(),
                              pc.graph, pc.graph.default_schedule(),
                              random_input(pg, seed=6))
    assert ex.zero_copy_reads > 0 and ex.rolled_loops > 0


def test_int8_row_cascade_bit_identical():
    check_cascade(None)
