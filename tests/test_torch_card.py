"""Tests that need a CUDA card: each skips without one.  Run them on the
card with

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_card.py

This file imports no JAX: the card's machine has none.

* Dispatch run-ahead: the engine launches dispatch N+1 before it waits on
  N, so N+1's download is enqueued while N's answers are still to be
  read.  Each dispatch comes back into its own host staging pair: N's
  answers read after N+1 has run to its end are still N's own,
  bit-identical to ``Deployment.run``.
"""
import numpy as np
import pytest
import torch

import repro_torch.deploy as deploy
from repro_torch.graphs import mobilenet_v1_graph, random_input
from repro_torch.serving import ShardedServingEngine

pytestmark = pytest.mark.card

LANES = 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_run_ahead_reads_each_dispatch_from_its_own_staging_pair(card):
    d = deploy.build(mobilenet_v1_graph(0.25, 96), quantize=True,
                     device=card)
    ex = d.executor
    reqs = [random_input(d.exec_graph, seed=s) for s in range(3 * LANES)]
    want = [d.run(r) for r in reqs]
    eng = ShardedServingEngine(d, replicas=1, lanes=LANES)
    prog = eng._fn.programs[0]
    replays = eng.counters["replays"]
    rids = [eng.submit(r) for r in reqs]
    for n in range(3):
        ahead = n < 2          # a full batch is queued behind dispatch n
        before = eng.counters["run_ahead"]
        assert eng.step() == LANES
        assert eng.counters["run_ahead"] - before == int(ahead)
        assert len(eng._inflight) == int(ahead)
        # the dispatch launched after n has run to its end: its download
        # has landed, in the other pair
        torch.cuda.synchronize(card)
        first = n * LANES
        for lane in range(LANES):
            for got in (eng.take(rids[first + lane]),
                        ex.outputs_from(prog, lane)):
                for name, val in want[first + lane].items():
                    assert got[name].dtype == val.dtype
                    np.testing.assert_array_equal(got[name], val)
    c = eng.counters
    assert (c["dispatches"], c["run_ahead"]) == (3, 2)
    assert c["replays"] - replays == 3 and prog.graph is not None
