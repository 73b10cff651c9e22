"""Quickstart on the PyTorch port: the paper's technique in 30 lines.

Builds the paper's Figure-1 computation graph, finds the memory-optimal
operator schedule with Algorithm 1, and prints the Appendix-A working-set
tables — then does the same to a real PyTorch function by reordering the
nodes of its ``torch.fx`` trace.

    PYTHONPATH=src python examples_torch/quickstart.py               # card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.core import minimise_peak_memory, profile
from repro_torch.core.fx_reorder import reorder
from repro_torch.device import resolve_device
from repro_torch.graphs.figure1 import figure1_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the PyTorch function runs (default: the "
                         "card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- 1. the paper's Figure-1 graph --------------------------------
    g = figure1_graph()
    default = g.default_schedule()
    optimal = minimise_peak_memory(g)
    print("=== default operator order (paper Figure 2) ===")
    print(profile.usage_table(g, default))
    print("\n=== optimal operator order (paper Figure 3) ===")
    print(profile.usage_table(g, optimal.schedule))
    print()
    print(profile.compare(g, default, optimal.schedule))

    # ---- 2. the same idea on a PyTorch program -------------------------
    def branchy(x):
        t = torch.tanh(x)                      # tensor with two consumers
        heavy = torch.tanh(t @ t.T).sum(dim=1)   # fat branch
        light = t.sum(dim=1)                     # thin branch
        return heavy + light

    reports = []
    y = reorder(branchy, report_to=reports)(
        torch.ones((512, 512), device=device))
    print(f"\n=== torch.fx operator reordering ({device}) ===")
    print(reports[0])
    print("output checksum:", float(y.sum()))


if __name__ == "__main__":
    main()
