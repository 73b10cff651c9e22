"""MCU deployment walk-through on the PyTorch port — the paper's headline
experiment.

Act 1: SwiftNet-Cell-like CNN on a simulated NUCLEO-F767ZI (512 KB SRAM,
≈200 KB framework overhead).  The deployment is int8, as on the real
device: the float model is post-training-quantized, then with the default
operator order it does NOT fit the remaining budget; after reordering it
does.  Numerics are verified bit-identical across schedules, and the
defragmenting dynamic allocator's overhead is reported.  For contrast,
the f32 build's 4x working sets are printed too.

Act 2: the 256 KB stretch deployment — MobileNet-1.0@192 int8 on a
256 KB-SRAM part.  Reordering alone needs 864 KB and whole-externals
partial execution floors at ~315 KB; `schedule(arena_budget=256 KB)`
escalates to cascaded Pex streaming (ring-buffer inter-segment execution,
DESIGN.md §7) and lands a 243 KB arena.  Planned on
the byte-exact scheduling graph here to keep the demo fast;
tests/test_torch_cascade.py pins the executable bit-identity of the same
kind of deployment through the compiled byte-arena executor.

The interpreter and the compiled arena program run on ``--device``: the
card by default (the int8 convolutions on the port's Hopper kernels),
``cpu`` for the plain PyTorch path.

    PYTHONPATH=src python examples_torch/mcu_deploy.py               # card
    PYTHONPATH=src python examples_torch/mcu_deploy.py --device cpu
"""
import argparse

import numpy as np

import repro_torch.deploy as deploy
from repro_torch.core import ArenaPlanner, schedule, static_plan_size
from repro_torch.device import resolve_device
from repro_torch.graphs import (int8_scheduling_graph, mobilenet_v1_graph,
                                quantize_graph, random_input,
                                swiftnet_cell_graph)
from repro_torch.graphs.cnn_ops import model_weight_bytes
from repro_torch.mcu import MicroInterpreter

SRAM = 512 * 1024
OVERHEAD = 200 * 1024
SRAM_SMALL = 256 * 1024


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the int8 network runs (default: the card; "
                         "'cpu' for the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    f = swiftnet_cell_graph()
    qm = quantize_graph(f, random_input(f), device=device)
    g = qm.graph
    print(f"model: {len(g.operators)} operators, "
          f"{model_weight_bytes(g) / 1024:.0f} KB int8 parameters "
          f"(NOR-flash; f32 would be "
          f"{model_weight_bytes(f) / 1024:.0f} KB), running on {device}")

    default = g.default_schedule()
    best = schedule(g)
    d_peak = g.peak_usage(default)
    print(f"\npeak SRAM, default order : {d_peak / 1024:7.1f} KB (int8)")
    print(f"peak SRAM, optimal order : {best.peak / 1024:7.1f} KB "
          f"({best.method})")
    print(f"saving                   : {(d_peak - best.peak) / 1024:7.1f} KB")
    print(f"f32 default order        : "
          f"{f.peak_usage(f.default_schedule()) / 1024:7.1f} KB (4x)")
    budget = SRAM - OVERHEAD
    print(f"\nSRAM budget (512 KB - 200 KB overhead): {budget / 1024:.0f} KB")
    print(f"  default order fits: {d_peak <= budget}")
    print(f"  optimal order fits: {best.peak <= budget}")

    x = qm.quantize_inputs(random_input(f))
    interp = MicroInterpreter(g, capacity=budget, device=device)
    rep = interp.run(x, schedule=best.schedule)
    print("\nmicro-interpreter run (optimal order):")
    print(f"  peak arena     : {rep.peak_sram / 1024:.1f} KB")
    print(f"  defrag traffic : {rep.bytes_moved / 1024:.0f} KB over "
          f"{rep.defrag_passes} passes")

    out_opt = rep.outputs
    rep_d = MicroInterpreter(g, device=device).run(x, schedule=default)
    same = all(np.array_equal(out_opt[o], rep_d.outputs[o])
               for o in g.outputs)
    print(f"  outputs identical across schedules: {same}")

    # the deploy facade runs the same schedule -> plan -> validate ->
    # compile chain in one call and hands back a runnable Deployment
    dep = deploy.build(g, device=device)
    out_c = dep.run(x)
    same = all(np.array_equal(out_opt[o], out_c[o]) for o in g.outputs)
    print(f"\noffline arena plan (paper §6): "
          f"{dep.arena_bytes / 1024:.1f} KB"
          f"  (static all-resident: {static_plan_size(g) / 1024:.0f} KB)")
    print(f"  repro_torch.deploy.build(g).run(x) bit-identical: {same}")
    print(f"  deployment stats: {dep.stats.as_json()}")

    # ---- Act 2: 256 KB part via cascaded Pex streaming -----------------
    print("\n=== MobileNet-1.0@192 int8 on a 256 KB-SRAM part ===")
    q = int8_scheduling_graph(mobilenet_v1_graph(alpha=1.0, resolution=192))
    base = schedule(q)
    print(f"best reordering alone     : {base.peak / 1024:7.1f} KB "
          f"(does not fit)")
    res = schedule(q, arena_budget=SRAM_SMALL)
    gq = res.graph if res.graph is not None else q
    plan = ArenaPlanner.plan(gq, res.schedule)
    ArenaPlanner.validate(plan, gq)
    print(f"{res.method:26s}: {res.peak / 1024:7.1f} KB "
          f"(arena plan {plan.arena_size / 1024:.1f} KB)")
    print(f"  fits 256 KB: {plan.arena_size <= SRAM_SMALL}   "
          f"halo-recompute overhead = {res.extra_macs_frac:.1%} extra MACs"
          f" (whole-graph)")
    print("  (ring-buffer streaming of the high-resolution front: no "
          "inter-segment\n   tensor ever exists whole — DESIGN.md §7; "
          "executable bit-identity is\n   pinned in tests/test_torch_cascade.py)")


if __name__ == "__main__":
    main()
