"""Serve an int8 MobileNet on the card with and without guard bytes
through ``ShardedServingEngine`` and hold the answers equal.

    python3 tools/guard_serve_check.py [--requests N] [--lanes L]

from the root of a checkout.  A guard-byte plan stages its lanes as every
plan does, its canaries filled inside the captured graph.  The graph is
MobileNet-v1 0.25@96, quantized once; both deployments are built from
the same int8 graph, so they hold the same weights and qparams (the
figure-1 int8 graph runs its operators' host code, which a CUDA graph
cannot hold).  The script serves the same requests (a ragged last
dispatch) through both deployments, then zeroes the guard-byte
program's arena on the host and
serves once more: the host writes no lane, so every lane's canaries after
that replay, pad lanes too, were filled by the graph.  It checks that the
graph was captured once and replayed, that every canary holds, and that
every answer is bit-identical to the guard-less deployment's.  The last
line is a JSON object with the card's name and power limit.  Exits 2
without CUDA, 1 on a failed check.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT / "src"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=7)
    ap.add_argument("--lanes", type=int, default=4)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("guard_serve_check: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.deploy as deploy
    from repro_torch.graphs import mobilenet_v1_graph, random_input
    from repro_torch.serving import ShardedServingEngine

    plain = deploy.build(mobilenet_v1_graph(0.25, 96), quantize=True,
                         device="cuda")
    guarded = deploy.build(plain.qmodel.graph, guard_bytes=16,
                           device="cuda")
    ex = guarded.executor
    reqs = [random_input(plain.exec_graph, seed=s)
            for s in range(args.requests)]
    want = ShardedServingEngine(plain, replicas=1,
                                lanes=args.lanes).serve(reqs)
    eng = ShardedServingEngine(guarded, replicas=1, lanes=args.lanes)
    got = [eng.serve(reqs)]
    prog = ex.batched_fn(args.lanes)
    prog.arena.zero_()
    replays = ex.counters["replays"]
    got.append(eng.serve(reqs))
    torch.cuda.synchronize()
    ex.verify_guards(prog.arena)        # every lane; raises GuardViolation
    checks = {
        "captured_once": ex.counters["captures"] == 1,
        "replayed": ex.counters["replays"] - replays
        == -(-args.requests // args.lanes),
        "guard_regions": len(ex.guard_regions) > 0,
        "same_schedule": [op.name for op in plain.schedule]
        == [op.name for op in guarded.schedule],
        "answers_bit_identical": all(
            np.array_equal(o[name], w[name])
            for outs in got for o, w in zip(outs, want) for name in w),
    }
    print(json.dumps({
        "ok": all(checks.values()), "checks": checks,
        "requests": args.requests, "lanes": args.lanes,
        "guard_regions": len(ex.guard_regions),
        "guard_bytes": sum(size for _, size in ex.guard_regions),
        "arena_bytes": [plain.arena_bytes, guarded.arena_bytes],
        "card": card()}), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
