"""The readings a cell's limits are set from (``PERF.md``), in one process:
the numbers that decide ``correct`` for sound runs of the program on many
seeds, and for the control on a few.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        --seconds 2 --control-seeds 101,102,103 [--out FILE]

A program reading is a run of the cell as ``run.py`` makes it, with a
short window at the cell's own load.  The control is the reference at
4 bits (every activation and weight but the output tensor), the step below
the configuration's int8, put in the program's place: its answers for
every image of the pool and its quantization parameters are judged as the
program's are.  The benchmark's own runs never run it.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
for _p in (CHECKOUT / "src", CHECKOUT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def control_checks(cell, seed: int, device, bits: int = 4):
    """The judge's numbers with the reference at ``bits`` in the
    program's place, at the cell's own size, over the whole pool."""
    import numpy as np
    from portbench.harness import inputs, judge, spec
    cfg = cell.config
    ref = spec.load_module("reference", cfg["reference"])
    net = ref.layers(cfg["alpha"], cfg["resolution"], cfg["num_classes"])
    made = inputs.make(seed, [layer.weight_shape for layer in net],
                       [ref.he_std(layer) for layer in net],
                       int(cell.traffic["pool"]), cfg["resolution"], device)
    ranges = ref.calibrate(made.images[:int(cfg["calibration_images"])],
                           net, made.weights)
    want = ref.quantize(net, made.weights, ranges, bits=8)
    low = ref.quantize(net, made.weights, ranges, bits=bits)
    reference = ref.outputs(made.images, want).cpu().numpy()
    answers = ref.outputs(made.images, low).cpu().numpy()
    return judge.checks(
        answers=answers, images=np.arange(answers.shape[0]), unanswered=0,
        reference=reference,
        program_q=[(q.scale, q.zero_point) for q in low.act],
        reference_q=[(q.scale, q.zero_point) for q in want.act],
        arena_bytes=0, budget=0, lane_bytes=0, limits=cfg["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import spec
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.find_cell(args.workload, spec.load_spec())
    system = spec.load_module("systems", cell.config["system"])
    rows = []
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            if kind == "program":
                rec = system.run(cell, seed, args.seconds, False, device,
                                 time.perf_counter())
                checks = rec.checks
                extra = {"setup_s": rec.setup_s, "attempted": rec.attempted}
            else:
                checks = control_checks(cell, seed, device)
                extra = {}
            row = {"kind": kind, "seed": seed,
                   **{c.name: c.value for c in checks}, **extra,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print("reading " + json.dumps(row), flush=True)
    for kind in ("program", "control"):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            names = [k for k in got[0] if k not in ("kind", "seed")]
            print(f"{kind} over {len(got)} seeds: " + ", ".join(
                f"{n} max {max(r[n] for r in got)!r} min "
                f"{min(r[n] for r in got)!r}" for n in names), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "card": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
