"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run whose last stretch
is profiled.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit); the last lines of standard error are the same checks.
Without CUDA, or with fewer cards than the cell asks for, it prints no
result and exits 2.  It exits 3, with no result, when the process has
loaded JAX or the JAX package.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, few threads: the host's share of the work is run by this
# thread, and idle pools would only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

CHECKOUT = Path(__file__).resolve().parents[1]
for _p in (CHECKOUT / "src", CHECKOUT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# top-level module names this process must never hold: the reference
# package the port was made from, and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def result(rec, cell, trace: bool, chips: int) -> dict:
    """The result line's object: the cell's metrics for this kind of run,
    read by their readers; a reader that finds nothing is left out."""
    from portbench.harness import spec
    out = {"correct": all(c.ok for c in rec.checks),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": {}}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m.name).read(rec)
        if value is not None:
            out["metrics"][m.name] = {"value": value, "unit": m.unit}
    device = {"platform": "gpu", "kind": rec.device_kind, "count": chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
    out["device"] = device
    if trace and rec.trace is not None:
        ops = sorted(((n, s) for n, (_, s) in rec.trace.by_name.items()),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(rec.trace.idle_by_host.items(),
                      key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                            "idle_gaps": [[n, s] for n, s in gaps]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in rec.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        import torch

        torch.set_num_threads(1)
        from portbench.harness import spec
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        return _fail(f"cannot import what the benchmark runs: {e}", 2)
    bench = spec.load_spec()
    cell = spec.find_cell(args.workload, bench)
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs on the card only", 2)
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} visible", 2)

    system = spec.load_module("systems", cell.config["system"])
    rec = system.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_PROCESS)

    loaded = forbidden_modules()
    if loaded:
        return _fail(f"the process holds {loaded}: the benchmark measures "
                     f"the port alone", 3)
    out = result(rec, cell, bool(args.trace), cell.chips)
    for note in rec.notes:
        print(f"note {note}", file=sys.stderr)
    for c in rec.checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
