"""Multi-pod dry-run: ``src/repro/launch/dryrun.py`` on PyTorch.  Every
(architecture × input shape) runs once on the production mesh without a
device and reports its per-device memory, FLOPs, bytes and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch <id>] [--shape <name>] [--mesh single|multi|both] \\
        [--out benchmarks/results/dryrun_torch] [--no-unroll] \\
        [--variant cp|zero1|kvheads]

Where the reference lowers and compiles each step for 256 / 512 forced
host devices, the port runs it as one rank of a fake process group of
that size (``launch.mesh.start_fake_world``) under ``FakeTensorMode``:
DTensors whose pieces are fake tensors of each rank's shape, collectives
that return at once.  No tensor of full size is ever made.

``LocalCost`` counts what one rank does, one dispatched op at a time
below DTensor (an op on DTensors it hands on, and counts the local ops
DTensor turns it into):

* FLOPs: ``torch.utils.flop_counter``'s formulas on the local shapes (a
  ``FlopCounterMode`` above DTensor would count the global product);
* bytes accessed: the bytes of every local op's tensor inputs and
  outputs, views excepted.  This is not XLA's post-fusion count: each
  elementwise op reads and writes its operands in full, where XLA fuses
  chains of them into one pass, so the port's bytes are an upper bound
  of the reference's kind of number;
* collectives: a census of the functional collectives (kind, result
  bytes, group size), priced by ``analysis.roofline.
  collective_bytes_from_census`` as the reference prices its HLO;
* memory: the local bytes of the step's arguments and outputs, and as
  ``temp`` the peak of the live local bytes the step's ops created
  (a result is live until it is freed); ``peak_memory_in_bytes`` is
  derived from them as the reference derives it when jaxlib lacks it.

Each combo writes one JSON with the reference's keys (``roofline`` for
``TPU_V5E``, as the reference's) and ``roofline_h100`` for the port's
card.  As in the reference, the analysis pass runs with
``models.runtime.UNROLL_SCANS = True`` (the decode step's per-layer
loop) and fewer, larger chunk steps; where it fails the rolled counts
stand (``analysis_mode`` "scan").  A failure of any combo exits
non-zero with the list of failures.  Run one process per mesh kind: a
process starts one fake world.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

VARIANTS = {
    "": {},
    "cp": {"act_shard": "cp"},          # context-parallel prefill
    "zero1": {"moe_fsdp": False},       # ZeRO-1 expert weights
    "kvheads": {"kv_mode": "heads"},    # naive replicated-KV baseline
}
WORLD = {"single": 256, "multi": 512}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCost(TorchDispatchMode):
    """One rank's FLOPs, bytes, collective census and live-byte peak over
    the ops dispatched while it is active (see the module docstring).
    DTensor computes each op's global output shape by running it on fake
    tensors of the global shapes; those runs are not the rank's work and
    are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.census: List[Tuple[str, int, int]] = []
        self.live = self.peak = 0
        self._meta_depth = 0
        self._patched = None

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        cost = self

        def meta(prop, schema):
            cost._meta_depth += 1
            try:
                return orig(prop, schema)
            finally:
                cost._meta_depth -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        self._patched = (ShardingPropagator, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._patched
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat = pytree.tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._meta_depth:
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name != "wait_tensor":
            self.census.append(self._collective(name, args, out))
        if func.is_view or name in ("detach", "alias"):
            return out
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        ids = {id(a) for a in ins}
        for o in outs:      # in-place results are their inputs: not new
            if id(o) in ids:
                continue
            n = _nbytes(o)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(o, self._free, n)
        return out

    @staticmethod
    def _collective(name, args, out) -> Tuple[str, int, int]:
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        group = args[-1]
        pg = group if not isinstance(group, str) \
            else _resolve_process_group(group)
        return name, _nbytes(out), pg.size()


def _tree_bytes(tree) -> int:
    from repro_torch.models.sharding import local
    return sum(_nbytes(local(t)) for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _step(arch: str, shape_name: str, mesh, overrides):
    """(cfg, kind, tokens, run): ``run()`` builds the combo's sharded
    inputs (fake) and returns (argument tree, step function); the
    reference's ``lower_combo``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import (SHAPES, batch_specs,
                                           config_for_shape)
    from repro_torch.models import runtime
    from repro_torch.models.model import Model, init_cache, init_params
    from repro_torch.models.sharding import P, distribute
    from repro_torch.models.model import _dp_for
    shape = SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    if runtime.UNROLL_SCANS:
        # fewer, larger chunk steps: the same FLOPs in fewer loop bodies
        cfg = cfg.replace(attn_chunk=min(4096, shape.seq_len),
                          ssm_chunk=min(4096, shape.seq_len))
    model = Model(cfg, mesh)
    dev = "cpu"

    def batch(B):
        dp = _dp_for(mesh, B)
        return {k: distribute(torch.zeros(v.shape, dtype=v.dtype), mesh,
                              P(dp))
                for k, v in batch_specs(cfg, shape).items()}

    if shape.kind == "train":
        from repro_torch.training import make_train_step, train_state_init

        def run():
            state = train_state_init(cfg, None, dev, mesh=mesh)
            step = make_train_step(model, remat=True)
            b = {k: v for k, v in batch(shape.global_batch).items()}
            return (state, b), lambda: step(state, b)
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        def run():
            params = init_params(cfg, None, dev, mesh=mesh)
            b = batch(shape.global_batch)
            return (params, b), lambda: model.prefill(
                params, b, cache_len=shape.seq_len)
        tokens = shape.global_batch * shape.seq_len
    else:
        def run():
            params = init_params(cfg, None, dev, mesh=mesh)
            cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                               device=dev, mesh=mesh)
            tok = torch.zeros((shape.global_batch,), dtype=torch.int64)
            return (params, cache, tok), lambda: model.decode_step(
                params, cache, tok, traced=not runtime.UNROLL_SCANS)
        tokens = shape.global_batch
    return cfg, shape.kind, tokens, run


def measure(arch: str, shape_name: str, mesh, overrides=None
            ) -> Tuple[Any, Dict[str, Any]]:
    """One fake run of the combo: (cfg, counts) with the setup and run
    seconds, the argument and output bytes and ``LocalCost``'s counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        cfg, kind, tokens, run = _step(arch, shape_name, mesh, overrides)
        args, fn = run()
        t1 = time.perf_counter()
        with LocalCost() as cost:
            out = fn()
        t2 = time.perf_counter()
        counts = {"setup_s": t1 - t0, "run_s": t2 - t1,
                  "argument_size_in_bytes": _tree_bytes(args),
                  "output_size_in_bytes": _tree_bytes(out),
                  "temp_size_in_bytes": cost.peak, "flops": cost.flops,
                  "bytes": cost.bytes, "census": cost.census,
                  "kind": kind, "tokens": tokens}
        del out, args, fn
    return cfg, counts


def run_combo(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
              keep_hlo: bool = False, analysis_unroll: bool = True,
              variant: str = "") -> Dict[str, Any]:
    """The reference's ``run_combo``: the rolled run (memory), the
    unrolled analysis run (counts), the roofline, one JSON."""
    from repro_torch.analysis.roofline import (H100, TPU_V5E,
                                               collective_bytes_from_census,
                                               model_flops, roofline_report)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import runtime
    overrides = VARIANTS[variant]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="cpu")
    chips = mesh.size()
    runtime.UNROLL_SCANS = False
    cfg, rolled = measure(arch, shape_name, mesh, overrides)
    mem = {k: rolled[k] for k in ("argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes")}
    mem["alias_size_in_bytes"] = 0
    mem["peak_memory_in_bytes"] = max(
        0, mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    mem["peak_memory_is_derived"] = 1
    analysis_mode, counts = "scan", rolled
    if analysis_unroll:
        try:
            runtime.UNROLL_SCANS = True
            _, counts = measure(arch, shape_name, mesh, overrides)
            analysis_mode = "unrolled"
        except Exception as e:          # fall back to rolled numbers
            print(f"  (unrolled analysis failed: {e!r} - using scan counts)")
            counts = rolled
        finally:
            runtime.UNROLL_SCANS = False
    coll = collective_bytes_from_census(counts["census"])
    mf = model_flops(cfg, rolled["kind"], rolled["tokens"])
    terms = dict(flops=float(counts["flops"]),
                 bytes_accessed=float(counts["bytes"]),
                 collective_bytes=coll["total"], model_flops_global=mf,
                 chips=chips)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips,
        "lower_s": round(rolled["setup_s"], 2),
        "compile_s": round(rolled["run_s"], 2),
        "memory_analysis": mem,
        "flops_per_device": float(counts["flops"]),
        "bytes_per_device": float(counts["bytes"]),
        "collectives": coll,
        "model_flops_global": mf,
        "roofline": roofline_report(**terms, hw=TPU_V5E),
        "roofline_h100": roofline_report(**terms, hw=H100),
        "sliding_window": cfg.sliding_window,
        "analysis_mode": analysis_mode,
        "variant": variant,
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    fname = os.path.join(out_dir,
                         f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    if keep_hlo:        # the census stands where the reference's HLO does
        with open(fname.replace(".json", ".census.json"), "w") as f:
            json.dump(counts["census"], f)
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.mesh import start_fake_world
    from repro_torch.launch.shapes import SHAPES, shape_applicable
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="single arch id (default all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="also write each combo's collective census")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-unroll", action="store_true",
                    help="skip the unrolled analysis pass (the rolled "
                         "counts stand)")
    ap.add_argument("--variant", default="", choices=list(VARIANTS),
                    help="sharding variant for A/B runs")
    args = ap.parse_args(argv)

    arches = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if len(meshes) > 1:     # one fake world a process
        import subprocess
        rest = argv if argv is not None else sys.argv[1:]
        rcs = [subprocess.run([sys.executable, "-m", __spec__.name, *rest,
                               "--mesh", mk]).returncode for mk in meshes]
        if any(rcs):
            sys.exit(1)
        return
    start_fake_world(WORLD[meshes[0]])

    failures = []
    for arch in arches:
        for shape in shapes:
            if not shape_applicable(get_config(arch), shape):
                print(f"SKIP  {arch} x {shape} (documented inapplicable)")
                continue
            for mk in meshes:
                suffix = f"__{args.variant}" if args.variant else ""
                fname = os.path.join(args.out,
                                     f"{arch}__{shape}__{mk}{suffix}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"SKIP  {arch} x {shape} x {mk} (exists)")
                    continue
                try:
                    rec = run_combo(arch, shape, mk, args.out,
                                    keep_hlo=args.keep_hlo,
                                    analysis_unroll=not args.no_unroll,
                                    variant=args.variant)
                    r = rec["roofline"]
                    print(f"OK    {arch:24s} {shape:12s} {mk:6s} "
                          f"run={rec['compile_s']:6.1f}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"dom={r['dominant']:12s} "
                          f"bound={r['step_time_lb_s']*1e3:8.2f}ms "
                          f"({rec['analysis_mode']})", flush=True)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mk, repr(e)))
                    print(f"FAIL  {arch} x {shape} x {mk}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall combos ran OK")


if __name__ == "__main__":
    main()
