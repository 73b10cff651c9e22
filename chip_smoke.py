#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's main path — MobileNet-v1 α=1.0 @ 192×192, random weights
from a fixed seed, post-training int8 quantization, then
``repro_torch.deploy.build`` (schedule → plan → validate → compile) and
``Deployment.run``/``serve`` — at three arena budgets: none (reorder only,
884 736 B), 512 KB (Pex, 322 560 B) and 224 KB (2-D tiled cascade,
221 696 B).  Before that it builds the Hopper kernels K1–K3 from
``src/repro_torch/kernels/conv_quant/csrc`` with ``nvcc`` and holds each
against its plain PyTorch version on the card, bit for bit, at every
distinct launch configuration of the main path plus hostile shapes, and
times it there.  On the main path it resets the kernels' launch counts,
and fails unless every kernel was launched; each card output must equal
the port's plain CPU path on the same schedule and plan, bit for bit.

It imports only ``repro_torch``, torch and numpy.  Any failed check
raises (exit code 1); without CUDA, or without the repository around it,
it exits 2 before printing any result.  The line before the last is
``nvidia-smi``'s name and power limit, the line before that the
``{"kernels": [...]}`` summary, the last ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KB = 1024
MODEL = (1.0, 192)                  # MobileNet-v1 alpha, resolution
# arena budgets and the bytes each must plan to (the repo's goldens)
BUDGETS = ((None, 884736), (512 * KB, 322560), (224 * KB, 221696))
DEVICE = "cuda:0"
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
# What each kernel replaces: the TPU kernel's function, file:line
REPLACES = {
    "qconv1x1": "src/repro/kernels/conv_quant/kernel.py:103",
    "qdwconv": "src/repro/kernels/conv_quant/kernel.py:349",
    "qconv": "src/repro/kernels/conv_quant/kernel.py:299",
}
# test_torch_qconv.py's hostile shapes: odd H/W, 1-lane channels, stride
# 2, asymmetric pads (H, W, Cin, Cout, k, stride, hpad, wpad; Cout=0 for
# depthwise)
HOSTILE = [
    (12, 12, 8, 16, 1, 1, None, None), (11, 9, 4, 6, 3, 2, None, None),
    (7, 9, 1, 5, 3, 1, None, None), (10, 8, 3, 7, 3, 1, (0, 2), None),
    (9, 7, 5, 1, 3, 2, (2, 0), None), (8, 8, 3, 4, 5, 2, None, None),
    (10, 9, 3, 6, 3, 1, (1, 1), (0, 2)), (6, 7, 5, 4, 1, 1, (0, 0), (1, 0)),
    (11, 9, 8, 0, 3, 1, None, None), (12, 10, 6, 0, 3, 2, None, None),
    (9, 7, 1, 0, 3, 1, None, None), (10, 8, 5, 0, 3, 1, (2, 0), None),
    (10, 9, 6, 0, 3, 1, (1, 1), (2, 0)),
]
HOSTILE_QP = ((0.0123, 3, -5), (0.5, -2, 4))     # (mult, zp_in, zp_out)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events around the whole run (launch gaps included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(torch, fn, reps: int = 3):
    """Device busy time per call of ``fn`` (ms), summed over the CUDA
    activities ``torch.profiler`` records, with the top names by time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"\w+_kernel|Memcpy \w+|Memset", e.name)
            name = m.group(0) if m else e.name[:40]
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), top


class Checks:
    """The int8 conv kernels held against their plain versions: one
    launch configuration per key, inputs in strided two-lane views like
    the arena's (lanes ``pitch`` bytes apart, not a multiple of 4)."""

    def __init__(self, torch, np, device):
        from repro_torch.core.partition import same_pads
        from repro_torch.kernels.conv_quant import ops, ref
        self.torch, self.np, self.device = torch, np, device
        self.ops, self.ref, self.same_pads = ops, ref, same_pads
        self.rng = np.random.default_rng(0)
        self.configs = {}    # key -> (kernel, macs, bytes, qparams)
        self.mismatches = {k: 0 for k in ops.KERNEL_WRAPPERS}
        self.max_err = {k: 0 for k in ops.KERNEL_WRAPPERS}
        self.checked = {k: 0 for k in ops.KERNEL_WRAPPERS}

    def _pads(self, n, k, stride, pad):
        if pad is not None:
            return tuple(pad)
        _, beg, end = self.same_pads(n, k, stride)
        return beg, end

    def _lanes(self, shape, lanes=2):
        n = int(self.np.prod(shape))
        pitch = n + 37
        buf = self.torch.as_tensor(
            self.rng.integers(0, 256, (lanes, pitch), dtype=self.np.uint8),
            device=self.device)
        return buf[:, 5:5 + n].view(self.torch.int8).view(lanes, *shape)

    def _rand(self, shape):
        return self.torch.as_tensor(
            self.rng.integers(-128, 128, shape, dtype=self.np.int8),
            device=self.device)

    def case(self, tag, kind, h, w, cin, cout, k, stride, hpad, wpad,
             mult, zp_in, zp_out):
        """Route one configuration as ``qconv_fused``/``qdwconv_fused``
        do and compare the kernel with the plain version (once per
        ``tag`` and shape)."""
        hp = self._pads(h, k, stride, hpad)
        wp = self._pads(w, k, stride, wpad)
        oh = (h + hp[0] + hp[1] - k) // stride + 1
        ow = (w + wp[0] + wp[1] - k) // stride + 1
        key = (tag, kind, h, w, cin, cout, k, stride, hp, wp)
        if key in self.configs:
            return
        x = self._lanes((h, w, cin))
        qp = dict(mult=mult, zp_in=zp_in, zp_out=zp_out)
        if kind == "qdwconv":
            name, wt = "qdwconv", self._rand((k, k, cin))
            macs = oh * ow * cin * k * k
            out = self._lanes((oh, ow, cin))
            got = self.ops.qdwconv(x, wt, stride=stride, hpad=hp, wpad=wp,
                                   out=out, **qp)
            want = self.ref.qdwconv_ref(x, wt, stride=stride, hpad=hp,
                                        wpad=wp, **qp)
        elif k == 1 and stride == 1 and hp == (0, 0) and wp == (0, 0):
            name, wt = "qconv1x1", self._rand((cin, cout))
            macs = h * w * cin * cout
            out = self._lanes((oh, ow, cout))
            got = self.ops.qconv1x1(x, wt, out=out, **qp)
            want = self.ref.qconv1x1_ref(x, wt, **qp)
        else:
            name, wt = "qconv", self._rand((k, k, cin, cout))
            macs = oh * ow * cout * k * k * cin
            out = self._lanes((oh, ow, cout))
            got = self.ops.qconv(x, wt, stride=stride, hpad=hp, wpad=wp,
                                 out=out, **qp)
            want = self.ref.qconv_ref(x, wt, stride=stride, hpad=hp,
                                      wpad=wp, **qp)
        self.torch.cuda.synchronize()
        assert got is out
        diff = (got.to(self.torch.int32) - want.to(self.torch.int32)).abs()
        self.max_err[name] = max(self.max_err[name], int(diff.max()))
        self.mismatches[name] += int((diff != 0).sum())
        self.checked[name] += 1
        nbytes = x[0].numel() + wt.numel() + out[0].numel()
        self.configs[key] = (name, macs, nbytes, qp)

    def from_deployment(self, d):
        g = d.exec_graph
        for op in d.schedule:
            if op.kind not in ("qconv", "qdwconv"):
                continue
            a = op.attrs
            h, w, cin = g.tensors[op.inputs[0]].shape
            wq = a["weight_q"]
            self.case("main", op.kind, h, w, cin,
                      wq.shape[3] if op.kind == "qconv" else 0, wq.shape[0],
                      a["stride"], a.get("pex_pads"), a.get("pex_wpads"),
                      a["mult"], a["zp_in"], a["zp_out"])

    def hostile(self):
        for i, (mult, zi, zo) in enumerate(HOSTILE_QP):
            for (h, w, cin, cout, k, s, hp, wp) in HOSTILE:
                kind = "qdwconv" if cout == 0 else "qconv"
                self.case(f"hostile{i}", kind, h, w, cin, cout, k, s, hp,
                          wp, mult, zi, zo)

    def largest(self, name):
        keys = [k for k, v in self.configs.items()
                if v[0] == name and k[0] == "main"]
        return max(keys, key=lambda k: (self.configs[k][1],
                                        self.configs[k][2]))

    def timing(self, name, card):
        """kernel_ms, plain_ms, library_ms and the bound at the largest
        main-path configuration of kernel ``name``."""
        torch = self.torch
        key = self.largest(name)
        _, macs, nbytes, qp = self.configs[key]
        _, _, h, w, cin, cout, k, stride, hp, wp = key
        x = self._rand((1, h, w, cin))
        lib = None
        if name == "qconv1x1":
            wt = self._rand((cin, cout))
            out = torch.empty((1, h, w, cout), dtype=torch.int8,
                              device=self.device)
            run = lambda: self.ops.qconv1x1(x, wt, out=out, **qp)  # noqa
            plain = lambda: self.ref.qconv1x1_ref(x, wt, **qp)  # noqa
            a2 = x.reshape(h * w, cin)
            b2 = wt.t().contiguous().t()        # column-major operand
            lib = lambda: torch._int_mm(a2, b2)  # noqa: E731
        elif name == "qconv":
            wt = self._rand((k, k, cin, cout))
            run = lambda: self.ops.qconv(x, wt, stride=stride, hpad=hp,  # noqa
                                         wpad=wp, **qp)
            plain = lambda: self.ref.qconv_ref(x, wt, stride=stride,  # noqa
                                               hpad=hp, wpad=wp, **qp)
        else:
            wt = self._rand((k, k, cin))
            run = lambda: self.ops.qdwconv(x, wt, stride=stride, hpad=hp,  # noqa
                                           wpad=wp, **qp)
            plain = lambda: self.ref.qdwconv_ref(x, wt, stride=stride,  # noqa
                                                 hpad=hp, wpad=wp, **qp)
        kernel_ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=10, warmup=2)
        library_ms = None if lib is None else time_ms(torch, lib)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 2 * macs / H100_INT8_OPS_PER_S * 1e3
        shape = f"{h}x{w}x{cin}" + (f"->{cout}" if cout else "") + \
            f" k={k} s={stride} pads={hp}/{wp}"
        log(f"kernels {name}: {self.checked[name]} configs, "
            f"{self.mismatches[name]} mismatches, max_abs_err "
            f"{self.max_err[name]}; at {shape}: kernel_ms {kernel_ms:.5f}, "
            f"plain_ms {plain_ms:.5f}, library_ms "
            f"{'none' if library_ms is None else f'{library_ms:.5f}'}"
            f"{' (torch._int_mm, bare int8 product)' if lib else ''}, "
            f"bound_ms {max(t_bytes, t_ops):.7f} [{card}]")
        return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    shape=shape)


def main() -> int:
    t_all = time.perf_counter()
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script measures "
              "the card and has nothing to run without one",
              file=sys.stderr)
        return 2

    import repro_torch.deploy as deploy
    from repro_torch.graphs import mobilenet_v1_graph, random_input
    from repro_torch.kernels.conv_quant import build, ops
    from repro_torch.mcu.compile import compile_schedule

    # ------------------------------------------------------------ device
    t0 = time.perf_counter()
    card = nvidia_smi()
    device = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    log(f"phase device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()} "
        f"({time.perf_counter() - t0:.2f} s)")

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"phase build: nvcc sm_90a, one process per source in parallel: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f" -> {build.BUILD_DIR} ({time.perf_counter() - t0:.2f} s)")

    # --------------------------------------------------- schedule + plan
    deployments = []
    for budget, golden in BUDGETS:
        t0 = time.perf_counter()
        d = deploy.build(mobilenet_v1_graph(*MODEL), quantize=True,
                         arena_budget=budget, device=device)
        assert d.arena_bytes == golden, (budget, d.arena_bytes, golden)
        log(f"phase schedule budget={budget}: {d.schedule_result.method}, "
            f"arena {d.arena_bytes} B, {len(d.schedule)} ops "
            f"({time.perf_counter() - t0:.2f} s)")
        deployments.append((budget, d))

    # ------------------------------------- kernels vs plain, on the card
    t0 = time.perf_counter()
    checks = Checks(torch, np, device)
    for _, d in deployments:
        checks.from_deployment(d)
    n_main = len(checks.configs)
    checks.hostile()
    log(f"phase kernels-vs-plain: {n_main} main-path configs + "
        f"hostile shapes, checked per kernel {checks.checked}, mismatches "
        f"{checks.mismatches} ({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in checks.mismatches.values()), checks.mismatches
    timings = {name: checks.timing(name, card)
               for name in ops.KERNEL_WRAPPERS}

    # ------------------------------------------------------- main path
    for f in ops.KERNEL_WRAPPERS.values():
        f.launches = 0
    for i, (budget, d) in enumerate(deployments):
        t0 = time.perf_counter()
        g = d.graph
        x = random_input(g, seed=100 + i)
        before = {n: f.launches for n, f in ops.KERNEL_WRAPPERS.items()}
        out = d.run(x)
        per_inf = {n: f.launches - before[n]
                   for n, f in ops.KERNEL_WRAPPERS.items()}
        (name, val), = out.items()
        assert val.shape == tuple(g.tensors[name].shape), val.shape
        assert val.dtype == np.int8
        plain = compile_schedule(d.exec_graph, d.schedule, d.plan,
                                 device="cpu").run(x)
        np.testing.assert_array_equal(val, plain[name])
        runs = []
        for _ in range(10):
            t1 = time.perf_counter()
            d.run(x)
            runs.append((time.perf_counter() - t1) * 1e3)
        busy, top = device_time(torch, lambda: d.run(x))
        p50 = statistics.median(runs)
        reqs = [random_input(g, seed=s) for s in range(8)]
        eng = d.engine(micro_batch=4)
        served = eng.serve(reqs)
        assert eng.stats.dispatches == 2 and eng.stats.padded_lanes == 0
        for r, o in zip(reqs, served):
            np.testing.assert_array_equal(o[name], d.run(r)[name])
        log(f"phase main-path budget={budget}: "
            f"{d.schedule_result.method}, arena {d.arena_bytes} B, "
            f"launches/inference {per_inf}, card == cpu plain path, "
            f"serve 8 == one-shot; run p50 {p50:.3f} ms, serve "
            f"{eng.stats.requests_per_s:.2f} req/s (micro_batch 4); "
            f"device busy {busy:.3f} ms/run (profiler), idle share "
            f"{1 - busy / p50:.3f} of p50; top "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in top)
            + f" [{card}] ({time.perf_counter() - t0:.2f} s)")
    launches = {n: f.launches for n, f in ops.KERNEL_WRAPPERS.items()}
    assert all(v > 0 for v in launches.values()), launches

    src = "src/repro_torch/kernels/conv_quant/csrc/{}.cu"
    summary = {"kernels": [
        {"name": n, "route": "cuda", "source": src.format(n),
         "replaces": REPLACES[n], "launches": launches[n],
         "max_abs_err": checks.max_err[n], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        for n, t in timings.items()]}
    log(f"total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps(summary))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
