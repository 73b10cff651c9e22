#!/usr/bin/env python3
"""Check and time the kernels of one checkout's PyTorch/CUDA port.

    python3 tools/kernel_times.py [--src DIR] [--splits 1,2,4,8] [--lanes N]
                                  [--ppt 4,2,1]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so that an older commit's kernels, unpacked
with ``git archive``, are measured by the same code in the same call as
the newer ones (run them in turns: old, new, new, old).  With
``chip_smoke.py``'s checks and timers it builds that package's kernels,
plans the reorder-only int8 MobileNet-1.0@192 and then:

* holds K1–K5 against their plain versions (bit-exact) at every int8
  conv of that schedule, each also as the fused conv -> add;
* plans the 512 KB (Pex) and 224 KB (2-D tiled cascade) int8 schedules
  too, and the int8 SwiftNet cell's, and times K2 and K3 (K3's shapes
  also as K5) at every distinct K2/K3 shape of the four, event and device
  times beside the bound and
  each shape's launches per inference (``Checks.conv_shapes``;
  ``--ppt`` adds K2's device time with its tile forced to that many
  pixels a thread, the measurement behind ``ops.DW_BLOCKS_PER_SM``), then
  runs
  each of the three paths once more for its launches, run p50, device
  busy time, the kernels' and device-to-device copies' shares of it and
  the ring windows gathered (``chip_smoke.path_profile``);
* times K1 at every distinct pointwise shape of the schedule against
  ``torch._int_mm``, event and device times (``Checks.k1_shapes``;
  ``--splits`` adds K1's device time with Cin forced into that many
  chunks, the measurement behind ``ops.plan_split_k``'s thresholds), and
  K1 and K4 at their largest shape (``Checks.timing``);
* plans the reorder-only float32 MobileNet-1.0@192, holds K6 against its
  plain version (float32 bound) at its pointwise convs and times K6 at
  every distinct pointwise shape against ``torch.matmul`` (TF32 off),
  event and device times (``Checks.k6_shapes``; ``--splits`` adds K6's
  device time with each tile shape and Cin forced into that many chunks,
  the measurement behind ``conv_pointwise/ops.plan_split_k``; ``--lanes``
  times those shapes over that many lanes, as ``serve`` batches them), and
  at its largest shape (``Checks.timing``);
* holds K7 against its plain version and times it against
  ``F.scaled_dot_product_attention`` at the long mix's prefill (B 4, S
  1 024, 24/8 heads of 128, bf16, causal) and at the short mix's largest
  (the reference launcher's prompts in batches of 4);
* holds K8 against its plain version and times it against SDPA with a
  boolean mask at the long mix's last decode step (B 4, 2 048-row caches,
  1 039 valid rows, bf16, caches cold in L2; ``--splits`` adds K8 with
  that many blocks per (batch row, kv head), the measurement behind
  ``decode_attention/ops.plan_split``).

It prints ``chip_smoke.py``'s lines, ``ptxas -v``'s registers and spills
first and the card's name and power limit last; a failed check raises.
It exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--splits", default="",
                    help="comma-separated split counts to force on K1, K6 "
                         "and K8")
    ap.add_argument("--lanes", type=int, default=1,
                    help="lanes of K6's per-shape calls")
    ap.add_argument("--ppt", default="",
                    help="comma-separated pixels a thread to force on K2")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    import repro_torch.deploy as deploy
    from repro_torch.configs import get_config
    from repro_torch.graphs import mobilenet_v1_graph, swiftnet_cell_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_pointwise import ops as pw_ops
    from repro_torch.kernels.conv_quant import ops
    from repro_torch.launch import serve as launch_serve
    assert Path(repro_torch.__file__).resolve().is_relative_to(src)
    dev = torch.device(chip_smoke.DEVICE)
    card = chip_smoke.nvidia_smi()
    chip_smoke.log(f"kernel_times: {src} [{card}]")

    build.build_all()
    splits = [int(n) for n in args.splits.split(",") if n]
    for name in chip_smoke.PTXAS_KERNELS:
        chip_smoke.log(f"ptxas {name}: " + "; ".join(
            getattr(build, "PTXAS", {}).get(name, ["not reported"])))
    int8 = [(f"int8 budget={b}", deploy.build(
        mobilenet_v1_graph(*chip_smoke.MODEL), device=dev, quantize=True,
        arena_budget=b)) for b, _ in chip_smoke.BUDGETS]
    for (label, di), (_, golden) in zip(int8, chip_smoke.BUDGETS):
        assert di.arena_bytes == golden, (label, di.arena_bytes, golden)
    d = int8[0][1]
    swift = ("swiftnet int8", deploy.build(swiftnet_cell_graph(), device=dev,
                                           quantize=True))
    d32 = deploy.build(mobilenet_v1_graph(*chip_smoke.MODEL), device=dev,
                       arena_budget=None)
    checks = chip_smoke.Checks(torch, np, dev, {**ops.KERNEL_WRAPPERS,
                                                **pw_ops.KERNEL_WRAPPERS})
    checks.from_deployment(d)
    checks.from_deployment(d32)
    assert all(v == 0 for v in checks.mismatches.values()), checks.mismatches
    checks.conv_shapes(card, int8 + [swift],
                       [int(n) for n in args.ppt.split(",") if n])
    for i, (label, di) in enumerate(int8):
        chip_smoke.path_profile(torch, label, di, 100 + i,
                                ops.KERNEL_WRAPPERS, card)
    checks.k1_shapes(card, d, splits)
    checks.k6_shapes(card, d32, splits, args.lanes)
    for name in ("qconv1x1", "qconv1x1_add", "conv1x1"):
        checks.timing(name, card)

    cfg = get_config(chip_smoke.LLM_ARCH)
    short = max(len(r.prompt) for r in launch_serve.make_requests(cfg, 8, 12))
    attn = chip_smoke.AttentionChecks(torch, np, dev)
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    for label, S in (("long mix's prefill", 1024),
                     ("short mix's largest prefill", short)):
        attn.k7(4, S, S, H, K, D, torch.bfloat16, True)
        attn.timing("flash_attention", card, label=label, config=(
            (4, S, H, D), (4, S, K, D), torch.bfloat16, True))
    lengths = torch.full((4,), 1039, dtype=torch.int32)
    long_step = ((4, H, D), (4, 2048, K, D), torch.bfloat16, lengths)
    attn.k8(4, 2048, H, K, D, torch.bfloat16, tuple(lengths.tolist()))
    attn.timing("decode_attention", card, config=long_step,
                label="long mix's last decode step")
    attn.k8_splits(card, long_step, splits)
    assert all(v == 0 for v in attn.mismatches.values()), attn.mismatches
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
