#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Builds the eight Hopper kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (one process per source, all at once) — the int8 convs
K1–K3, the fused conv→add kernels K4/K5, the float32 pointwise conv K6,
flash attention K7 and decode attention K8 — and holds each against its
plain PyTorch version on the card, at every distinct launch configuration
of the paths below plus hostile shapes (the split-K edges of K1/K4, K6
and K8 among them; K2/K3/K5 reading cascade ring windows in place, at
the 224 KB schedule's windows and at hostile ones), and times it there
(K1 and K6 at every distinct pointwise shape of the reorder-only int8 and
float32 schedules, K2/K3/K5 at every depthwise and k×k shape of the int8
MobileNet and SwiftNet schedules, K7 at the largest prefill of each LLM
mix, K8 at the largest decode step).  Integer kernels must be bit-exact;
K6 must stay within the worst-case float32 dot-product error bound (see
``F32_BOUND``); K7/K8 within ``F32_ATTN`` of max|want| in float32 and one
bf16 ulp in bf16.  The build phase prints ``ptxas -v``'s registers and
spills of all eight kernels.

Then it drives the port's paths, random weights from fixed seeds, each
with every kernel's launch count set to 0 just before it and read just
after (the launches of the kernel checks above do not count):

* MobileNet-v1 α=1.0 @ 192×192 int8 through ``repro_torch.deploy.build``
  and ``Deployment.run``/``serve`` at three arena budgets: none (reorder
  only, 884 736 B), 512 KB (Pex, 322 560 B), 224 KB (2-D tiled cascade,
  221 696 B) — K1–K3, bit-exact against the port's plain CPU path; each
  path's line gives device-to-device copies per run and the ring windows
  gathered (none at 224 KB: K2 reads all 312 where they lie);
* the same network in float32 at none / 2 MB / 1 MB (3 538 944 /
  1 290 240 / 995 328 B): K6 launched once per k=1, stride-1 conv of the
  schedule (13 / 79 / 200), outputs within ``F32_TOL`` of the CPU path;
  each path's line gives its kernels' profiler shares of the busy time;
* the SwiftNet cell of the paper's Table 1, float32 (1 253 376 B, 17 K6
  launches) and int8 (313 344 B, K1–K3), reorder only;
* Table 1 itself: ``MicroInterpreter`` on the card runs the int8 SwiftNet
  cell in 512 KB − 200 KB = 319 488 B of SRAM only in the reordered order
  (313 344 B peak, 1 550 978 B moved, 36 defrag passes; the default order
  raises ``MemoryError`` and needs 368 640 B), with outputs equal to the
  compiled executor's;
* the public entry point ``kernels.qconv_add_fused`` (K4/K5) at every int8
  conv shape of the SwiftNet and reorder-only MobileNet schedules with a
  seeded residual, bit-exact against ``qconv_fused`` then ``qadd``;
* LLM serving of Llama-3.2-3B at full width and depth (28 layers, bf16,
  random weights drawn on the card) through ``repro_torch.launch.serve``'s
  ``ServingEngine``: the reference launcher's traffic (8 prompts of 4–23
  tokens, 12 new tokens, ``max_batch`` 4, ``cache_len`` 96) and long
  prompts (4 × 1024 tokens, 16 new, ``cache_len`` 2048) — K7 28× per
  prefill, K8 28× per decode step — with prefill/decode times, tokens/s,
  the device's busy time, K8's share of it and the KV-arena bytes;
  decoding token t after a prefill of t−1 against prefilling t tokens
  (``CONT_TOL``); a 2-layer variant on the card against the port's CPU
  path (``CPU_TOL``);
* ``phase llm-reorder``: the paper's reordering of Llama-3.2-3B's decode
  step, ``ServingEngine.analyse_decode_schedule(4)`` at cache 96 and
  2 048 (the layer stack one operator, ``repro_torch::decode_layers``;
  traced from shapes, so nothing is allocated on the card), with the host
  seconds of trace and schedule, then the reordered step against the
  eager ``decode_step`` after a prefill: logits and every cache tensor
  bit-equal, K8 28× through the reordered module;
* ``phase llm-moe``: the MoE decoder Granite-3.0-1B-A400M at full width
  and depth (24 layers, 32 experts top 8, bf16) through the launcher's
  engine with the short mix — K7 24× per prefill, K8 24× per decode step
  — with the same lines and ``phase graphs llm-moe`` as Llama's mixes;
  continuation and a 2-layer card vs CPU comparison in float32
  (``MOE_CONT_TOL``, ``MOE_CPU_TOL``: the routing's near-ties are why), and
  its reordered step as above at cache 96;
* ``phase llm-ssm``: the recurrent decoders at full width and depth, bf16,
  after the earlier models' weights are freed — Zamba2-2.7B (54 Mamba2
  layers in 9 groups, each closed by one weight-shared attention block of
  32 heads of 80) and then xLSTM-350M (4 groups of 5 mLSTM + 1 sLSTM) —
  each through the launcher's engine with the short mix (K7 9x per
  prefill and K8 9x per decode step for Zamba2, none for xLSTM; the
  state bytes a request plans, ``SSM_MIXES``), ``phase graphs
  llm-ssm-*``, the continuation at full depth and card vs CPU at two
  groups, both in float32 (``SSM_CONT_TOL``, ``SSM_CPU_TOL``), and the
  reordered step bit-equal to the eager one at cache 96.

``run``, ``serve`` and the decode step run as CUDA graphs (the compiled
forms ``CompiledExecutor.fn``/``batched_fn`` and ``ServingEngine``'s
``DecodeStep``); each is captured before its path's counts are zeroed,
and replays count their launches.  Counters of Python calls (ring windows
gathered) are read on the eager ``execute``.  ``phase graphs`` holds the
compiled forms against the eager program in the same process:

* each of the eight CNN deployments above: graphed outputs equal to
  ``execute``'s (int8 bit-exact, f32 within ``F32_TOL``) for two requests
  in a row through one graph and for a serve of 7 requests at
  ``micro_batch`` 4 (a ragged last batch); launches per inference through
  replays equal to eager's; capture ms; run p50 and serve requests/s,
  eager vs graphed; device busy per run and idle share of each — the
  profiler must see the port's kernels inside the replays, the graphed
  busy time within 10 % of eager's;
* both LLM mixes: served tokens of the captured engine equal to an eager
  loop of ``Model.decode_step`` driven by the phase; the captured step's
  logits within ``CONT_TOL`` of the eager step's (teacher-forced); decode
  ms/step and tokens/s eager vs graphed; the step replayed back to back;
  capture ms; busy and idle share of a serve of each — K8 seen inside the
  replays, busy within 10 % of eager's.

``phase sharded`` drives ``ShardedServingEngine(d, replicas=None,
lanes=4)`` (one replica per card: ``batched_fn(4)`` replayed on each)
over the three int8 deployments and the f32 one at no budget: 11
requests submitted up front, then the same 11 as late arrivals between
``step``s with mixed priorities; every output equal to ``Deployment.run``
of that request alone (int8 bit-exact, f32 within ``F32_TOL``), launches
per dispatch through the replays equal to the eager program's over 4
lanes; dispatches, padded lanes, requests/s and p50/p99 latency in turns
with ``GraphServingEngine``'s graphed serve at ``micro_batch`` 4; the
degradation path (a ``FaultPlan`` failing ``engine_init``: a note in
``stats.degraded``, the same outputs); ``replicas=2`` clipped to the
device count; one seeded chaos plan (``CHAOS_SEED``) with every request
a result or a typed ``RequestError`` and the counters balancing the
fault ledger.  ``phase fx`` runs the reference tests' branchy program and
MLP at the tests' sizes and at ``FX_ROWS`` rows on CUDA tensors through
``core.fx_reorder.reorder`` (bit-exact against eager torch) and
``reorder_graph_module(partition_budget=...)`` (a ``+pex`` program
within the float32 accumulation bound of its row-sliced mms,
``fx_pex_bound``; the count outside the reference test's ``FX_MM_TOL``
is printed), each report's peaks equal to ``peak_liveness`` of the
emitted module, with the host seconds of trace and schedule; tracing the
int8 arena program stops at its first kernel with ``TraceError``.

It imports only ``repro_torch``, torch and numpy.  Any failed check
raises (exit code 1); without CUDA, or without the repository around it,
it exits 2 before printing any result.  The line before the last is
``nvidia-smi``'s name and power limit, the line before that the
``{"kernels": [...]}`` summary, the last ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
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
# float32: (budget, arena bytes, k=1/stride-1 convs in the schedule)
F32_BUDGETS = ((None, 3538944, 13), (2048 * KB, 1290240, 79),
               (1024 * KB, 995328, 200))
SWIFT_F32, SWIFT_F32_K6, SWIFT_INT8 = 1253376, 17, 313344
ZERO_COPY_224 = 312     # ring windows the 224 KB int8 schedule never writes
TABLE1_CAPACITY = 512 * KB - 200 * KB   # NUCLEO-F767ZI SRAM less framework
# (peak_sram, bytes_moved, defrag_passes, steps) of the reference
TABLE1 = {"reordered": (313344, 1550978, 36, 36),
          "default": (368640, 1371266, 36, 36)}
# float32 network outputs, card vs the port's CPU path: sums in other
# orders (K6's fmaf chain, cuDNN, MKL) over ~30 layers
F32_TOL = dict(rtol=1e-4, atol_frac=1e-5)     # atol = atol_frac * max|cpu|
# K6 vs its plain version, per element: |got - want| <= F32_BOUND * (Cin
# + 2) * (sum_k |x_k w_k| + |b|) — twice the worst-case error of a float32
# dot product of Cin terms plus the bias add, for any summation order
F32_BOUND = 2 * 2.0 ** -24
DEVICE = "cuda:0"
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
H100_F32_OPS_PER_S = 67e12          # float32 without tensor cores
# What each kernel replaces: the TPU kernel's function, file:line
REPLACES = {
    "qconv1x1": "src/repro/kernels/conv_quant/kernel.py:103",
    "qdwconv": "src/repro/kernels/conv_quant/kernel.py:349",
    "qconv": "src/repro/kernels/conv_quant/kernel.py:299",
    "qconv1x1_add": "src/repro/kernels/conv_quant/kernel.py:148",
    "qconv_add": "src/repro/kernels/conv_quant/kernel.py:322",
    "conv1x1": "src/repro/kernels/conv_pointwise/kernel.py:44",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:70",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:64",
}
SOURCES = {n: f"src/repro_torch/kernels/conv_quant/csrc/{n}.cu"
           for n in REPLACES}
SOURCES["conv1x1"] = "src/repro_torch/kernels/conv_pointwise/csrc/conv1x1.cu"
for _n in ("flash_attention", "decode_attention"):
    SOURCES[_n] = f"src/repro_torch/kernels/{_n}/csrc/{_n}.cu"
ATTENTION = ("flash_attention", "decode_attention")
# the kernels whose `ptxas -v` registers and spills the build phase prints
PTXAS_KERNELS = ("qconv1x1", "qdwconv", "qconv", "qconv1x1_add",
                 "qconv_add", "conv1x1", "flash_attention",
                 "decode_attention")
H100_BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
# ---- the LLM serving phases: Llama-3.2-3B at full width and depth, bf16,
# random weights drawn on the card by the launcher (torch.Generator seed 0)
LLM_ARCH = "llama3.2-3b"
# (label, requests, prompt tokens (None: the reference launcher's 4-23),
# new tokens, max_batch, cache_len, the KV block bytes it must plan)
LLM_MIXES = (("short", 8, None, 12, 4, 96, 11_010_436),
             ("long", 4, 1024, 16, 4, 2048, 234_889_220))
# Decoding token t after a prefill of t-1 tokens against prefilling t
# tokens, at full depth in bf16: max |delta logit| <= CONT_TOL * max|logit|.
# Both paths round every activation to bf16 (2^-9 relative), but through
# other GEMM shapes (M = B*S vs B) and other attention kernels (K7 vs K8),
# so activations differ by about an ulp per layer; over 28 residual layers
# that is ~0.5 % of a logit's scale — 3e-2 leaves a 6x margin.
CONT_TOL, CONT_T = 3e-2, 64
# The same 2-layer model (full width, the first two layers' weights) on the
# card and on the port's CPU path, both bf16: the same one-ulp-per-layer
# argument over 2 layers instead of 28 gives ~0.1 %; 2e-2 * max|logit|.
CPU_TOL, CPU_LAYERS, CPU_S, CPU_STEPS = 2e-2, 2, 12, 3
# ---- the paper's reordering of the decode step (phase llm-reorder): the
# launcher's batch at both mixes' cache lengths
REORDER_B, REORDER_CACHES = 4, (96, 2048)
# ---- the MoE decoder (phase llm-moe): Granite-3.0-1B-A400M at full width
# and depth (24 layers, d 1024, 32 experts top 8, bf16, 2.77 GB), random
# weights drawn on the card by the launcher, the reference launcher's
# traffic as LLM_MIXES' short mix (KV block: 2*24*96*8*64*2 B + pos + kv_pos)
MOE_ARCH = "granite-moe-1b-a400m"
MOE_MIX = ("moe", 8, None, 12, 4, 96, 4_718_980)
# MoE routing picks each token's top 8 of 32 experts.  In bf16 the two
# paths of the continuation and card-vs-CPU checks differ by about an ulp
# (2^-9) per layer (see CONT_TOL), which moves a router logit by ~2e-3: at
# a near-tie between a token's 8th and 9th expert (spacing ~0.1 between
# neighbouring order statistics of 32 unit-normal logits) that flips the
# expert, for some % of (token, layer) pairs, and a flip swaps a whole
# expert's output.  So the MoE checks run the same weights in float32 (TF32
# off), where the paths differ by ~1e-6 per layer and a flip needs a gap
# 1e4 times smaller.  Continuation: the attention kernels' float32 bound
# F32_ATTN (2e-5 of max|want|) per layer over 24 layers is at most ~5e-4
# if every layer's error adds; 2e-3 * max|logit|.  The capacity factor is
# E/k there, so that no expert drops a token in either path (prefill t-1
# and t tokens, decode one: capacities 126, 128 and 2 rows for 126, 128
# and 2 tokens); at the configured 1.25 the prefill of t-1 and of t tokens
# would drop other tokens.  Card vs CPU keeps 1.25 (capacity drops on
# both sides): 2 layers, 1e-3 * max|logit|.
MOE_CONT_TOL, MOE_CPU_TOL = 2e-3, 1e-3
# ---- the recurrent decoders (phase llm-ssm), random weights drawn on the
# card by the launcher, the short mix as LLM_MIXES', with the bytes of a
# request's block: Zamba2-2.7B (bf16, 4.85 GB: 9 K/V layers of 32 heads of
# 80 at cache 96, conv windows and SSM states of 54 Mamba2 layers) and
# xLSTM-350M (bf16, 0.43 GB: recurrent states only)
SSM_MIXES = (("zamba2-2.7b", ("ssm-zamba", 8, None, 12, 4, 96, 81_326_980)),
             ("xlstm-350m", ("ssm-xlstm", 8, None, 12, 4, 96, 21_118_980)))
# Their float32 checks (TF32 off).  Continuation at full depth: the prefill
# of t tokens runs the chunked recurrence (intra-chunk products, the state
# carried between chunks) and K7, the step after a prefill of t-1 the
# stepped recurrence and K8; each sums in another order (~1e-7 relative per
# operation, the attention kernels within F32_ATTN = 2e-5 of max|want|),
# so a layer moves the residual stream by ~1e-6 of its scale, and 54
# (Zamba2) or 24 (xLSTM) layers add up to ~5e-5 if every error adds; the
# gates' exponentials (sLSTM's running max, the decays) amplify no more
# than the residual norms let them: 2e-3 * max|logit|.  Card vs CPU at two
# groups (12 layers): the same sums on cuBLAS against MKL, 1e-3.
SSM_CONT_TOL, SSM_CPU_TOL, SSM_CPU_LAYERS = 2e-3, 1e-3, 12
# K7/K8 against their plain versions.  float32: |got - want| <= F32_ATTN *
# max|want| (the JAX package's own kernel tests use 2e-5); bf16: within one
# bf16 ulp of want plus 1e-6 * max|want| — both compute in float32 from the
# same bf16 inputs and round once, so they differ by at most the rounding
# of two float32 values that differ in the last float32 bits.
F32_ATTN, BF16_ATTN_ABS = 2e-5, 1e-6
K8_CACHES = 6       # K8 is timed over this many caches in turn (see timing)
# hostile K7 shapes (B, Sq, Skv, H, K, D, causal, packed): S 1 / 17 / 1000,
# GQA 1, 3 and 4, D 64 / 96 / 128, Sq < Skv, non-causal; `packed` reads
# q/k/v as strided slices of one [B, S, H+2K, D] projection
HOSTILE_K7 = [(1, 1, 1, 2, 2, 64, True, False),
              (2, 17, 17, 6, 2, 128, True, False),
              (1, 1000, 1000, 4, 1, 64, True, False),
              (2, 64, 256, 8, 2, 128, True, False),
              (1, 100, 300, 3, 3, 128, False, False),
              (2, 5, 37, 12, 4, 96, True, False),
              (1, 1000, 1000, 24, 8, 128, False, True),
              (2, 129, 129, 24, 8, 128, True, True),
              # the bf16 body's tilings: D 40 (zero-padded to 64, not a
              # multiple of 16), S 200 (not a multiple of the 128-row query
              # or 64-key tile), a causal offset of 263 keys
              (2, 77, 77, 4, 2, 40, True, False),
              (1, 200, 200, 4, 2, 40, False, False),
              (1, 200, 200, 6, 2, 128, True, False),
              (1, 70, 333, 6, 3, 128, True, False),
              # Zamba2's shared attention: D 80 (zero-filled to the
              # 128-wide tile), H = K
              (4, 23, 23, 32, 32, 80, True, False),
              (1, 200, 200, 4, 4, 80, True, True),
              (2, 65, 150, 8, 8, 80, False, False)]
# hostile K8 shapes (B, S, H, K, D, lengths, strided): caches of 96 and
# 2048 rows, lengths 1, S and between, GQA 1, 3 and 4; `strided` caches are
# views of a longer cache, MISALIGNED ones start one element into it (no
# 16-byte load: the scalar path).  The split-K edges: length 1 with the
# largest split (B 1, 8 kv heads: 8 blocks a row), lengths below the split,
# D 40 and 96
MISALIGNED = "misaligned"
HOSTILE_K8 = [(1, 96, 8, 8, 128, (1,), False),
              (4, 2048, 24, 8, 128, (1, 1039, 2048, 700), False),
              (3, 96, 12, 3, 64, (5, 96, 50), True),
              (2, 17, 16, 4, 128, (17, 3), False),
              (2, 2048, 8, 8, 64, (2048, 1), True),
              (1, 2048, 8, 8, 128, (1,), False),
              (2, 2048, 8, 2, 128, (3, 7), False),
              (2, 2048, 12, 4, 40, (1039, 5), False),
              (2, 1024, 6, 2, 96, (1024, 600), True),
              (4, 2048, 24, 8, 128, (1039, 2, 2048, 9), MISALIGNED),
              (2, 512, 6, 2, 40, (300, 1), MISALIGNED),
              # D 80, H = K (Zamba2): 160-byte rows take the 16-byte path;
              # strided and misaligned caches the others
              (4, 96, 32, 32, 80, (1, 24, 96, 50), False),
              (2, 2048, 4, 4, 80, (2048, 17), True),
              (3, 300, 8, 8, 80, (300, 1, 129), MISALIGNED)]
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
# K2/K3/K5 on their new bodies (H, W, Cin, Cout, k, stride, hpad, wpad,
# ring); Cout 0 = depthwise; ring = (ring rows, src) reads the H-row
# input as a window of a ring (src a row of the stream, so src % ring
# rows is where it starts), None a plain input.  K2: windows that wrap or
# start at the ring's last row, C 4 / 12 / 33, odd W at stride 2, k = 5,
# C 16 / 64 (16-byte copies where aligned); K3/K5: Cin 40 and 64 (K > 32),
# Cout 5 / 72 (no multiple of 8, two N tiles), asymmetric pads, ring
# windows
HOSTILE_RING = [
    (4, 61, 32, 0, 3, 1, (0, 0), (1, 1), (7, 5)),
    (3, 26, 128, 0, 3, 1, (0, 1), (1, 1), (6, 11)),
    (5, 9, 4, 0, 3, 1, (1, 1), (1, 1), (6, 5)),
    (7, 9, 12, 0, 3, 2, (1, 1), (0, 2), None),
    (6, 7, 33, 0, 5, 1, (2, 2), (2, 2), (9, 4)),
    (9, 13, 16, 0, 3, 2, (0, 1), (1, 1), None),
    (6, 11, 64, 0, 5, 2, (2, 1), (2, 2), (8, 6)),
    (9, 125, 3, 32, 3, 2, (0, 0), (0, 1), (11, 10)),
    (7, 10, 40, 5, 3, 1, (1, 0), (2, 1), None),
    (6, 9, 64, 72, 3, 2, (0, 1), (1, 0), (8, 15)),
    (5, 12, 40, 72, 5, 1, (2, 2), (1, 3), (5, 3)),
    (8, 8, 1, 5, 3, 1, (0, 2), (2, 0), None),
]
# K1/K4's split-K edges, three lanes a byte stride apart (H, W, Cin, Cout):
# Cin 1 and 1 030 (ragged chunks), M 1, M 36 with Cout 1 024, Cout 5 and
# 65; zero points at both ends of int8, mult scaled to Cin
HOSTILE_SPLITK = [(1, 1, 1, 5), (7, 9, 1, 65), (1, 1, 1030, 65),
                  (6, 6, 1024, 1024), (6, 6, 1030, 5), (3, 5, 1030, 65)]
SPLITK_ZP = ((-128, -3), (127, 4))                # (zp_in, zp_out)
# fused add params (mult_a, mult_b, zp_a, zp_b, zp_out); zp_a None = the
# conv's zp_out.  Plain; saturating both rails; a negative multiplier.
ADD_QP = ((0.71, 0.39, None, 2, -7), (23.5, 17.25, 60, 0, 100),
          (0.5, -0.75, 9, -3, 1))
# K6 hostile shapes (H, W, Cin, Cout, bias, relu, lanes): M = 1, Cin = 1,
# Cout = 1 and 2, odd M, Cin across several tiles; the split-K edges: Cin
# 1 030 (ragged chunks), M 1 and M 36 with Cout 1 024, Cout 5 and 65, three
# lanes at the unaligned pitch
HOSTILE_F32 = [(1, 1, 1, 1, False, True, 2), (1, 1, 16, 2, True, True, 2),
               (7, 9, 1, 5, True, False, 2), (13, 11, 3, 2, False, True, 2),
               (5, 7, 33, 1, True, True, 2), (3, 5, 1030, 65, False, False, 2),
               (1, 1, 1024, 1024, True, True, 2),
               (9, 9, 12, 22, False, True, 2),
               (6, 6, 1024, 1024, True, True, 3),
               (6, 6, 1030, 1024, False, True, 3),
               (1, 1, 1030, 5, True, False, 3),
               (6, 6, 1030, 65, True, True, 3),
               (7, 9, 1, 65, False, True, 3),
               (12, 12, 512, 512, True, True, 3)]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events around the whole run (launch gaps included: a call whose
    host side outlasts its kernels measures the host).  Python's garbage
    collector is held off during the run, so that a collection of the
    script's large graphs is not charged to one kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / iters


# a device-to-device copy: a copy kernel or a DtoD memcpy (the executor's
# ring gathers, pushes and concats; not the inputs' upload or the outputs'
# download)
COPY = "copy DtoD"


def device_time(torch, fn, reps: int = 3, counts=None):
    """Device busy time per call of ``fn`` (ms), summed over the CUDA
    activities ``torch.profiler`` records, with the top names by time and
    the time of every name (a kernel of the port by its ``<name>_kernel``
    function, device-to-device copies as ``COPY``).  ``counts``, a dict,
    receives the activities of each name per call."""
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
            if "copy_kernel" in e.name or name == "Memcpy DtoD":
                name = COPY
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
            if counts is not None:
                counts[name] = counts.get(name, 0) + 1 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), top, by_name


def dev(ms):
    """A profiler device time for a log line; a profile that recorded no
    device activity (the profiler drops a window now and then) is "not
    measured", never 0."""
    return f"{ms:.5f}" if ms > 0 else "not measured"


def shares(by_name, busy, kernels):
    """``kernel ms (share of busy)`` of each named kernel of the port."""
    return ", ".join(
        f"{n} {by_name.get(n + '_kernel', 0.0):.3f} ms "
        f"({by_name.get(n + '_kernel', 0.0) / max(busy, 1e-9):.3f} of busy)"
        for n in kernels)


def run_form(d):
    """How ``d.run`` runs in this checkout: "graphed" (a replay of the
    executor's captured ``fn``) or "eager" (a checkout before the compiled
    forms)."""
    return "graphed" if hasattr(d.executor, "batched_fn") else "eager"


def eager_run(ex, x):
    """One request through the eager program ``execute`` (what ``run`` did
    before the compiled forms): fresh arena, inputs, run, outputs."""
    return ex.outputs_from(ex.execute(ex.make_arena(x)))


def path_profile(torch, label, d, seed, wrappers, card):
    """One int8 deployment's run without the checks of
    ``Paths.deployment``: launches per inference, run p50 of 10, device
    busy time, the kernels' and device-to-device copies' shares of it,
    ring windows gathered (on the eager program: the counter counts
    Python calls)."""
    from repro_torch.graphs import random_input
    x = random_input(d.graph, seed=seed)
    d.run(x)            # captures the compiled form, where there is one
    torch.cuda.synchronize()
    for f in wrappers.values():
        f.launches = 0
    d.run(x)
    torch.cuda.synchronize()
    per_inf = {n: f.launches for n, f in wrappers.items() if f.launches}
    runs = []
    for _ in range(10):
        t1 = time.perf_counter()
        d.run(x)
        runs.append((time.perf_counter() - t1) * 1e3)
    counts = {}
    busy, _, by_name = device_time(torch, lambda: d.run(x), counts=counts)
    gathers = ring_gathers(d, lambda: eager_run(d.executor, x))
    p50 = statistics.median(runs)
    log(f"path {label}: arena {d.arena_bytes} B, {len(d.schedule)} ops, "
        f"launches/inference {per_inf}; run ({run_form(d)}) p50 {p50:.3f} "
        f"ms; device busy "
        f"{busy:.3f} ms/run (profiler), idle share {1 - busy / p50:.3f}; "
        f"kernel shares {shares(by_name, busy, sorted(per_inf))}; copies "
        f"{counts.get(COPY, 0):.0f}/run, {by_name.get(COPY, 0.0):.3f} ms "
        f"({by_name.get(COPY, 0.0) / max(busy, 1e-9):.3f} of busy); ring "
        f"windows gathered/run (eager execute) {gathers} [{card}]")


def ring_gathers(d, run):
    """Ring windows ``run`` gathers into a new tensor (K1 or qmaxpool
    consumers; "n/a" for a checkout whose executor gathers every window
    before its consumer)."""
    from repro_torch.kernels.conv_quant import ops
    win = getattr(ops, "RingWindow", None)
    if win is None:
        return "n/a"
    seen, gather = [], win.gather

    def counted(self, out=None):
        seen.append(self.n)
        return gather(self, out)
    win.gather = counted
    try:
        run()
    finally:
        win.gather = gather
    return len(seen)


def add_params(addp, zp_out):
    mult_a, mult_b, zp_a, zp_b, zp_add = addp
    return (mult_a, mult_b, zp_out if zp_a is None else zp_a, zp_b, zp_add)


def is_pointwise(op) -> bool:
    return (op.kind == "conv" and op.attrs.get("k", 1) == 1
            and op.attrs["stride"] == 1)


class Checks:
    """Every kernel held against its plain version: one launch
    configuration per key, inputs in strided two-lane views like the
    arena's (lanes ``pitch`` bytes apart: not a multiple of 4 for int8,
    of 16 for float32)."""

    def __init__(self, torch, np, device, wrappers):
        from repro_torch.core.partition import same_pads
        from repro_torch.kernels.conv_pointwise import ops as pw_ops
        from repro_torch.kernels.conv_pointwise import ref as pw_ref
        from repro_torch.kernels.conv_quant import ops, ref
        self.torch, self.np, self.device = torch, np, device
        self.ops, self.ref, self.same_pads = ops, ref, same_pads
        self.pw_ops, self.pw_ref = pw_ops, pw_ref
        self.rng = np.random.default_rng(0)
        self.configs = {}    # key -> (kernel, macs, bytes, spec)
        self.mismatches = {k: 0 for k in wrappers}
        self.max_err = {k: 0 for k in wrappers}
        self.checked = {k: 0 for k in wrappers}
        self.max_rel = 0.0   # K6: max |got - want| / max |want|, per call
        self.ring_checked = 0    # configurations read as ring windows
        # whether this checkout's K2/K3/K5 take ring windows in place
        self.rings = hasattr(ops, "RingWindow")

    def _pads(self, n, k, stride, pad):
        if pad is not None:
            return tuple(pad)
        _, beg, end = self.same_pads(n, k, stride)
        return beg, end

    def _lanes(self, shape, lanes=2, aligned=False):
        """``lanes`` int8 blocks of ``shape`` a byte pitch apart: at an odd
        offset and pitch (no copy wider than a byte can read them), or
        ``aligned`` to 16 bytes, as the arena's int8 views lie."""
        n = int(self.np.prod(shape))
        off, pitch = (16, -(-(n + 37) // 16) * 16) if aligned else \
            (5, n + 37)
        buf = self.torch.as_tensor(
            self.rng.integers(0, 256, (lanes, pitch), dtype=self.np.uint8),
            device=self.device)
        return buf[:, off:off + n].view(self.torch.int8).view(lanes, *shape)

    def _lanes_f32(self, shape, lanes=2):
        n = int(self.np.prod(shape))
        pitch = n + 2 + ((n + 2) % 4 == 0)      # elements; 4*pitch % 16 != 0
        buf = self.torch.as_tensor(self.rng.standard_normal(
            (lanes, pitch)).astype(self.np.float32), device=self.device)
        assert (4 * pitch) % 16 and buf.stride(0) == pitch
        return buf[:, 1:1 + n].view(lanes, *shape)

    def _rand(self, shape):
        return self.torch.as_tensor(
            self.rng.integers(-128, 128, shape, dtype=self.np.int8),
            device=self.device)

    def _randn(self, shape, scale=1.0):
        return self.torch.as_tensor((self.rng.standard_normal(shape) * scale)
                                    .astype(self.np.float32),
                                    device=self.device)

    def case(self, tag, kind, h, w, cin, cout, k, stride, hpad, wpad,
             mult, zp_in, zp_out, addp=None, lanes=2, ring=None,
             aligned=False):
        """Route one int8 configuration as ``qconv_fused``/
        ``qdwconv_fused``/``qconv_add_fused`` (``addp`` given) do and
        compare the kernel with the plain version (once per ``tag`` and
        shape), over ``lanes`` lanes a byte stride apart (``aligned``: 16
        bytes).  ``ring = (ring_rows, src)``: K2/K3/K5 read the H-row input
        as the window (src, H) of a ring of ``ring_rows`` rows, held
        against the ring-view plain versions."""
        hp = self._pads(h, k, stride, hpad)
        wp = self._pads(w, k, stride, wpad)
        oh = (h + hp[0] + hp[1] - k) // stride + 1
        ow = (w + wp[0] + wp[1] - k) // stride + 1
        key = (tag, kind, h, w, cin, cout, k, stride, hp, wp, addp, ring,
               aligned)
        if key in self.configs:
            return
        rows, src = ring or (h, 0)
        x = self._lanes((rows, w, cin), lanes, aligned)
        # ring windows through the wrappers' src/n and the *_ring_ref plain
        # versions; a plain input through the calls every checkout has
        rk = dict(src=src, n=h) if ring else {}
        rs = "_ring" if ring else ""
        qp = dict(mult=mult, zp_in=zp_in, zp_out=zp_out)
        pw = k == 1 and stride == 1 and hp == (0, 0) and wp == (0, 0)
        assert not (pw and ring), "K1 takes no ring window"
        extra = 0
        if kind == "qdwconv":
            name, wt = "qdwconv", self._rand((k, k, cin))
            macs = oh * ow * cin * k * k
            out = self._lanes((oh, ow, cin), lanes, aligned)
            got = self.ops.qdwconv(x, wt, stride=stride, hpad=hp, wpad=wp,
                                   out=out, **rk, **qp)
            want = getattr(self.ref, "qdwconv" + rs + "_ref")(
                x, wt, stride=stride, hpad=hp, wpad=wp, **rk, **qp)
        elif addp is not None:
            r = self._lanes((oh, ow, cout), lanes)
            extra = r[0].numel()
            out = self._lanes((oh, ow, cout), lanes)
            ap = add_params(addp, zp_out)
            if pw:
                name, wt = "qconv1x1_add", self._rand((cin, cout))
                got = self.ops.qconv1x1_add(x, wt, r, add_params=ap,
                                            out=out, **qp)
                want = self.ref.qconv1x1_add_ref(x, wt, r, add_params=ap,
                                                 **qp)
            else:
                name, wt = "qconv_add", self._rand((k, k, cin, cout))
                got = self.ops.qconv_add(x, wt, r, stride=stride, hpad=hp,
                                         wpad=wp, add_params=ap, out=out,
                                         **rk, **qp)
                want = getattr(self.ref, "qconv_add" + rs + "_ref")(
                    x, wt, r, stride=stride, hpad=hp, wpad=wp,
                    add_params=ap, **rk, **qp)
            macs = oh * ow * cout * k * k * cin
        elif pw:
            name, wt = "qconv1x1", self._rand((cin, cout))
            macs = h * w * cin * cout
            out = self._lanes((oh, ow, cout), lanes)
            got = self.ops.qconv1x1(x, wt, out=out, **qp)
            want = self.ref.qconv1x1_ref(x, wt, **qp)
        else:
            name, wt = "qconv", self._rand((k, k, cin, cout))
            macs = oh * ow * cout * k * k * cin
            out = self._lanes((oh, ow, cout), lanes)
            got = self.ops.qconv(x, wt, stride=stride, hpad=hp, wpad=wp,
                                 out=out, **rk, **qp)
            want = getattr(self.ref, "qconv" + rs + "_ref")(
                x, wt, stride=stride, hpad=hp, wpad=wp, **rk, **qp)
        self.torch.cuda.synchronize()
        assert got is out
        diff = (got.to(self.torch.int32) - want.to(self.torch.int32)).abs()
        self.max_err[name] = max(self.max_err[name], int(diff.max()))
        self.mismatches[name] += int((diff != 0).sum())
        self.checked[name] += 1
        nbytes = h * w * cin + wt.numel() + out[0].numel() + extra
        self.configs[key] = (name, macs, nbytes,
                             (h, w, cin, cout, k, stride, hp, wp, qp, addp))
        if ring:
            self.ring_checked += 1

    def case_f32(self, tag, h, w, cin, cout, bias=False, relu=True,
                 lanes=2):
        """K6 against its plain version, within the float32 bound."""
        key = (tag, "conv1x1", h, w, cin, cout, bias, relu, lanes)
        if key in self.configs:
            return
        torch = self.torch
        x = self._lanes_f32((h, w, cin), lanes)
        wt = self._randn((cin, cout), 0.1)
        b = self._randn((cout,)) if bias else None
        out = self._lanes_f32((h, w, cout), lanes)
        got = self.pw_ops.conv1x1(x, wt, b, relu=relu, out=out)
        want = self.pw_ref.conv1x1_ref(x, wt, b, relu=relu)
        torch.cuda.synchronize()
        assert got is out
        diff = (got.double() - want.double()).abs()
        mag = x.abs().double() @ wt.abs().double()
        if b is not None:
            mag = mag + b.abs().double()
        bound = F32_BOUND * (cin + 2) * mag
        name = "conv1x1"
        self.mismatches[name] += int((diff > bound).sum())
        self.max_err[name] = max(self.max_err[name], float(diff.max()))
        self.max_rel = max(self.max_rel, float(
            diff.max() / want.abs().max().clamp_min(1e-30)))
        self.checked[name] += 1
        nbytes = 4 * (x[0].numel() + wt.numel() + out[0].numel()
                      + (cout if bias else 0))
        self.configs[key] = (name, h * w * cin * cout, nbytes,
                             (h, w, cin, cout, bias, relu))

    def from_deployment(self, d):
        """The int8 convs of a deployment's schedule — each also as K4/K5
        with a residual — or its k=1, stride-1 float32 convs."""
        g = d.exec_graph
        for op in d.schedule:
            a = op.attrs
            if is_pointwise(op):
                h, w, cin = g.tensors[op.inputs[0]].shape
                self.case_f32("main", h, w, cin,
                              g.tensors[op.output].shape[-1])
            if op.kind not in ("qconv", "qdwconv"):
                continue
            h, w, cin = g.tensors[op.inputs[0]].shape
            wq = a["weight_q"]
            args = (op.kind, h, w, cin,
                    wq.shape[3] if op.kind == "qconv" else 0, wq.shape[0],
                    a["stride"], a.get("pex_pads"), a.get("pex_wpads"),
                    a["mult"], a["zp_in"], a["zp_out"])
            self.case("main", *args)
            if op.kind == "qdwconv":     # as the arena's views: 16-byte path
                self.case("main", *args, aligned=True)
            if op.kind == "qconv":
                self.case("main", *args, addp=ADD_QP[0])
            ring = self.ring_of(d, op)
            if ring is not None:
                self.case("main", *args, ring=ring, aligned=True)

    def ring_of(self, d, op):
        """(ring rows, src) of the ring window ``op`` reads in place on the
        card (a zero-copy ring read of K2 or K3), else None."""
        a = op.attrs
        if (not self.rings or op.inputs[0] not in d.executor._zc
                or (a["weight_q"].shape[0] == 1 and a["stride"] == 1
                    and tuple(a.get("pex_pads") or (0, 0)) == (0, 0)
                    and tuple(a.get("pex_wpads") or (0, 0)) == (0, 0))):
            return None     # a plain input, or K1 (which gathers)
        a = d.exec_graph.producer(op.inputs[0]).attrs
        return a["pex_ring_rows"], a["pex_ring_src"] % a["pex_ring_rows"]

    def hostile(self):
        for i, (mult, zi, zo) in enumerate(HOSTILE_QP):
            for (h, w, cin, cout, k, s, hp, wp) in HOSTILE:
                kind = "qdwconv" if cout == 0 else "qconv"
                self.case(f"hostile{i}", kind, h, w, cin, cout, k, s, hp,
                          wp, mult, zi, zo)
                if cout:
                    for addp in ADD_QP:
                        self.case(f"hostile{i}", kind, h, w, cin, cout, k,
                                  s, hp, wp, mult, zi, zo, addp=addp)
        for (h, w, cin, cout) in HOSTILE_SPLITK:
            for zi, zo in SPLITK_ZP:
                mult = 0.003 / cin ** 0.5
                self.case("splitk", "qconv", h, w, cin, cout, 1, 1, None,
                          None, mult, zi, zo, lanes=3)
                for addp in ADD_QP:
                    self.case("splitk", "qconv", h, w, cin, cout, 1, 1,
                              None, None, mult, zi, zo, addp=addp, lanes=3)
        for (h, w, cin, cout, bias, relu, lanes) in HOSTILE_F32:
            self.case_f32("hostile", h, w, cin, cout, bias, relu, lanes)
        for i, (mult, zi, zo) in enumerate(HOSTILE_QP):
            for (h, w, cin, cout, k, s, hp, wp, ring) in HOSTILE_RING:
                kind = "qdwconv" if cout == 0 else "qconv"
                ring = ring if self.rings else None
                for aligned in (False, True):
                    self.case(f"ring{i}", kind, h, w, cin, cout, k, s, hp,
                              wp, mult, zi, zo, ring=ring, aligned=aligned)
                if cout:
                    self.case(f"ring{i}", kind, h, w, cin, cout, k, s, hp,
                              wp, mult, zi, zo, addp=ADD_QP[i], ring=ring)

    def largest(self, name):
        keys = [k for k, v in self.configs.items()
                if v[0] == name and k[0] == "main"]
        return max(keys, key=lambda k: (self.configs[k][1],
                                        self.configs[k][2]))

    def timing(self, name, card):
        """kernel_ms, plain_ms, library_ms and the bound at the largest
        main-path configuration of kernel ``name``."""
        torch = self.torch
        _, macs, nbytes, spec = self.configs[self.largest(name)]
        lib, lib_name = None, ""
        if name == "conv1x1":
            h, w, cin, cout, _, _ = spec
            x = self._randn((1, h, w, cin))
            wt = self._randn((cin, cout), 0.1)
            out = torch.empty((1, h, w, cout), device=self.device)
            run = lambda: self.pw_ops.conv1x1(x, wt, out=out)  # noqa: E731
            plain = lambda: self.pw_ref.conv1x1_ref(x, wt)  # noqa: E731
            a2 = x.reshape(h * w, cin)
            lib = lambda: torch.matmul(a2, wt)  # noqa: E731
            lib_name = " (torch.matmul, TF32 off, bare product)"
            peak, shape = H100_F32_OPS_PER_S, f"{h}x{w}x{cin}->{cout}"
        else:
            h, w, cin, cout, k, stride, hp, wp, qp, addp = spec
            x = self._rand((1, h, w, cin))
            pads = dict(stride=stride, hpad=hp, wpad=wp)
            oh = (h + hp[0] + hp[1] - k) // stride + 1
            ow = (w + wp[0] + wp[1] - k) // stride + 1
            r = self._rand((1, oh, ow, cout)) if addp else None
            ap = add_params(addp, qp["zp_out"]) if addp else None
            if name == "qconv1x1":
                wt = self._rand((cin, cout))
                out = torch.empty((1, h, w, cout), dtype=torch.int8,
                                  device=self.device)
                run = lambda: self.ops.qconv1x1(x, wt, out=out, **qp)  # noqa
                plain = lambda: self.ref.qconv1x1_ref(x, wt, **qp)  # noqa
            elif name == "qconv1x1_add":
                wt = self._rand((cin, cout))
                run = lambda: self.ops.qconv1x1_add(  # noqa: E731
                    x, wt, r, add_params=ap, **qp)
                plain = lambda: self.ref.qconv1x1_add_ref(  # noqa: E731
                    x, wt, r, add_params=ap, **qp)
            elif name == "qconv":
                wt = self._rand((k, k, cin, cout))
                run = lambda: self.ops.qconv(x, wt, **pads, **qp)  # noqa
                plain = lambda: self.ref.qconv_ref(  # noqa: E731
                    x, wt, **pads, **qp)
            elif name == "qconv_add":
                wt = self._rand((k, k, cin, cout))
                run = lambda: self.ops.qconv_add(  # noqa: E731
                    x, wt, r, add_params=ap, **pads, **qp)
                plain = lambda: self.ref.qconv_add_ref(  # noqa: E731
                    x, wt, r, add_params=ap, **pads, **qp)
            else:
                wt = self._rand((k, k, cin))
                run = lambda: self.ops.qdwconv(x, wt, **pads, **qp)  # noqa
                plain = lambda: self.ref.qdwconv_ref(  # noqa: E731
                    x, wt, **pads, **qp)
            if name in ("qconv1x1", "qconv1x1_add"):   # K4: its product
                a2 = x.reshape(h * w, cin)
                b2 = wt.t().contiguous().t()        # column-major operand
                lib = lambda: torch._int_mm(a2, b2)  # noqa: E731
                lib_name = " (torch._int_mm, bare int8 product)"
            peak = H100_INT8_OPS_PER_S
            shape = f"{h}x{w}x{cin}" + ("" if name == "qdwconv" else
                                        f"->{cout}") + \
                f" k={k} s={stride} pads={hp}/{wp}"
        kernel_ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=10, warmup=2)
        library_ms = None
        if lib is not None:
            with self.pw_ref.full_f32_matmul():
                library_ms = time_ms(torch, lib)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 2 * macs / peak * 1e3
        rel = (f", max_rel_err {self.max_rel:.3e} (of max|want|), within "
               f"the f32 bound" if name == "conv1x1" else "")
        log(f"kernels {name}: {self.checked[name]} configs, "
            f"{self.mismatches[name]} mismatches, max_abs_err "
            f"{self.max_err[name]}{rel}; at {shape}: kernel_ms "
            f"{kernel_ms:.5f}, plain_ms {plain_ms:.5f}, library_ms "
            f"{'none' if library_ms is None else f'{library_ms:.5f}'}"
            f"{lib_name}, bound_ms {max(t_bytes, t_ops):.7f} [{card}]")
        return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    shape=shape)

    def conv_shapes(self, card, deployments, ppts=()):
        """K2 and K3 at every distinct K2/K3 shape of the int8
        ``deployments`` (``(label, d)`` pairs), K3's shapes also as K5 with
        a residual: one lane, plain inputs aligned as the arena's (the
        shapes the main path launches, ring windows included, read as
        whole tensors here so that any checkout can be timed), held
        against the plain version, event and profiler device time, the
        bound, and the launches of that shape per inference of each
        deployment; then per deployment the sum of launches x device time
        of each kernel.  ``ppts``: K2's device time with its tile forced
        to that many pixels a thread (through the planner hook
        ``ops._dw_plan``, where the checkout has ``ops.dw_tile``),
        bit-exact each."""
        torch = self.torch
        shapes = {}
        for label, d in deployments:
            g = d.exec_graph
            for op in d.schedule:
                a = op.attrs
                if op.kind not in ("qconv", "qdwconv"):
                    continue
                wq = a["weight_q"]
                hp = tuple(a.get("pex_pads") or (0, 0))
                wp = tuple(a.get("pex_wpads") or (0, 0))
                if (op.kind == "qconv" and wq.shape[0] == 1
                        and a["stride"] == 1 and hp == wp == (0, 0)):
                    continue                     # K1's
                h, w, cin = g.tensors[op.inputs[0]].shape
                key = (op.kind, h, w, cin,
                       wq.shape[3] if op.kind == "qconv" else 0,
                       wq.shape[0], a["stride"], hp, wp)
                e = shapes.setdefault(key, {"op": op, "n": {}, "ring": 0})
                e["n"][label] = e["n"].get(label, 0) + 1
                e["ring"] += self.ring_of(d, op) is not None
        per_inf = {label: {} for label, _ in deployments}
        for key, e in shapes.items():
            kind, h, w, cin, cout, k, stride, hp, wp = key
            a = e["op"].attrs
            qp = dict(stride=stride, hpad=hp, wpad=wp, mult=a["mult"],
                      zp_in=a["zp_in"], zp_out=a["zp_out"])
            oh = (h + hp[0] + hp[1] - k) // stride + 1
            ow = (w + wp[0] + wp[1] - k) // stride + 1
            x = self._lanes((h, w, cin), 1, aligned=True)
            wt = torch.as_tensor(a["weight_q"], device=self.device)
            co = cin if kind == "qdwconv" else cout
            out = self._lanes((oh, ow, co), 1, aligned=True)
            runs = []
            if kind == "qdwconv":
                wt = wt.reshape(k, k, cin)
                runs.append(("qdwconv", lambda: self.ops.qdwconv(
                    x, wt, out=out, **qp), self.ref.qdwconv_ref(x, wt, **qp),
                    0))
            else:
                r = self._lanes((oh, ow, cout), 1, aligned=True)
                ap = add_params(ADD_QP[0], qp["zp_out"])
                runs.append(("qconv", lambda: self.ops.qconv(
                    x, wt, out=out, **qp), self.ref.qconv_ref(x, wt, **qp),
                    0))
                runs.append(("qconv_add", lambda: self.ops.qconv_add(
                    x, wt, r, add_params=ap, out=out, **qp),
                    self.ref.qconv_add_ref(x, wt, r, add_params=ap, **qp),
                    oh * ow * cout))
            parts = []
            hook = getattr(self.ops, "_dw_plan", None)
            forced = ppts if kind == "qdwconv" and hasattr(
                self.ops, "dw_tile") else ()
            for ppt in forced:
                self.ops._dw_plan = forced_dw_plan(self.ops, ppt)
                try:
                    assert torch.equal(runs[0][1](), runs[0][2]), (key, ppt)
                    t = device_time(torch, runs[0][1], reps=20)[0]
                    blocks = self.ops.dw_tile(1, oh, ow, cin, ppt)[1]
                    parts.append(f"forced {ppt} px/thread ({blocks} "
                                 f"blocks): device_ms {dev(t)}")
                finally:
                    self.ops._dw_plan = hook
            for name, run, want, extra in runs:
                assert torch.equal(run(), want), (name, key)
                ev = time_ms(torch, run)
                dv = device_time(torch, run, reps=20)[0]
                nbytes = h * w * cin + wt.numel() + oh * ow * co + extra
                macs = oh * ow * co * k * k * (1 if kind == "qdwconv"
                                                else cin)
                bound = max(nbytes / H100_BYTES_PER_S,
                            2 * macs / H100_INT8_OPS_PER_S) * 1e3
                parts.append(f"{name} kernel_ms {ev:.5f}, device_ms "
                             f"{dev(dv)}, bound_ms {bound:.7f}")
                for label, n in e["n"].items():
                    if name != "qconv_add":
                        acc = per_inf[label]
                        acc[name] = acc.get(name, 0.0) + n * dv
            log(f"kernels conv shape {kind} {h}x{w}x{cin}"
                + (f"->{cout}" if cout else "") + f" k={k} s={stride} pads "
                f"{hp}/{wp}: launches/inference {e['n']}, ring windows "
                f"{e['ring']}; " + "; ".join(parts) + f" [{card}]")
        for label, acc in per_inf.items():
            log(f"kernels conv shapes {label}: launches x device_ms per "
                f"inference " + ", ".join(f"{n} {t:.4f} ms"
                                          for n, t in sorted(acc.items()))
                + f" [{card}]")

    def k1_shapes(self, card, d, splits=()):
        """K1 at every distinct pointwise shape of deployment ``d``'s
        schedule, one lane: kernel_ms against ``torch._int_mm`` (the bare
        int8 product), each also as device time per call from the profiler
        (the calls are launch-bound), and the bound, one line per shape.
        ``splits``: K1's device time with Cin forced into that many chunks
        (through the planner hook ``ops._plan``), bit-exact each."""
        torch = self.torch
        sms = torch.cuda.get_device_properties(self.device) \
            .multi_processor_count
        plan = getattr(self.ops, "plan_split_k", None)
        g, seen = d.exec_graph, set()
        for op in d.schedule:
            a = op.attrs
            if not (op.kind == "qconv" and a["weight_q"].shape[0] == 1
                    and a["stride"] == 1
                    and a.get("pex_pads") in (None, (0, 0))
                    and a.get("pex_wpads") in (None, (0, 0))):
                continue
            h, w, cin = g.tensors[op.inputs[0]].shape
            cout = a["weight_q"].shape[3]
            if (h, w, cin, cout) in seen:
                continue
            seen.add((h, w, cin, cout))
            qp = dict(mult=a["mult"], zp_in=a["zp_in"], zp_out=a["zp_out"])
            x = self._rand((1, h, w, cin))
            wt = self._rand((cin, cout))
            out = torch.empty((1, h, w, cout), dtype=torch.int8,
                              device=self.device)
            want = self.ref.qconv1x1_ref(x, wt, **qp)

            def run():
                return self.ops.qconv1x1(x, wt, out=out, **qp)
            a2, b2 = x.reshape(h * w, cin), wt.t().contiguous().t()

            def lib():
                return torch._int_mm(a2, b2)
            kernel_ms, library_ms = time_ms(torch, run), time_ms(torch, lib)
            dev_ms, lib_dev_ms = (device_time(torch, f, reps=20)[0]
                                  for f in (run, lib))
            forced = {}
            for n in splits:
                planner = self.ops._plan
                self.ops._plan = forced_plan(n, self.ops.MAX_SPLIT)
                try:
                    assert torch.equal(run(), want), (h, w, cin, cout, n)
                    forced[n] = device_time(torch, run, reps=20)[0]
                finally:
                    self.ops._plan = planner
            assert torch.equal(run(), want), (h, w, cin, cout)
            nbytes = h * w * cin + cin * cout + h * w * cout
            bound = max(nbytes / H100_BYTES_PER_S,
                        2 * h * w * cin * cout / H100_INT8_OPS_PER_S) * 1e3
            log(f"kernels qconv1x1 shape {h}x{w}x{cin}->{cout}: kernel_ms "
                f"{kernel_ms:.5f}, library_ms {library_ms:.5f} "
                f"(torch._int_mm); device_ms {dev(dev_ms)}, library "
                f"{dev(lib_dev_ms)} (profiler); bound_ms {bound:.7f}; "
                f"split/chunk "
                f"{plan(1, h * w, cin, cout, sms) if plan else 'n/a'}"
                + "".join(f"; forced split {n}: device_ms {dev(t)}"
                          for n, t in forced.items()) + f" [{card}]")


    def k6_shapes(self, card, d, splits=(), lanes=1):
        """K6 at every distinct pointwise shape of the float32 deployment
        ``d``'s schedule, ``lanes`` lanes with a bias: kernel_ms against
        ``torch.matmul`` (TF32 off, the bare product), each also as device
        time per call from the profiler, and the bound, one line per shape.
        ``splits``: K6's device time with each tile shape and Cin forced
        into that many chunks (through the planner hook ``pw_ops._plan``,
        where the checkout has one), each held to the float32 bound."""
        torch, pw = self.torch, self.pw_ops
        sms = torch.cuda.get_device_properties(self.device) \
            .multi_processor_count
        plan = getattr(pw, "plan_split_k", None)
        hook = getattr(pw, "_plan", None)
        g, seen = d.exec_graph, set()
        for op in d.schedule:
            if not is_pointwise(op):
                continue
            h, w, cin = g.tensors[op.inputs[0]].shape
            cout = g.tensors[op.output].shape[-1]
            if (h, w, cin, cout) in seen:
                continue
            seen.add((h, w, cin, cout))
            x = self._randn((lanes, h, w, cin))
            wt = self._randn((cin, cout), 0.1)
            b = self._randn((cout,))
            out = torch.empty((lanes, h, w, cout), device=self.device)
            want = self.pw_ref.conv1x1_ref(x, wt, b).double()
            tol = F32_BOUND * (cin + 2) * (
                x.abs().double() @ wt.abs().double() + b.abs().double())

            def run():
                return pw.conv1x1(x, wt, b, out=out)

            def check(tag):
                ok = bool(((run().double() - want).abs() <= tol).all())
                assert ok, ("conv1x1", h, w, cin, cout, tag)
            a2 = x.reshape(lanes * h * w, cin)

            def lib():
                return torch.matmul(a2, wt)
            check("planned")
            kernel_ms = time_ms(torch, run)
            dev_ms = device_time(torch, run, reps=20)[0]
            with self.pw_ref.full_f32_matmul():
                library_ms = time_ms(torch, lib)
                lib_dev_ms = device_time(torch, lib, reps=20)[0]
            forced = {}
            for bm in (getattr(pw, "TILE_ROWS", ()) if hook else ()):
                for n in splits:
                    pw._plan = forced_k6_plan(bm, n, pw.K_STEP, pw.MAX_SPLIT)
                    try:
                        check((bm, n))
                        forced[bm, n] = device_time(torch, run, reps=20)[0]
                    finally:
                        pw._plan = hook
            m = lanes * h * w
            nbytes = 4 * (m * cin + cin * cout + cout + m * cout)
            bound = max(nbytes / H100_BYTES_PER_S,
                        2 * m * cin * cout / H100_F32_OPS_PER_S) * 1e3
            log(f"kernels conv1x1 shape {lanes}x{h}x{w}x{cin}->{cout}: "
                f"kernel_ms "
                f"{kernel_ms:.5f}, library_ms {library_ms:.5f} "
                f"(torch.matmul, TF32 off); device_ms {dev(dev_ms)}, library "
                f"{dev(lib_dev_ms)} (profiler); bound_ms {bound:.7f}; "
                f"tile/split/chunk "
                f"{plan(lanes, h * w, cin, cout, sms) if plan else 'n/a'}"
                + "".join(f"; forced tile {bm} split {n}: device_ms {dev(t)}"
                          for (bm, n), t in forced.items()) + f" [{card}]")


def forced_dw_plan(ops, ppt):
    """A stand-in for K2's planner hook ``ops._dw_plan`` that gives each
    thread ``ppt`` pixels (``ops.dw_tile``)."""
    def plan(lanes, oh, ow, c, k, stride, dev):
        return ops.dw_tile(lanes, oh, ow, c, ppt)[0]
    return plan


def forced_k6_plan(bm, n, step, cap):
    """A stand-in for K6's planner hook ``pw_ops._plan``: tiles of ``bm``
    rows, Cin cut into ``n`` chunks of whole K-steps (fewer where Cin has
    fewer)."""
    def plan(lanes, m, cin, cout, dev):
        steps = max(1, -(-cin // step))
        per = -(-steps // max(1, min(cap, steps, n)))
        return bm, -(-steps // per), per * step
    return plan


def forced_plan(n, cap):
    """A stand-in for K1's planner hook ``ops._plan`` that cuts Cin into
    ``n`` chunks of whole 64-channel K-steps (fewer where Cin has fewer)."""
    def plan(lanes, m, cin, cout, dev):
        steps = max(1, -(-cin // 64))
        per = -(-steps // max(1, min(cap, steps, n)))
        return -(-steps // per), per * 64
    return plan


class Paths:
    """The port's paths, each driven with every launch count set to 0
    just before it and read just after; ``launches`` sums them."""

    def __init__(self, torch, np, wrappers, card):
        from repro_torch.graphs import random_input
        from repro_torch.mcu.compile import compile_schedule
        self.torch, self.np, self.card = torch, np, card
        self.wrappers = wrappers
        self.random_input, self.compile_schedule = random_input, \
            compile_schedule
        self.launches = {n: 0 for n in wrappers}

    def reset(self):
        for f in self.wrappers.values():
            f.launches = 0

    def read(self):
        self.torch.cuda.synchronize()
        got = {n: f.launches for n, f in self.wrappers.items()}
        for n, v in got.items():
            self.launches[n] += v
        return got

    def same(self, got, want, exact):
        if exact:
            self.np.testing.assert_array_equal(got, want)
        else:
            self.np.testing.assert_allclose(
                got, want, rtol=F32_TOL["rtol"],
                atol=F32_TOL["atol_frac"] * float(self.np.abs(want).max()))

    def deployment(self, label, d, seed, exact):
        """One request through ``d.run`` (per-inference launches), held
        against the port's plain CPU path on the same schedule and plan;
        run p50, device busy time, and ``serve`` of 8 requests at
        ``micro_batch`` 4 against one-shot runs."""
        np, torch = self.np, self.torch
        t0 = time.perf_counter()
        g = d.graph
        x = self.random_input(g, seed=seed)
        d.executor.fn.capture()         # before the counts: see graphs()
        self.reset()
        out = d.run(x)
        per_inf = {n: f.launches for n, f in self.wrappers.items()
                   if f.launches}
        (name, val), = out.items()
        assert val.shape == tuple(g.tensors[name].shape), val.shape
        assert val.dtype == (np.int8 if exact else np.float32)
        assert np.isfinite(val).all()
        runs = []
        for _ in range(10):
            t1 = time.perf_counter()
            d.run(x)
            runs.append((time.perf_counter() - t1) * 1e3)
        counts = {}
        busy, top, by_name = device_time(torch, lambda: d.run(x),
                                         counts=counts)
        gathers = ring_gathers(d, lambda: eager_run(d.executor, x))
        p50 = statistics.median(runs)
        reqs = [self.random_input(g, seed=s) for s in range(8)]
        eng = d.engine(micro_batch=4)
        served = eng.serve(reqs)
        one_shot = [d.run(r)[name] for r in reqs]
        self.read()
        plain = self.compile_schedule(d.exec_graph, d.schedule, d.plan,
                                      device="cpu").run(x)
        self.same(val, plain[name], exact)
        assert eng.stats.dispatches == 2 and eng.stats.padded_lanes == 0
        for o, want in zip(served, one_shot):
            self.same(o[name], want, exact)
        log(f"phase main-path {label}: {d.schedule_result.method}, arena "
            f"{d.arena_bytes} B, {len(d.schedule)} ops, launches/inference "
            f"{per_inf}, card == cpu plain path "
            f"({'bit-exact' if exact else 'within F32_TOL'}), serve 8 == "
            f"one-shot; graphed run p50 {p50:.3f} ms, graphed serve "
            f"{eng.stats.requests_per_s:.2f} req/s (micro_batch 4); "
            f"device busy {busy:.3f} ms/run (profiler), idle share "
            f"{1 - busy / p50:.3f} of p50; top "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in top)
            + f"; kernel shares (profiler) "
            f"{shares(by_name, busy, sorted(per_inf))}; copies "
            f"{counts.get(COPY, 0):.0f}/run, {by_name.get(COPY, 0.0):.3f} ms "
            f"({by_name.get(COPY, 0.0) / max(busy, 1e-9):.3f} of busy); "
            f"zero-copy reads {d.executor.zero_copy_reads}, ring windows "
            f"gathered/run (eager execute) {gathers}"
            f" [{self.card}] ({time.perf_counter() - t0:.2f} s)")
        return per_inf

    def graphs(self, label, d, seed, exact):
        """``phase graphs``: the deployment's compiled forms (``fn``,
        ``batched_fn(4)``: CUDA-graph replays) against its eager program
        (``execute``) in one process: outputs of two requests in a row
        through one graph and of a ragged serve (7 requests at
        ``micro_batch`` 4), launches per inference through replays,
        capture ms, run p50 and serve requests/s eager vs graphed, device
        busy per run and idle share of each.  The profiler must see the
        port's kernels inside the replays, the busy time within 10 % of
        eager's."""
        np, torch = self.np, self.torch
        t0 = time.perf_counter()
        ex, g = d.executor, d.graph
        xs = [self.random_input(g, seed=seed + s) for s in range(2)]
        self.reset()
        eager = [ex.execute(ex.make_arena(xs[0]))]
        eager_inf = {n: v for n, v in self.read().items() if v}
        eager.append(ex.execute(ex.make_arena(xs[1])))
        cap = ex.fn.capture()
        self.reset()
        graphed = [ex.fn([xs[0]]).clone()]
        graph_inf = {n: v for n, v in self.read().items() if v}
        assert graph_inf == eager_inf, (graph_inf, eager_inf)
        assert cap.launches == {n: eager_inf.get(n, 0)
                                for n in cap.launches}, cap.launches
        graphed.append(ex.fn([xs[1]]).clone())
        for got, want in zip(graphed, eager):
            if exact:       # every byte of the arena, not only the outputs
                assert torch.equal(got, want)
            want = ex.outputs_from(want)
            for name, val in ex.outputs_from(got).items():
                self.same(val, want[name], exact)
        # serve: 7 requests at micro_batch 4 (a ragged last batch)
        reqs = [self.random_input(g, seed=seed + 10 + s) for s in range(7)]
        eng = d.engine(micro_batch=4)
        eng.serve(reqs)                 # captures batched_fn(4)
        served = eng.serve(reqs)
        rps_graphed = eng.stats.requests_per_s
        assert eng.stats.dispatches == 2 and eng.stats.padded_lanes == 1

        def eager_serve():
            outs = []
            for i in range(0, len(reqs), 4):
                arena = ex.new_arena(4)
                for lane, r in enumerate(reqs[i:i + 4]):
                    ex.write_inputs(arena, lane, r)
                ex.execute(arena)
                outs += [ex.outputs_from(arena, lane)
                         for lane in range(len(reqs[i:i + 4]))]
            return outs
        eager_serve()
        t1 = time.perf_counter()
        eager_served = eager_serve()
        rps_eager = len(reqs) / (time.perf_counter() - t1)
        for got, want, r in zip(served, eager_served, reqs):
            one = eager_run(ex, r)
            for name in want:
                self.same(got[name], want[name], exact)
                self.same(want[name], one[name], exact)
        # run p50, in turns
        runs = {"eager": [], "graphed": []}
        for _ in range(10):
            for form, run in (("eager", lambda: eager_run(ex, xs[0])),
                              ("graphed", lambda: ex.run(xs[0]))):
                t1 = time.perf_counter()
                run()
                runs[form].append((time.perf_counter() - t1) * 1e3)
        p50 = {k: statistics.median(v) for k, v in runs.items()}
        busy_e, _, _ = device_time(torch, lambda: eager_run(ex, xs[0]))
        busy_g, _, by_g = device_time(torch, lambda: ex.run(xs[0]))
        seen = {n: by_g.get(n + "_kernel", 0.0) for n in eager_inf}
        assert busy_g > 0 and all(v > 0 for v in seen.values()), (
            "the profiler saw no kernel of the port inside the replays",
            busy_g, seen, sorted(by_g))
        assert abs(busy_g - busy_e) <= 0.1 * busy_e, (busy_g, busy_e)
        log(f"phase graphs {label}: {len(d.schedule)} ops, "
            f"{sum(eager_inf.values())} kernel launches; graphed == eager "
            f"({'bit-exact, every arena byte' if exact else 'within F32_TOL'}"
            f") for two requests in a row and a serve of 7 at micro_batch 4 "
            f"(2 dispatches, 1 pad lane); launches/inference through replays "
            f"{graph_inf} == eager; capture {cap.capture_ms:.3f} ms "
            f"(warm-up {cap.warmup_ms:.3f} ms); run p50 eager "
            f"{p50['eager']:.3f} ms, graphed {p50['graphed']:.3f} ms; serve "
            f"eager {rps_eager:.2f} req/s, graphed {rps_graphed:.2f} req/s; "
            f"device busy/run (profiler) eager {busy_e:.5f} ms, graphed "
            f"{busy_g:.5f} ms (port kernels inside the replays: "
            + ", ".join(f"{n} {v:.5f} ms" for n, v in sorted(seen.items()))
            + f"); idle share eager {1 - busy_e / p50['eager']:.3f}, "
            f"graphed {1 - busy_g / p50['graphed']:.3f} [{self.card}] "
            f"({time.perf_counter() - t0:.2f} s)")

    def table1(self, d, device):
        """The paper's Table 1 on the card: the int8 SwiftNet cell fits
        512 KB - 200 KB of SRAM only in the reordered order."""
        from repro_torch.mcu import MicroInterpreter
        np = self.np
        t0 = time.perf_counter()
        g = d.exec_graph
        x = self.random_input(g, seed=7)
        self.reset()
        interp = MicroInterpreter(g, capacity=TABLE1_CAPACITY, device=device)
        try:
            interp.run(x, schedule=g.default_schedule())
        except MemoryError as e:
            overflow = str(e)
        else:
            raise AssertionError("the default order fit in "
                                 f"{TABLE1_CAPACITY} B; Table 1 says not")
        rep = interp.run(x, schedule=d.schedule)
        full = MicroInterpreter(g, device=device).run(x)
        launches = self.read()
        got = {k: (r.peak_sram, r.bytes_moved, r.defrag_passes, r.steps)
               for k, r in (("reordered", rep), ("default", full))}
        assert rep.fits and got == TABLE1, got
        compiled = d.run(x)
        for o in g.outputs:
            np.testing.assert_array_equal(rep.outputs[o], compiled[o])
            np.testing.assert_array_equal(full.outputs[o], compiled[o])
        assert all(launches[n] > 0 for n in ("qconv1x1", "qdwconv", "qconv"))
        log(f"phase table1: MicroInterpreter on {device}, capacity "
            f"{TABLE1_CAPACITY} B: default order -> MemoryError "
            f"({overflow}); reordered fits, peak_sram/bytes_moved/"
            f"defrag_passes/steps {got['reordered']}; default unconstrained "
            f"{got['default']}; outputs == compiled executor (bit-exact); "
            f"launches {launches}; reordered run {rep.wall_time_s:.3f} s "
            f"[{self.card}] ({time.perf_counter() - t0:.2f} s)")

    def sharded(self, label, d, seed, exact):
        """``phase sharded``: ``ShardedServingEngine(d, replicas=None,
        lanes=4)`` serves 11 requests submitted up front, then the same
        11 as late arrivals between ``step``s with mixed priorities; every
        output equal to ``Deployment.run`` of that request alone, launches
        per dispatch through the replays equal to the eager program's over
        a 4-lane arena; requests/s and p50/p99 latency in turns with
        ``GraphServingEngine``'s graphed serve at ``micro_batch`` 4; the
        degradation path (a ``FaultPlan`` failing ``engine_init``);
        ``replicas=2`` clipped to the device count.  Returns the engine's
        stats of the up-front serve."""
        from repro_torch.serving import FaultPlan, ShardedServingEngine
        np, torch = self.np, self.torch
        t0 = time.perf_counter()
        ex, g = d.executor, d.graph
        (name,) = g.outputs
        reqs = [self.random_input(g, seed=seed + s) for s in range(11)]
        refs = [d.run(r)[name] for r in reqs]
        self.reset()
        ex.execute(ex.new_arena(4))
        eager = {n: v for n, v in self.read().items() if v}
        eng = ShardedServingEngine(d, replicas=None, lanes=4)
        n_dev = torch.cuda.device_count()
        assert (eng.replicas, eng.capacity) == (n_dev, 4 * n_dev)
        ex.batched_fn(4).capture()      # before the counts (see graphs())
        # up front: 11 requests, 3 dispatches of 4 lanes, 1 pad lane
        self.reset()
        outs = eng.serve(reqs)
        launches = {n: v for n, v in self.read().items() if v}
        st = eng.stats
        n_disp = -(-11 // eng.capacity)
        assert (st.requests, st.dispatches, st.padded_lanes) == \
            (11, n_disp, n_disp * eng.capacity - 11), st.as_json()
        assert launches == {n: v * n_disp for n, v in eager.items()}, (
            launches, eager)
        for o, want in zip(outs, refs):
            self.same(o[name], want, exact)
        up_front = st.as_json()
        # late arrivals with mixed priorities between steps
        prio = [0, 1, 0, 2, 0, 1, 0, 3, 1, 0, 2]
        rids = [eng.submit(r, priority=p)
                for r, p in zip(reqs[:3], prio[:3])]
        eng.step()
        rids += [eng.submit(r, priority=p)
                 for r, p in zip(reqs[3:7], prio[3:7])]
        eng.step()
        rids += [eng.submit(r, priority=p)
                 for r, p in zip(reqs[7:], prio[7:])]
        done = eng.drain()
        assert sorted(done) == sorted(rids)
        for rid, want in zip(rids, refs):
            self.same(done[rid][name], want, exact)
        late = eng.stats.as_json()
        # requests/s in turns with the single-device graphed engine
        geng = d.engine(micro_batch=4)
        geng.serve(reqs)
        rps = {"sharded": [], "graph": []}
        lat = {"p50": [], "p99": []}
        for _ in range(5):
            eng.serve(reqs)
            rps["sharded"].append(eng.stats.requests_per_s)
            lat["p50"].append(eng.stats.p50_ms)
            lat["p99"].append(eng.stats.p99_ms)
            geng.serve(reqs)
            rps["graph"].append(geng.stats.requests_per_s)
        med = {k: statistics.median(v) for k, v in {**rps, **lat}.items()}
        # degradation and clipping
        deg = ShardedServingEngine(d, replicas=None, lanes=4,
                                   faults=FaultPlan(fail_engine_init=True))
        for o, want in zip(deg.serve(reqs), refs):
            self.same(o[name], want, exact)
        assert deg.replicas == 1 and any(
            "falling back to single-device" in n
            for n in deg.stats.degraded), deg.stats.degraded
        clipped = ShardedServingEngine(d, replicas=2, lanes=4).replicas
        assert clipped == min(2, n_dev), clipped
        log(f"phase sharded {label}: ShardedServingEngine replicas "
            f"{eng.replicas} (device count {n_dev}) x lanes 4; 11 requests "
            f"up front: dispatches {up_front['dispatches']}, padded_lanes "
            f"{up_front['padded_lanes']}; late arrivals between steps with "
            f"priorities {prio}: dispatches {late['dispatches']}, "
            f"padded_lanes {late['padded_lanes']}; every output == "
            f"Deployment.run alone ({'bit-exact' if exact else 'within F32_TOL'}"
            f"); launches/dispatch through the replays {eager} == eager "
            f"execute over 4 lanes ({sum(eager.values()) * n_disp / 11:.2f} "
            f"a request); median of 5 serves in turns: sharded "
            f"{med['sharded']:.2f} req/s (p50 {med['p50']:.3f} ms, p99 "
            f"{med['p99']:.3f} ms), GraphServingEngine micro_batch 4 "
            f"{med['graph']:.2f} req/s; all 5: sharded "
            + ", ".join(f"{v:.2f}" for v in rps["sharded"]) + "; graph "
            + ", ".join(f"{v:.2f}" for v in rps["graph"])
            + f"; degraded (engine_init fault): {deg.stats.degraded[-1]!r}, "
            f"same outputs; replicas=2 -> {clipped} [{self.card}] "
            f"({time.perf_counter() - t0:.2f} s)")
        return eng

    def chaos(self, label, d, seed, exact):
        """One seeded chaos plan on the card: device errors, arena
        corruption (the injector's lane report) and NaN poison; every
        request ends as a result equal to ``Deployment.run`` or a typed
        ``RequestError``, and the counters balance the injector's
        ledger."""
        from repro_torch.serving import (FaultInjector, FaultPlan,
                                         RequestError, ShardedServingEngine)
        t0 = time.perf_counter()
        g = d.graph
        (name,) = g.outputs
        inj = FaultInjector(FaultPlan(seed=CHAOS_SEED, device_error_rate=0.15,
                                      corrupt_rate=0.25, nan_rate=0.25))
        eng = ShardedServingEngine(d, replicas=None, lanes=4, max_retries=2,
                                   faults=inj)
        reqs = [self.random_input(g, seed=seed + s) for s in range(12)]
        rids = [eng.submit(r) for r in reqs]
        done = eng.drain()
        results = [done[rid] for rid in rids]
        codes = [r.code if isinstance(r, RequestError) else "ok"
                 for r in results]
        assert set(codes) <= {"ok", "corrupted", "nan_output",
                              "dispatch_failed"}, codes
        for r, out in zip(reqs, results):
            if not isinstance(out, RequestError):
                self.same(out[name], d.run(r)[name], exact)
        led, s = inj.injected, eng.stats
        assert all(led[k] > 0 for k in ("device_error", "corrupt", "nan")), led
        assert "ok" in codes and len(set(codes)) > 1, codes
        poison = sum(c in ("corrupted", "nan_output") for c in codes)
        assert s.retried == led["device_error"] + led["corrupt"] + \
            led["nan"] - poison, (s.as_json(), led)
        assert s.failed == poison + codes.count("dispatch_failed")
        assert s.admitted >= 12 - codes.count("dispatch_failed")
        log(f"phase sharded chaos {label}: FaultPlan(seed={CHAOS_SEED}, "
            f"device_error "
            f"0.15, corrupt 0.25, nan 0.25), 12 requests: results "
            f"{ {c: codes.count(c) for c in sorted(set(codes))} }, ledger "
            f"{led}, retried {s.retried}, failed {s.failed}, dispatches "
            f"{s.dispatches}; every ok result == Deployment.run, every "
            f"other a typed RequestError [{self.card}] "
            f"({time.perf_counter() - t0:.2f} s)")

    def fused_add(self, deployments, device):
        """``kernels.qconv_add_fused`` at every int8 conv shape of the
        given deployments, with a seeded residual: K4/K5 launched, each
        output equal to ``qconv_fused`` then ``qadd``."""
        import repro_torch.kernels as kernels
        from repro_torch.kernels.conv_quant.ref import qadd
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        rng = np.random.default_rng(3)
        calls, seen = [], set()
        for d in deployments:
            g = d.exec_graph
            for op in d.schedule:
                a = op.attrs
                shape = (g.tensors[op.inputs[0]].shape, a["weight_q"].shape,
                         a["stride"]) if op.kind == "qconv" else None
                if shape is None or shape in seen:
                    continue
                seen.add(shape)
                x = torch.as_tensor(rng.integers(-128, 128, shape[0],
                                                 dtype=np.int8),
                                    device=device)
                w = torch.as_tensor(a["weight_q"], device=device)
                r = torch.as_tensor(rng.integers(
                    -128, 128, g.tensors[op.output].shape, dtype=np.int8),
                    device=device)
                qp = dict(stride=a["stride"], mult=a["mult"],
                          zp_in=a["zp_in"], zp_out=a["zp_out"])
                calls.append((x, w, r, qp, add_params(ADD_QP[0],
                                                      a["zp_out"])))
        self.reset()
        outs = [kernels.qconv_add_fused(x, w, r, add_params=ap, **qp)
                for x, w, r, qp, ap in calls]
        launches = self.read()
        for (x, w, r, qp, ap), got in zip(calls, outs):
            want = qadd(kernels.qconv_fused(x, w, **qp), r, *ap)
            assert torch.equal(got, want)
        assert launches["qconv1x1_add"] > 0 and launches["qconv_add"] > 0
        log(f"phase fused-add: kernels.qconv_add_fused at {len(calls)} conv "
            f"shapes of the int8 schedules, launches {launches}, each == "
            f"qconv_fused then qadd (bit-exact) "
            f"({time.perf_counter() - t0:.2f} s)")


# phase sharded's chaos plan: with 12 requests over 4 lanes this seed
# fires every fault kind and ends some requests in typed errors
CHAOS_SEED = 43
# phase fx: the reference tests' programs (tests/test_jaxpr_reorder.py's
# branchy_fn, tests/test_partition.py's MLP), at the tests' row counts and
# at FX_ROWS.  A +pex program computes each mm in row slices, and cuBLAS
# picks its float32 GEMM kernel, and with it the order of the K sum, by
# the row count: the +pex output is held to the float32 accumulation
# bound of its mms (F32_BOUND, as K6's check) carried through the program
# (``fx_pex_bound``).  The reference test's own constants (FX_MM_TOL) hold
# on the CPU (tests/test_torch_fx_partial.py); on the card the count of
# outputs outside them is printed.
FX_ROWS = 4096
FX_MM_TOL = dict(rtol=2e-6, atol=1e-6)
# float32 unit roundoff; CUDA's tanhf is within 2 ulp
F32_EPS = 2.0 ** -24
TANH_ULPS = 2


def fx_pex_bound(torch, program, x, w):
    """Per output, the most two float32 evaluations of ``program`` whose
    mms sum K in two orders can differ: ``F32_BOUND * (K + 2) * (|a| @
    |b|)`` for each mm and sum, tanh's ulps, and every difference carried
    forward (tanh is 1-Lipschitz), in float64."""
    def mm(a, b, da):
        bound = F32_BOUND * (a.shape[1] + 2) * (a.abs() @ b.abs())
        return bound if da is None else bound + da @ b.abs()

    def tanh(v, dv):
        t = torch.tanh(v)
        return t, dv + 2 * TANH_ULPS * 2 * F32_EPS * t.abs()

    x = x.double()
    if program == "mlp":
        w1, w2 = (v.double() for v in w)
        t, dt = tanh(x @ w1, mm(x, w1, None))
        return mm(t, w2, dt)
    t1 = torch.tanh(x)
    tm, dtm = tanh(t1 @ t1.T, mm(t1, t1.T, None))
    da = F32_BOUND * (tm.shape[1] + 2) * tm.abs().sum(dim=1) + dtm.sum(dim=1)
    out = tm.sum(dim=1) + t1.sum(dim=1)
    return da + 2 * F32_EPS * out.abs()


def fx_phase(torch, np, device, card, d):
    """``phase fx``: each program through ``fx_reorder.reorder`` (output
    equal to eager torch bit for bit) and ``reorder_graph_module(
    partition_budget=half the reordered peak)`` (a ``+pex`` program within
    ``fx_pex_bound`` of eager), on CUDA tensors; each report's peaks equal
    ``peak_liveness`` of the emitted module.  Prints each report and the
    host seconds of the trace and of the schedule.  Last, tracing the int8
    deployment ``d``'s arena program must stop at its first kernel with
    ``TraceError``, not record an unwritten output."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.fx_reorder import (peak_liveness, reorder,
                                             reorder_graph_module, trace)
    from repro_torch.errors import TraceError
    t_all = time.perf_counter()
    rng = np.random.default_rng(0)

    def dev_tensor(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    def branchy(x):
        t1 = torch.tanh(x)
        a = torch.tanh(t1 @ t1.T).sum(dim=1)
        return a + t1.sum(dim=1)

    w1, w2 = dev_tensor(32, 512), dev_tensor(512, 32)

    def mlp(x):
        return torch.tanh(x @ w1) @ w2

    for label, fn, shapes in (
            ("branchy 128x128", branchy, (128, 128)),
            (f"branchy {FX_ROWS}x128", branchy, (FX_ROWS, 128)),
            ("mlp 256x32", mlp, (256, 32)),
            (f"mlp {FX_ROWS}x32", mlp, (FX_ROWS, 32))):
        program = label.split()[0]
        x = dev_tensor(*shapes)
        want = fn(x)
        reports = []
        got = reorder(fn, report_to=reports)(x)
        assert torch.equal(got, want), label
        t0 = time.perf_counter()
        gm, leaves = trace(fn, x)
        torch.cuda.synchronize()
        t_trace = time.perf_counter() - t0
        new_gm, rep = reorder_graph_module(gm)
        t_sched = time.perf_counter() - t0 - t_trace
        assert (rep.peak_after, rep.changed) == (reports[0].peak_after,
                                                 reports[0].changed)
        assert rep.peak_after <= rep.peak_before
        assert peak_liveness(new_gm) == rep.peak_after
        assert torch.equal(new_gm(*leaves), want), label
        t0 = time.perf_counter()
        pgm, prep = reorder_graph_module(
            gm, partition_budget=rep.peak_after // 2)
        t_pex = time.perf_counter() - t0
        assert prep.method.endswith("+pex"), prep
        assert prep.peak_after < rep.peak_after
        assert peak_liveness(pgm) == prep.peak_after
        pgot = pgm(*leaves)
        err = (pgot - want).abs()
        bound = fx_pex_bound(torch, program, x, (w1, w2))
        ratio = float((err.double() / bound).max())
        n_tol = int((err > FX_MM_TOL["atol"]
                     + FX_MM_TOL["rtol"] * want.abs()).sum())
        log(f"phase fx {label}: reorder == eager (bit-exact); {rep}; "
            f"+pex: {prep}, max|+pex - eager| {float(err.max()):.3e}, "
            f"max |+pex - eager| / fx_pex_bound {ratio:.3e}; {n_tol} of "
            f"{want.numel()} outside the reference test's rtol "
            f"{FX_MM_TOL['rtol']}, atol {FX_MM_TOL['atol']}; host s: trace "
            f"{t_trace:.3f}, schedule {t_sched:.3f}, +pex rewrite and "
            f"schedule {t_pex:.3f} [{card}]")
        assert ratio <= 1.0, (label, ratio)
    ex = d.executor
    try:
        make_fx(lambda arena: ex.execute(arena))(ex.new_arena(1))
    except TraceError as e:
        refused = str(e)
    else:
        raise AssertionError("make_fx traced the arena program's kernels")
    log(f"phase fx: make_fx of the int8 arena program ({len(d.schedule)} "
        f"ops) -> TraceError ({refused.split(':')[0]}); "
        f"{time.perf_counter() - t_all:.2f} s")


class AttentionChecks:
    """K7 and K8 held against their plain versions on the card, once per
    launch configuration; ``record`` wraps the model's calls of the two
    kernels to collect the configurations the LLM phases launch."""

    def __init__(self, torch, np, device):
        from repro_torch.kernels.decode_attention import ops as dec_ops
        from repro_torch.kernels.decode_attention import ref as dec_ref
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        self.torch, self.np, self.device = torch, np, device
        self.fa_ops, self.fa_ref = fa_ops, fa_ref
        self.dec_ops, self.dec_ref = dec_ops, dec_ref
        self.gen = torch.Generator(device=device).manual_seed(1)
        self.seen = set()
        self.checked = {n: 0 for n in ATTENTION}
        self.mismatches = {n: 0 for n in ATTENTION}
        self.max_err = {n: 0.0 for n in ATTENTION}
        self.max_rel = {n: 0.0 for n in ATTENTION}
        self.main_k7, self.main_k8 = [], []    # configs the paths launched

    @contextlib.contextmanager
    def record(self):
        """Record every K7/K8 launch configuration of the model while the
        block runs eagerly (the wrappers' counts are untouched; a call
        that a CUDA graph is capturing is not recorded: its lengths exist
        only at replay)."""
        import repro_torch.kernels as kernels
        fa, dec = kernels.flash_attention, kernels.decode_attention
        capturing = self.torch.cuda.is_current_stream_capturing

        def flash(q, k, v, *, causal=True):
            if not capturing():
                self.main_k7.append((tuple(q.shape), tuple(k.shape),
                                     q.dtype, causal))
            return fa(q, k, v, causal=causal)

        def decode(q, k_cache, v_cache, lengths):
            if not capturing():
                self.main_k8.append((tuple(q.shape), tuple(k_cache.shape),
                                     q.dtype, lengths.clone()))
            return dec(q, k_cache, v_cache, lengths)

        kernels.flash_attention, kernels.decode_attention = flash, decode
        try:
            yield
        finally:
            kernels.flash_attention, kernels.decode_attention = fa, dec

    def _randn(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen,
                                device=self.device).to(dtype)

    def _compare(self, name, got, want):
        torch = self.torch
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        wmax = float(want.float().abs().max())
        if got.dtype == torch.float32:
            bound = F32_ATTN * wmax
        else:
            w = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
            ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
            bound = ulp + BF16_ATTN_ABS * wmax
        assert torch.isfinite(got.float()).all(), name
        self.mismatches[name] += int((diff > bound).sum())
        self.max_err[name] = max(self.max_err[name], float(diff.max()))
        self.max_rel[name] = max(self.max_rel[name],
                                 float(diff.max()) / max(wmax, 1e-30))
        self.checked[name] += 1

    def k7(self, B, Sq, Skv, H, K, D, dtype, causal, packed=False):
        key = ("k7", B, Sq, Skv, H, K, D, dtype, causal, packed)
        if key in self.seen:
            return
        self.seen.add(key)
        if packed:      # q/k/v as slices of one projection: strided heads
            assert Sq == Skv
            qkv = self._randn((B, Sq, H + 2 * K, D), dtype)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        else:
            q = self._randn((B, Sq, H, D), dtype)
            k = self._randn((B, Skv, K, D), dtype)
            v = self._randn((B, Skv, K, D), dtype)
        got = self.fa_ops.flash_attention(q, k, v, causal=causal)
        want = self.fa_ref.attention_ref(q, k, v, causal=causal)
        self._compare("flash_attention", got, want)

    def k8(self, B, S, H, K, D, dtype, lengths, strided=False):
        key = ("k8", B, S, H, K, D, dtype, tuple(lengths), strided)
        if key in self.seen:
            return
        self.seen.add(key)
        torch = self.torch
        q = self._randn((B, H, D), dtype)
        if strided == MISALIGNED:   # one element into a flat buffer
            n = B * S * K * D
            kc = self._randn((n + 1,), dtype)[1:].view(B, S, K, D)
            vc = self._randn((n + 1,), dtype)[1:].view(B, S, K, D)
        else:
            extra = 7 if strided else 0     # views of longer caches
            kc = self._randn((B, S + extra, K, D), dtype)[:, :S]
            vc = self._randn((B, S + extra, K, D), dtype)[:, :S]
        L = torch.tensor(lengths, dtype=torch.int32, device=self.device)
        got = self.dec_ops.decode_attention(q, kc, vc, L)
        want = self.dec_ref.decode_attention_ref(q, kc, vc, L)
        self._compare("decode_attention", got, want)

    def hostile(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for (B, Sq, Skv, H, K, D, causal, packed) in HOSTILE_K7:
                self.k7(B, Sq, Skv, H, K, D, dtype, causal, packed)
            for (B, S, H, K, D, lengths, strided) in HOSTILE_K8:
                self.k8(B, S, H, K, D, dtype, lengths, strided)

    def main_path(self):
        """Every distinct configuration the recorded phases launched."""
        n = len(self.seen)
        for (qs, ks, dtype, causal) in self.main_k7:
            B, Sq, H, D = qs
            self.k7(B, Sq, ks[1], H, ks[2], D, dtype, causal)
        for (qs, ks, dtype, lengths) in self.main_k8:
            B, H, D = qs
            self.k8(B, ks[1], H, ks[2], D, dtype, tuple(lengths.tolist()))
        return len(self.seen) - n

    def largest(self, name, first=None):
        """The main-path configuration of the most work: K7 by query x key
        pairs (among the first ``first`` recorded, if given), K8 by valid
        cache rows."""
        if name == "flash_attention":
            return max(self.main_k7[:first], key=lambda c: c[0][0]
                       * c[0][2] * c[0][1] * c[1][1])
        return max(self.main_k8, key=lambda c: c[0][1] * int(c[3].sum()))

    def timing(self, name, card, config=None, label="largest main-path"):
        """kernel_ms, plain_ms, library_ms and the bound at the largest
        main-path configuration of K7 or K8 (or at ``config``, one of
        ``main_k7`` or ``main_k8``), with the kernel's and the library's
        device time per call from the profiler."""
        torch = self.torch
        import torch.nn.functional as F
        if name == "flash_attention":
            (B, Sq, H, D), ks, dtype, causal = config or self.largest(name)
            Skv, K = ks[1], ks[2]
            q = self._randn((B, Sq, H, D), dtype)
            k = self._randn((B, Skv, K, D), dtype)
            v = self._randn((B, Skv, K, D), dtype)
            run = lambda: self.fa_ops.flash_attention(  # noqa: E731
                q, k, v, causal=causal)
            plain = lambda: self.fa_ref.attention_ref(  # noqa: E731
                q, k, v, causal=causal)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)
            # query-key pairs the causal mask keeps (queries are the last
            # Sq positions): each costs 2·D flops in q·k and 2·D in p·v
            off = Skv - Sq
            pairs = sum(min(Skv, max(0, off + i + 1)) for i in range(Sq)) \
                if causal else Sq * Skv
            flops = 4 * B * H * D * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            shape = (f"B{B} Sq{Sq} Skv{Skv} H{H}/K{K} D{D} {dtype} "
                     f"causal={causal}")
            lib_name = "F.scaled_dot_product_attention(is_causal, enable_gqa)"
        else:
            (B, H, D), ks, dtype, lengths = config or self.largest(name)
            S, K = ks[1], ks[2]
            q = self._randn((B, H, D), dtype)
            # each decode layer reads another layer's cache, which is not in
            # L2: successive calls cycle over K8_CACHES caches of > 50 MB
            caches = itertools.cycle([
                (self._randn((B, S, K, D), dtype),
                 self._randn((B, S, K, D), dtype))
                for _ in range(K8_CACHES)])
            L = lengths.to(self.device)
            run = lambda: self.dec_ops.decode_attention(  # noqa: E731
                q, *next(caches), L)
            plain = lambda: self.dec_ref.decode_attention_ref(  # noqa: E731
                q, *next(caches), L)
            mask = (torch.arange(S, device=self.device)[None]
                    < L[:, None])[:, None, None, :]

            def lib():
                kc, vc = next(caches)
                return F.scaled_dot_product_attention(
                    q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)
            rows = int(lengths.sum())
            flops = 4 * H * D * rows
            nbytes = (2 * q.numel() + 2 * rows * K * D) * q.element_size() \
                + 4 * B
            shape = (f"B{B} S{S} H{H}/K{K} D{D} {dtype} lengths "
                     f"{sorted(set(lengths.tolist()))}")
            lib_name = (f"F.scaled_dot_product_attention(bool mask, "
                        f"enable_gqa); {K8_CACHES} caches in turn, cold in L2")
        peak = H100_BF16_OPS_PER_S if dtype == torch.bfloat16 \
            else H100_F32_OPS_PER_S
        kernel_ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=10, warmup=2)
        library_ms = time_ms(torch, lib)
        dev_ms, lib_dev_ms = (device_time(torch, f, reps=12)[0]
                              for f in (run, lib))
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        log(f"kernels {name}: {self.checked[name]} configs, "
            f"{self.mismatches[name]} mismatches, max_abs_err "
            f"{self.max_err[name]:.3e}, max_rel_err {self.max_rel[name]:.3e} "
            f"(of max|want|); at the {label} {shape}: kernel_ms "
            f"{kernel_ms:.5f}, "
            f"plain_ms {plain_ms:.5f}, library_ms {library_ms:.5f} "
            f"({lib_name}); device_ms {dev(dev_ms)}, library "
            f"{dev(lib_dev_ms)} "
            f"(profiler); bound_ms {max(t_bytes, t_ops):.7f} "
            f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) [{card}]")
        return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    shape=shape)


    def k8_splits(self, card, config, splits):
        """K8 at ``config`` (one of ``main_k8``) with each cluster size of
        ``splits`` forced through the planner hook ``dec_ops._plan``:
        held against the plain version, then event and device time over
        K8_CACHES caches in turn (cold in L2)."""
        torch, dec = self.torch, self.dec_ops
        hook = getattr(dec, "_plan", None)
        if hook is None:
            return
        (B, H, D), ks, dtype, lengths = config
        S, K = ks[1], ks[2]
        q = self._randn((B, H, D), dtype)
        caches = [(self._randn((B, S, K, D), dtype),
                   self._randn((B, S, K, D), dtype))
                  for _ in range(K8_CACHES)]
        cyc = itertools.cycle(caches)
        L = lengths.to(self.device)
        want = self.dec_ref.decode_attention_ref(q, *caches[0], L)
        times = []
        for n in splits:
            dec._plan = lambda *a, n=n: n     # noqa: E731
            try:
                self._compare("decode_attention",
                              dec.decode_attention(q, *caches[0], L), want)

                def run():
                    return dec.decode_attention(q, *next(cyc), L)
                times.append((n, time_ms(torch, run),
                              device_time(torch, run, reps=12)[0]))
            finally:
                dec._plan = hook
        log(f"kernels decode_attention forced splits at B{B} S{S} H{H}/K{K} "
            f"D{D} {dtype} lengths {sorted(set(lengths.tolist()))} (L2 "
            f"cold): " + "; ".join(f"split {n}: kernel_ms {e:.5f}, "
                                   f"device_ms {dev(t)}" for n, e, t in times)
            + f"; planned {dec._plan(B, K, S, self.device.index or 0)}, "
            f"mismatches {self.mismatches['decode_attention']} [{card}]")


def attn_layers(cfg) -> int:
    """K7 launches per prefill and K8 launches per decode step: one per
    layer of a uniform stack, one per group of Zamba2 (its shared attention
    block), none in xLSTM."""
    from repro_torch.models.model import model_layout
    lay = model_layout(cfg)
    return {"uniform": cfg.num_layers, "zamba": lay.groups}.get(lay.kind, 0)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def cut_depth(params, layers):
    """The weights of a model's first ``layers`` layers: a uniform stack's
    first layers, or for Zamba2 and xLSTM (``layers`` a multiple of 6)
    the first ``layers // 6`` groups, the shared attention block whole."""
    g = layers // 6
    keep = {"blocks": layers, "mamba": layers, "mlstm": 5 * g, "slstm": g}
    return {k: ({n: t[:keep[k]] for n, t in v.items()} if k in keep else v)
            if isinstance(v, dict) else v for k, v in params.items()}


class Llm:
    """An LLM serving path of the port at full width and depth in bf16
    through ``repro_torch.launch.serve``'s engine, K7 on every prefill
    attention, K8 on every decode attention: Llama-3.2-3B (``LLM_ARCH``),
    the MoE decoder Granite-3.0-1B-A400M (``MOE_ARCH``), or a recurrent
    decoder of ``SSM_MIXES`` (Zamba2: one attention a group; xLSTM:
    none)."""

    def __init__(self, torch, np, device, paths, attn, card, arch=LLM_ARCH,
                 mix=LLM_MIXES[0]):
        from repro_torch.configs import get_config
        from repro_torch.launch import serve as launch_serve
        from repro_torch.models.model import model_layout
        self.torch, self.np, self.device = torch, np, device
        self.paths, self.attn, self.card = paths, attn, card
        self.launch_serve = launch_serve
        t0 = time.perf_counter()
        self.cfg = get_config(arch)
        self.n_attn = attn_layers(self.cfg)
        lay = model_layout(self.cfg)
        # the launcher's own engine: random bf16 weights drawn on the card
        self.engine = launch_serve.build_engine(
            arch, max_batch=mix[4], cache_len=mix[5], device=device)
        self.params = self.engine.params
        torch.cuda.synchronize()
        n = sum(t.numel() for t in self._leaves(self.params))
        moe = (f", {self.cfg.num_experts} experts top "
               f"{self.cfg.experts_per_token}, capacity factor "
               f"{self.cfg.capacity_factor}" if self.cfg.is_moe else "")
        if lay.kind != "uniform":
            moe += (f", layout {lay.kind}: {lay.groups} groups of "
                    f"{lay.per_group}, {self.n_attn} attention "
                    f"applications a step")
        log(f"phase llm-init: {arch} ({self.cfg.num_layers} layers, d "
            f"{self.cfg.d_model}, {self.cfg.num_heads} heads / "
            f"{self.cfg.num_kv_heads} kv heads of {self.cfg.head_dim_}, "
            f"d_ff {self.cfg.d_ff}{moe}, vocab {self.cfg.vocab_size}, "
            f"{self.cfg.dtype}): {n} parameters drawn on the card, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
            f"({time.perf_counter() - t0:.2f} s)")

    @staticmethod
    def _leaves(tree):
        for v in tree.values():
            yield from (Llm._leaves(v) if isinstance(v, dict) else (v,))

    def _requests(self, n, prompt, max_new):
        from repro_torch.serving import Request
        if prompt is None:      # the reference launcher's traffic
            return self.launch_serve.make_requests(self.cfg, n, max_new)
        rng = self.np.random.default_rng(1)
        return [Request(rid=i, prompt=rng.integers(
            0, self.cfg.vocab_size, prompt).astype(self.np.int32),
            max_new_tokens=max_new) for i in range(n)]

    def serve(self, label, n, prompt, max_new, max_batch, cache_len,
              block_bytes):
        """One traffic mix through ``ServingEngine.serve``: a warm-up
        batch (which captures the decode step of ``max_batch`` rows), then
        the counted run (K7 28x per prefill, K8 28x per replayed decode
        step), then a profiled run for the device's busy time.  Returns
        (engine, requests, results, profiler busy ms)."""
        from repro_torch.serving import ServingEngine
        torch, np, L = self.torch, self.np, self.n_attn
        t0 = time.perf_counter()
        eng = ServingEngine(self.cfg, self.params, max_batch=max_batch,
                            cache_len=cache_len, device=self.device)
        assert eng.block_bytes == block_bytes, (eng.block_bytes, block_bytes)
        reqs = self._requests(n, prompt, max_new)
        assert n % max_batch == 0      # every batch replays one graph
        eng.serve(reqs[:max_batch])                       # warm-up
        self.paths.reset()
        with self.attn.record():
            results = eng.serve(reqs)
        launches = self.paths.read()
        batches = [reqs[i:i + max_batch] for i in range(0, n, max_batch)]
        steps = sum(max(r.max_new_tokens for r in b) - 1 for b in batches)
        want = {"flash_attention": L * len(batches),
                "decode_attention": L * steps}
        assert {k: launches[k] for k in ATTENTION} == want, (launches, want)
        assert all(v == 0 for k, v in launches.items()
                   if k not in ATTENTION), launches
        for r, q in zip(results, reqs):
            assert r.rid == q.rid and len(r.tokens) == q.max_new_tokens
            assert all(0 <= t < self.cfg.vocab_size for t in r.tokens)
        st = eng.stats
        assert st.kv_arena_peak_bytes == max_batch * block_bytes
        assert st.kv_static_bytes == n * block_bytes
        assert st.peak_concurrent == max_batch and st.requests == n
        per_batch = [(results[i].prefill_ms, results[i].decode_ms)
                     for i in range(0, n, max_batch)]
        dec_tokens = sum(len(b) * (max(r.max_new_tokens for r in b) - 1)
                         for b in batches)
        dec_s = sum(d for _, d in per_batch) / 1e3
        wall_ms = st.wall_s * 1e3
        busy, top, by_name = device_time(torch, lambda: eng.serve(reqs),
                                         reps=1)
        log(f"phase llm-{label}: {n} requests (prompts "
            f"{sorted({len(r.prompt) for r in reqs})} tokens), {max_new} new "
            f"tokens each, max_batch {max_batch}, cache_len {cache_len}: "
            f"launches {launches} (K7 {L}/prefill, K8 {L}/decode step); "
            f"per batch prefill_ms/decode_ms "
            + ", ".join(f"{p:.3f}/{d:.3f}" for p, d in per_batch)
            + f"; graphed decode {1e3 * dec_s / steps:.3f} ms/step, "
            f"{dec_tokens / dec_s:.2f} tokens/s; serve wall {wall_ms:.3f} ms, "
            f"device busy {busy:.3f} ms (profiler), idle share "
            f"{1 - busy / wall_ms:.3f}; top "
            + ", ".join(f"{nm} {t:.3f} ms" for nm, t in top)
            + f"; K8 share (profiler) "
            f"{shares(by_name, busy, ['decode_attention'])}; block_bytes "
            f"{eng.block_bytes} B, kv_arena_peak_bytes "
            f"{st.kv_arena_peak_bytes} B, kv_static_bytes "
            f"{st.kv_static_bytes} B, peak_concurrent {st.peak_concurrent}; "
            f"first tokens {results[0].tokens[:6]} [{self.card}] "
            f"({time.perf_counter() - t0:.2f} s)")
        return eng, reqs, results, busy, by_name, wall_ms

    def _eager_batch(self, model, batch, cache_len, logits_out=None):
        """One batch the engine's way with an eager loop of
        ``Model.decode_step``: (tokens per row, decode ms from the first
        argmax to the host's read of the tokens)."""
        torch = self.torch
        logits, cache = model.prefill(
            self.params, {"tokens": torch.as_tensor(self._padded(batch),
                                                    device=self.device)},
            cache_len=cache_len)
        torch.cuda.synchronize()
        max_new = max(r.max_new_tokens for r in batch)
        t0 = time.perf_counter()
        tok = torch.argmax(logits, -1)
        out = [tok]
        for _ in range(1, max_new):
            logits, cache = model.decode_step(self.params, cache, tok)
            if logits_out is not None:
                logits_out.append(logits)
            tok = torch.argmax(logits, -1)
            out.append(tok)
        host = torch.stack(out, 1).tolist()
        return host, (time.perf_counter() - t0) * 1e3

    def graphs(self, label, eng, reqs, results, busy_g, by_g, wall_g):
        """``phase graphs`` of an LLM mix: the engine's captured decode
        step against an eager loop of ``Model.decode_step`` driven here
        (the engine has no eager switch): served tokens equal, the
        captured step's logits within ``CONT_TOL`` of the eager step's
        (teacher-forced), decode ms/step and tokens/s, device busy and
        idle share of each, capture ms.  The profiler must see K8 inside
        the replays, the busy time within 10 % of eager's."""
        from repro_torch.models import Model
        torch = self.torch
        t0 = time.perf_counter()
        model = Model(self.cfg)
        mb, cache_len = eng.max_batch, eng.cache_len
        batches = [reqs[i:i + mb] for i in range(0, len(reqs), mb)]
        steps = sum(max(r.max_new_tokens for r in b) - 1 for b in batches)
        tokens = sum(len(b) * (max(r.max_new_tokens for r in b) - 1)
                     for b in batches)
        logits = [[] for _ in batches]
        with self.attn.record():
            for b, out in zip(batches, logits):
                self._eager_batch(model, b, cache_len, out)
        t1 = time.perf_counter()
        eager = [self._eager_batch(model, b, cache_len) for b in batches]
        wall_e = (time.perf_counter() - t1) * 1e3
        served = {r.rid: r.tokens for r in results}
        for b, (host, _) in zip(batches, eager):
            for r, row in zip(b, host):
                assert served[r.rid] == row[:r.max_new_tokens], (
                    label, r.rid, served[r.rid], row)
        # the captured step, teacher-forced with the eager tokens
        err = scale = 0.0
        for b, want in zip(batches, logits):
            first, cache = model.prefill(
                self.params, {"tokens": torch.as_tensor(self._padded(b),
                                                        device=self.device)},
                cache_len=cache_len)
            step = eng.decode_step(len(b))
            step.load(cache, torch.argmax(first, -1))
            del cache
            for i, w in enumerate(want):
                step()
                err = max(err, float((step.logits - w).abs().max()))
                scale = max(scale, float(w.abs().max()))
                if i + 1 < len(want):
                    step.tok.copy_(torch.argmax(w, -1))
        del logits
        # the captured step alone, replayed back to back
        step_ms = time_ms(torch, step, iters=20, warmup=2)
        step_busy, step_top, _ = device_time(torch, step, reps=5)
        dec_e = sum(ms for _, ms in eager) / 1e3
        dec_g = sum(results[i].decode_ms
                    for i in range(0, len(reqs), mb)) / 1e3
        busy_e, _, _ = device_time(
            torch, lambda: [self._eager_batch(model, b, cache_len)
                            for b in batches], reps=1)
        k8 = "decode_attention_kernel"
        assert busy_g > 0 and (by_g.get(k8, 0) > 0) == (self.n_attn > 0), (
            "the profiler saw K8 inside the decode replays, or not, "
            "against the model's attention count", busy_g, sorted(by_g))
        assert abs(busy_g - busy_e) <= 0.1 * busy_e, (busy_g, busy_e)
        cap = eng.decode_step(mb).graph
        log(f"phase graphs llm-{label}: served tokens == eager loop of "
            f"Model.decode_step (all {len(reqs)} requests); captured step "
            f"vs eager step max|delta logit| {err:.5f} of max|logit| "
            f"{scale:.5f} (ratio {err / scale:.5f}, tolerance {CONT_TOL}); "
            f"decode ms/step eager {1e3 * dec_e / steps:.3f}, graphed "
            f"{1e3 * dec_g / steps:.3f}; tokens/s eager "
            f"{tokens / dec_e:.2f}, graphed {tokens / dec_g:.2f}; the step "
            f"replayed back to back {step_ms:.3f} ms (events), device busy "
            f"{step_busy:.3f} ms (profiler), top "
            + ", ".join(f"{nm} {t:.3f} ms" for nm, t in step_top)
            + f"; capture "
            f"{cap.capture_ms:.3f} ms (warm-up {cap.warmup_ms:.3f} ms), "
            f"K8 {cap.launches['decode_attention']} launches/replay; serve "
            f"device busy (profiler) eager {busy_e:.3f} ms, graphed "
            f"{busy_g:.3f} ms (K8 inside the replays "
            f"{by_g.get(k8, 0.0):.3f} ms); idle share eager "
            f"{1 - busy_e / wall_e:.3f} of {wall_e:.3f} ms, graphed "
            f"{1 - busy_g / wall_g:.3f} of {wall_g:.3f} ms [{self.card}] "
            f"({time.perf_counter() - t0:.2f} s)")
        assert err <= CONT_TOL * scale, (err, scale)

    def _padded(self, batch):
        """The batch's prompts left-padded with token 0, as the engine
        pads them."""
        np = self.np
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((len(batch), S), np.int64)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt
        return toks

    def float32(self, **changes):
        """(config, parameters) of this model in float32 — the same
        weights, widened exactly — with ``changes`` to the config."""
        assert not self.torch.backends.cuda.matmul.allow_tf32
        params = tree_map(lambda t: t.to(self.torch.float32), self.params)
        return self.cfg.replace(dtype="float32", **changes), params

    def continuation(self, label="llm", cfg=None, params=None,
                     tol=CONT_TOL):
        """Decoding token t after a prefill of t-1 tokens gives the logits
        of prefilling t tokens (tests/test_arch_smoke.py:78-93) at full
        width and depth: K7 against K8.  ``cfg``/``params`` replace the
        served model (the MoE check runs it in float32)."""
        from repro_torch.models import Model
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        cfg, params = cfg or self.cfg, params or self.params
        model = Model(cfg)
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, CONT_T)), device=self.device)
        self.paths.reset()
        with self.attn.record():
            full, _ = model.prefill(params, {"tokens": toks})
            _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                     cache_len=CONT_T)
            dec, _ = model.decode_step(params, cache, toks[:, -1])
        launches = self.paths.read()
        assert launches["flash_attention"] == 2 * attn_layers(cfg)
        assert launches["decode_attention"] == attn_layers(cfg)
        assert torch.isfinite(full).all() and torch.isfinite(dec).all()
        err = float((dec - full).abs().max())
        scale = float(full.abs().max())
        log(f"phase {label}-continuation: B 2, t {CONT_T}, {cfg.dtype}"
            + (f", capacity factor {cfg.capacity_factor}" if cfg.is_moe
               else "")
            + f": max|decode(t) - prefill(t)| {err:.3e} of max|logit| "
            f"{scale:.5f} (ratio {err / scale:.3e}, tolerance {tol}); "
            f"launches {launches} ({time.perf_counter() - t0:.2f} s)")
        assert err <= tol * scale, (err, scale)

    def card_vs_cpu(self, label="llm", cfg=None, params=None, tol=CPU_TOL,
                    layers=CPU_LAYERS):
        """A ``layers``-layer variant at full width (the first layers'
        weights; whole groups for Zamba2 and xLSTM) on the card and on the
        port's plain CPU path: prefill and teacher-forced decode steps
        agree.  ``cfg``/``params`` replace the served model (the MoE and
        recurrent checks run it in float32)."""
        from repro_torch.models import Model
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        cfg, params = cfg or self.cfg, params or self.params
        cfg = cfg.replace(num_layers=layers)
        card = cut_depth(params, layers)
        cpu = tree_map(lambda t: t.cpu(), card)
        model = Model(cfg)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab_size, (2, CPU_S))
        steps = rng.integers(0, cfg.vocab_size, (CPU_STEPS, 2))
        self.paths.reset()
        with self.attn.record():
            got = [model.prefill(card, {"tokens": torch.as_tensor(
                toks, device=self.device)}, cache_len=CPU_S + CPU_STEPS)]
            for t in steps:
                got.append(model.decode_step(card, got[-1][1],
                                             torch.as_tensor(t)))
        launches = self.paths.read()
        want = [model.prefill(cpu, {"tokens": torch.as_tensor(toks)},
                              cache_len=CPU_S + CPU_STEPS)]
        for t in steps:
            want.append(model.decode_step(cpu, want[-1][1],
                                          torch.as_tensor(t)))
        ratios = []
        for (g, _), (w, _) in zip(got, want):
            err = float((g.cpu() - w).abs().max())
            ratios.append(err / float(w.abs().max()))
        assert launches["flash_attention"] == attn_layers(cfg)
        assert launches["decode_attention"] == attn_layers(cfg) * CPU_STEPS
        log(f"phase {label}-card-vs-cpu: {layers} layers at full width, "
            f"prefill of {CPU_S} tokens + {CPU_STEPS} decode steps, "
            f"{cfg.dtype}: max|card - cpu| / max|cpu logit| per call "
            + ", ".join(f"{r:.3e}" for r in ratios)
            + f" (tolerance {tol}); launches {launches} "
            f"({time.perf_counter() - t0:.2f} s)")
        assert max(ratios) <= tol, ratios

    def reorder(self, label, caches):
        """``phase llm-reorder``: ``ServingEngine.analyse_decode_schedule
        (REORDER_B)`` at each cache length of ``caches`` — the report, the
        layer stack one operator, the host seconds of trace and schedule
        (shapes only: no cache is allocated, no kernel launched) — then
        the reordered step at the first against the eager
        ``decode_step``: after a prefill of the short mix's first batch,
        one step of each on copies of one cache, logits and every cache
        tensor bit-equal, K8 launched once a layer through the reordered
        module.  Both run the same aten calls and K8 launches on the same
        operands, only the nodes outside the layer operator in another
        order, so nothing may differ."""
        from repro_torch.models import Model
        from repro_torch.serving import ServingEngine
        torch, L = self.torch, self.n_attn
        stack_ops = (torch.ops.repro_torch.decode_layers.default,
                     torch.ops.repro_torch.decode_recurrent_layers.default)
        t0 = time.perf_counter()
        reports = []
        for cache_len in caches:
            eng = ServingEngine(self.cfg, self.params, max_batch=REORDER_B,
                                cache_len=cache_len, device=self.device)
            mem = torch.cuda.memory_allocated()
            t = time.perf_counter()
            rep = eng.analyse_decode_schedule(REORDER_B)
            secs = time.perf_counter() - t
            assert torch.cuda.memory_allocated() == mem   # nothing on card
            ops = [n for n in eng.reordered_step.gm.graph.nodes
                   if n.target in stack_ops]
            assert len(ops) == 1 and rep.peak_after <= rep.peak_before
            assert eng.reorder_report is rep
            reports.append((cache_len, rep, secs))
            if len(reports) == 1:
                first = eng
        model = Model(self.cfg)
        prompts = self._padded(self._requests(REORDER_B, None, 2))
        logits, cache = model.prefill(
            self.params, {"tokens": torch.as_tensor(prompts,
                                                    device=self.device)},
            cache_len=caches[0])
        tok = torch.argmax(logits, -1)
        mine = {n: t.clone() for n, t in cache.items()}
        self.paths.reset()
        with self.attn.record():
            got, mine = first.reordered_step(self.params, mine, tok)
        launches = self.paths.read()
        assert launches["decode_attention"] == L, launches
        assert all(v == 0 for k, v in launches.items()
                   if k != "decode_attention"), launches
        self.paths.reset()
        want, cache = model.decode_step(self.params, cache, tok)
        eager = self.paths.read()
        assert eager == launches, (eager, launches)
        same = [n for n in cache if torch.equal(mine[n], cache[n])]
        equal = torch.equal(got, want)
        # one step of each on its own cache copy, back to back
        step_ms = {}
        for name, fn in (("reordered", first.reordered_step),
                         ("eager", model.decode_step)):
            c = {n: t.clone() for n, t in cache.items()}
            step_ms[name] = time_ms(torch, lambda: fn(self.params, c, tok),
                                    iters=10, warmup=2)
        log(f"phase {label}-reorder: " + "; ".join(
            f"cache {c}: {rep} (trace + schedule {secs:.3f} s, host)"
            for c, rep, secs in reports)
            + f"; at cache {caches[0]} after a prefill of "
            f"{prompts.shape[0]} x {prompts.shape[1]} tokens: reordered "
            f"step == eager decode_step: logits "
            f"{equal}, cache {sorted(same)} of {sorted(cache)}; K8 launches "
            f"through the reordered module {launches['decode_attention']}; "
            f"step ms (events) reordered {step_ms['reordered']:.3f}, eager "
            f"{step_ms['eager']:.3f} [{self.card}] "
            f"({time.perf_counter() - t0:.2f} s)")
        assert equal and len(same) == len(cache), (equal, same)


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
    from repro_torch.graphs import mobilenet_v1_graph, swiftnet_cell_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_pointwise import ops as pw_ops
    from repro_torch.kernels.conv_quant import ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cnn_wrappers = {**ops.KERNEL_WRAPPERS, **pw_ops.KERNEL_WRAPPERS}
    wrappers = {**cnn_wrappers, **fa_ops.KERNEL_WRAPPERS,
                **dec_ops.KERNEL_WRAPPERS}
    assert set(wrappers) == set(REPLACES)

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
    secs = build.build_all()
    assert set(secs) == set(REPLACES), secs
    log(f"phase build: nvcc sm_90a, one process per source in parallel: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f" -> {build.BUILD_DIR} ({time.perf_counter() - t0:.2f} s)")
    for name in PTXAS_KERNELS:
        log(f"ptxas {name}: "
            + "; ".join(build.PTXAS.get(name, ["not built here"])))

    # --------------------------------------------------- schedule + plan
    def planned(label, graph, golden, **kw):
        t0 = time.perf_counter()
        d = deploy.build(graph, device=device, **kw)
        assert d.arena_bytes == golden, (label, d.arena_bytes, golden)
        log(f"phase schedule {label}: {d.schedule_result.method}, arena "
            f"{d.arena_bytes} B, {len(d.schedule)} ops "
            f"({time.perf_counter() - t0:.2f} s)")
        return d

    int8 = [(b, planned(f"int8 budget={b}", mobilenet_v1_graph(*MODEL),
                        golden, quantize=True, arena_budget=b))
            for b, golden in BUDGETS]
    f32 = []
    for b, golden, n_pw in F32_BUDGETS:
        d = planned(f"f32 budget={b}", mobilenet_v1_graph(*MODEL), golden,
                    arena_budget=b)
        assert sum(map(is_pointwise, d.schedule)) == n_pw
        f32.append((b, d, n_pw))
    swift_f32 = planned("swiftnet f32", swiftnet_cell_graph(), SWIFT_F32)
    swift_int8 = planned("swiftnet int8", swiftnet_cell_graph(), SWIFT_INT8,
                         quantize=True)
    assert sum(map(is_pointwise, swift_f32.schedule)) == SWIFT_F32_K6

    # ------------------------------------- kernels vs plain, on the card
    t0 = time.perf_counter()
    checks = Checks(torch, np, device, cnn_wrappers)
    for d in ([d for _, d in int8] + [d for _, d, _ in f32]
              + [swift_f32, swift_int8]):
        checks.from_deployment(d)
    n_main = len(checks.configs)
    checks.hostile()
    log(f"phase kernels-vs-plain: {n_main} main-path configs + "
        f"hostile shapes, checked per kernel {checks.checked} "
        f"({checks.ring_checked} of K2/K3/K5 read as ring windows in "
        f"place), mismatches "
        f"{checks.mismatches} (int8: bit-exact; conv1x1: within "
        f"{F32_BOUND:.3e} * (Cin + 2) * sum|x w|) "
        f"({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in checks.mismatches.values()), checks.mismatches
    assert all(v > 0 for v in checks.checked.values()), checks.checked
    assert checks.ring_checked > 0
    timings = {name: checks.timing(name, card) for name in cnn_wrappers}
    checks.k1_shapes(card, int8[0][1])
    checks.k6_shapes(card, f32[0][1])
    checks.conv_shapes(card, [(f"int8 budget={b}", d) for b, d in int8]
                       + [("swiftnet int8", swift_int8)])

    # ------------------------------------------------------- main paths
    paths = Paths(torch, np, wrappers, card)
    for i, (budget, d) in enumerate(int8):
        per_inf = paths.deployment(f"int8 budget={budget}", d, 100 + i,
                                   exact=True)
        assert all(per_inf.get(n, 0) > 0
                   for n in ("qconv1x1", "qdwconv", "qconv")), per_inf
    # every zero-copy window of the 224 KB cascade is read by K2 or K3 in
    # place: none is gathered
    assert d.executor.zero_copy_reads == ZERO_COPY_224
    assert ring_gathers(d, lambda: eager_run(
        d.executor, paths.random_input(d.graph))) == 0
    for i, (budget, d, n_pw) in enumerate(f32):
        per_inf = paths.deployment(f"f32 budget={budget}", d, 200 + i,
                                   exact=False)
        assert per_inf == {"conv1x1": n_pw}, per_inf
    per_inf = paths.deployment("swiftnet f32", swift_f32, 300, exact=False)
    assert per_inf == {"conv1x1": SWIFT_F32_K6}, per_inf
    per_inf = paths.deployment("swiftnet int8", swift_int8, 301, exact=True)
    assert all(per_inf.get(n, 0) > 0
               for n in ("qconv1x1", "qdwconv", "qconv")), per_inf
    # the compiled forms against the eager program
    for i, (budget, d) in enumerate(int8):
        paths.graphs(f"int8 budget={budget}", d, 400 + 20 * i, exact=True)
    for i, (budget, d, _) in enumerate(f32):
        paths.graphs(f"f32 budget={budget}", d, 500 + 20 * i, exact=False)
    paths.graphs("swiftnet f32", swift_f32, 600, exact=False)
    paths.graphs("swiftnet int8", swift_int8, 620, exact=True)
    paths.table1(swift_int8, device)
    paths.fused_add([swift_int8, int8[0][1]], device)
    # sharded continuous batching over the same deployments
    t0 = time.perf_counter()
    for i, (budget, d) in enumerate(int8):
        paths.sharded(f"int8 budget={budget}", d, 700 + 20 * i, exact=True)
    paths.sharded("f32 budget=None", f32[0][1], 760, exact=False)
    paths.chaos("f32 budget=None", f32[0][1], 780, exact=False)
    log(f"phase sharded: {time.perf_counter() - t0:.2f} s")
    fx_phase(torch, np, device, card, int8[0][1])

    # ------------------------------------------- the LLM serving path
    t0 = time.perf_counter()
    attn = AttentionChecks(torch, np, device)
    attn.hostile()
    log(f"phase attention-hostile: K7/K8 vs plain at the hostile shapes "
        f"(float32 within {F32_ATTN} * max|want|, bf16 within one ulp + "
        f"{BF16_ATTN_ABS} * max|want|): checked {attn.checked}, mismatches "
        f"{attn.mismatches} ({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in attn.mismatches.values()), attn.mismatches
    llm = Llm(torch, np, device, paths, attn, card)
    n_k7 = {}
    for mix in LLM_MIXES:
        llm.graphs(mix[0], *llm.serve(*mix))
        n_k7[mix[0]] = len(attn.main_k7)
    llm.continuation()
    llm.card_vs_cpu()
    llm.reorder("llm", REORDER_CACHES)
    # the MoE decoder: Granite-MoE at full width beside Llama's weights
    t0 = time.perf_counter()
    moe = Llm(torch, np, device, paths, attn, card, arch=MOE_ARCH,
              mix=MOE_MIX)
    moe.graphs(MOE_MIX[0], *moe.serve(*MOE_MIX))
    E, k = moe.cfg.num_experts, moe.cfg.experts_per_token
    moe.continuation("llm-moe", *moe.float32(capacity_factor=E / k),
                     tol=MOE_CONT_TOL)
    moe.card_vs_cpu("llm-moe", *moe.float32(), tol=MOE_CPU_TOL)
    moe.reorder("llm-moe", MOE_MIX[5:6])
    log(f"phase llm-moe: {time.perf_counter() - t0:.2f} s")
    # the recurrent decoders, one at a time, the earlier models freed
    del llm, moe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for arch, mix in SSM_MIXES:
        rec = Llm(torch, np, device, paths, attn, card, arch=arch, mix=mix)
        rec.graphs(mix[0], *rec.serve(*mix))
        label = f"llm-{mix[0]}"
        rec.continuation(label, *rec.float32(), tol=SSM_CONT_TOL)
        rec.card_vs_cpu(label, *rec.float32(), tol=SSM_CPU_TOL,
                        layers=SSM_CPU_LAYERS)
        rec.reorder(label, mix[5:6])
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase llm-ssm: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    n_main = attn.main_path()
    log(f"phase attention-main-path: K7/K8 vs plain at the {n_main} "
        f"launch configurations of the LLM phases not checked above: "
        f"checked {attn.checked}, mismatches {attn.mismatches} "
        f"({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in attn.mismatches.values()), attn.mismatches
    checks.max_err.update(attn.max_err)
    timings.update({name: attn.timing(name, card) for name in ATTENTION})
    attn.timing("flash_attention", card, label="short mix's largest prefill",
                config=attn.largest("flash_attention", n_k7["short"]))
    launches = paths.launches
    assert all(v > 0 for v in launches.values()), launches

    summary = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n],
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
