#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Builds the nine Hopper kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (one process per source, all at once) — the int8 convs
K1–K3, the fused conv→add kernels K4/K5, the float32 pointwise conv K6,
flash attention K7, decode attention K8 and the int8 residual add K9 —
and holds each against its
plain PyTorch version on the card, at every distinct launch configuration
of the paths below plus hostile shapes (the split-K edges of K1/K4, K6
and K8 among them; K2/K3/K5 reading cascade ring windows in place, at
the 224 KB schedule's windows and at hostile ones), and times it there
(K1 and K6 at every distinct pointwise shape of the reorder-only int8 and
float32 schedules, K2/K3/K5 at every depthwise and k×k shape of the int8
MobileNet and SwiftNet schedules, K7 at the largest prefill of each of
Llama's mixes and K8 at the long mix's largest decode step — the shapes
of PERF.md's rows — and both at Whisper's encoder and cross-attention
shapes).  Integer kernels must be bit-exact;
K6 must stay within the worst-case float32 dot-product error bound (see
``F32_BOUND``); K7/K8 within ``F32_ATTN`` of max|want| in float32 and one
bf16 ulp in bf16.  The build phase prints ``ptxas -v``'s registers and
spills of all nine kernels.

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
  seeded residual, bit-exact against ``qconv_fused`` then ``qadd``; in the
  same phase, MobileNetV2 1.0@224 int8 in 320 KB (the 1-D row-ring
  cascade): K9 at every add shape of its schedule, and K1–K5 at every
  conv shape with the linear clamp pair and a ReLU6 pair whose ceiling
  binds inside the grid, each bit-exact against its plain version on the
  card; then that deployment's main path (K9 launched for its adds,
  bit-exact against the CPU plain path);
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
* ``phase llm-window``: sliding-window attention on the card.  K7 with a
  window against its plain version at ``HOSTILE_K7_WINDOW`` (float32 and
  bf16; a window over every key bit for bit causal's), then Llama-3.2-3B
  at full width and depth, bf16, weights from ``WINDOW_SEED``, at
  ``launch/shapes.py``'s ``long_500k`` config (window 8 192) and cache
  (524 288 positions, a ring of 8 192 slots: ``block_bytes`` 939 556 868)
  through ``ServingEngine`` with the captured step, one request a batch:
  a 12 000-token prompt (longer than the ring and not a multiple of it,
  ROADMAP R8's case; 16 new tokens) and an 8 180-token one whose 13th
  step wraps the ring (24 new) — K7 28× per prefill with the window, K8
  28× per step; K7 at the 12 000-row prefill against its plain version
  ``WINDOW_BLOCK`` query rows at a time, and timed there with and
  without the window beside its bound and SDPA with a boolean window
  mask; ``phase graphs llm-window``; decode(t) vs a windowed prefill of
  t+1 tokens at the first step, the wrap and the last (``CONT_TOL``);
  card vs CPU at 2 layers with a window of 512 over a 1 300-token prompt
  (``WINDOW_CPU``); prefill and step times beside their
  ``analysis.roofline.roofline_report(..., hw=H100)`` bounds;
* ``phase llm-moe``: the MoE decoder Granite-3.0-1B-A400M at full width
  and depth (24 layers, 32 experts top 8, bf16) through the launcher's
  engine with the short mix — K7 24× per prefill, K8 24× per decode step
  — with the same lines and ``phase graphs llm-moe`` as Llama's mixes;
  continuation and a 2-layer card vs CPU comparison in float32
  (``MOE_CONT_TOL``, ``MOE_CPU_TOL``: the routing's near-ties are why), and
  its reordered step as above at cache 96;
* ``phase llm-mesh``, with Llama's and Granite's weights still on the
  card: two ranks on the one card (gloo, a (1, 2) ("data", "model")
  mesh) serve ``MESH_JOBS`` through ``ServingEngine(mesh=)`` at full
  width and depth — Llama-3.2-3B heads-sharded, sequence-sharded and
  context-parallel, Granite expert-parallel — each held against this
  process's single-process run (``MESH_TOL``, ``MESH_MOE_TOL``), two
  planted faults beyond the bound (``MESH_FAULTS``), K7/K8 held against
  their plain versions at every configuration the ranks launched, bytes a
  rank the even split; ``phase dryrun``'s two records
  (``launch/dryrun.py`` on a fake world of 256) run beside it;
* ``phase llm-ssm``: the recurrent decoders at full width and depth, bf16,
  after the earlier models' weights are freed — Zamba2-2.7B (54 Mamba2
  layers in 9 groups, each closed by one weight-shared attention block of
  32 heads of 80) and then xLSTM-350M (4 groups of 5 mLSTM + 1 sLSTM) —
  each through the launcher's engine with the short mix (K7 9x per
  prefill and K8 9x per decode step for Zamba2, none for xLSTM; the
  state bytes a request plans, ``SSM_MIXES``), ``phase graphs
  llm-ssm-*``, the continuation at full depth and card vs CPU at two
  groups, both in float32 (``SSM_CONT_TOL``, ``SSM_CPU_TOL``), and the
  reordered step bit-equal to the eager one at cache 96;
* ``phase llm-encdec`` and ``phase llm-vlm``, after the recurrent models
  are freed: Whisper-large-v3 (32 encoder layers over 1 500 frames, 32
  decoder layers with cross attention; K7 96x per prefill — 32 encoder,
  32 self, 32 cross, non-causal but the self ones — and K8 64x per
  decode step, the cross calls over all 1 500 rows of the cross cache;
  cache 96) and InternVL2-1B (256 patch rows before each prompt, 24
  layers, H 14 / K 2; K7 and K8 24x; cache 320), at full width and depth
  in bf16, each through the launcher's engine with the short mix and its
  zero frames / patches (``CROSS_MIXES``), ``phase graphs llm-*``, the
  continuation at full depth and card vs CPU at two layers, both in
  float32 on the data pipeline's seeded frames / patches
  (``CROSS_CONT_TOL``, ``CROSS_CPU_TOL``), and the reordered step;
* ``phase llm-dense`` and ``phase llm-phi-moe``, after those are freed,
  one model at a time: Qwen2-7B (28 layers, H 28 / K 4, QKV bias),
  GLM-4-9B (40, H 32 / K 2: K8 in two chunks of 8 query heads a kv head)
  and Phi-3-medium-14B (40, H 40 / K 10) at full width and depth, then
  Phi-3.5-MoE (16 experts top 2) at full width and depth 8 of 32, bf16,
  each through the launcher's weights and engine with the short mix (its
  block bytes, ``DENSE_MIXES`` / ``PHI_MOE_MIX``), ``phase graphs
  llm-*``, the reordered step at cache 96, card vs CPU at two layers and
  the continuation, both in float32 (the weights widened in place;
  ``DENSE_CONT_TOL``, ``DENSE_CPU_TOL``, Phi-3.5-MoE as Granite), and K8
  timed at GLM-4-9B's group at the long mix's shape (``K8_GLM``);
* ``phase train``, after every serving model is freed: ``phase
  train-llama`` runs ``repro_torch.launch.train``'s ``main --eager`` on
  Llama-3.2-3B at full width and depth (bf16, B 4 x S 1 024, remat, 6
  steps), each step after the first with its ms, tokens/s, loss,
  grad_norm and peak memory, then one step under the profiler (busy,
  idle share, the five largest kernels) beside its bound
  (``step_bound``); ``phase train-graph`` runs the launcher's default on
  the card, the step as one captured CUDA graph
  (``training.GraphedTrainStep``), beside the eager step of the same
  seed and batches — Llama-3.2-3B with one and two microbatches and
  xLSTM-350M, full width and depth (``GRAPH_RUNS``): every step's loss
  and grad_norm and each parameter leaf's float64 checksums equal, step
  ms eager and graphed, capture ms, busy and idle share of a replayed
  step, peak allocated and reserved bytes — then every architecture at
  2 layers (``GRAPH_SMALL_STEPS`` steps: parameters, moments, step and
  metrics against two eager runs) and a planted fault (the static batch
  never refreshed) beyond the bound; ``phase train-small`` trains
  ``examples_torch/train_small.py``'s model on the card until its loss
  falls by more than ``SMALL_DROP``; ``phase train-card-vs-cpu`` takes
  one ``make_train_step`` step of each registered architecture at full
  width, cut to 2 layers (one group of Zamba2 / xLSTM), in float32 on
  the card and on the CPU (loss, grad_norm, every gradient leaf through
  the first moment, the parameters after the step; ``TRAIN_*_TOL``),
  and holds Granite's bf16 expert products (``moe._BmmF32``: the card's
  ``bmm(out_dtype=float32)`` and its backward) to the widened product.
  Training runs the chunked attention under autograd, as the reference
  does: K1-K8 launch no time in it.

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
import tempfile
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
# MobileNetV2 (alpha, resolution, classes), its budget (the STM32F746's
# 320 KB) and the arena it must plan to
MNV2, MNV2_BUDGET, MNV2_INT8 = (1.0, 224, 1000), 320 * KB, 295680
# MobileNetV3-Large (alpha, resolution, classes) in the same 320 KB, and the
# arena the residual cascade must plan to
MNV3, MNV3_INT8 = (1.0, 224, 1000), 286048
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
# the card's peaks (H100 SXM data sheet): the HBM3 rate and the dense bf16
# tensor-core rate are repro_torch.analysis.roofline.H100's (h100() below)
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
    "qadd": "none: the reference's qadd (src/repro/graphs/cnn_ops.py:386) "
            "is XLA element-wise ops",
    "qscale": "none: the reference has no squeeze-and-excite (MobileNetV3's "
              "channel scale is new to the port)",
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
                 "decode_attention", "qadd", "qscale")
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
# ---- the encoder-decoder and the vision-language decoder (phase
# llm-encdec, phase llm-vlm), after the recurrent ones are freed, random
# weights drawn on the card by the launcher, the reference launcher's
# traffic as LLM_MIXES' short mix, with the bytes of a request's block:
# Whisper-large-v3 (bf16, 4.05 GB: 32 encoder + 32 decoder layers of 20
# heads of 64; k + v at cache 96 and the cross cache ck + cv of 1 500
# frames, 2*32*(96 + 1500)*20*64*2 B + pos + kv_pos) and InternVL2-1B
# (bf16, 1.26 GB: 24 layers, 14 heads / 2 kv heads of 64; cache 320 = 256
# patch rows + <= 23 prompt tokens + 12 new ones: at 96 the prefill would
# keep only its last 96 positions, as the reference's does, and drop
# every patch row).  The engine feeds both zero patches / frames, as the
# reference's engine does; the continuation, card-vs-CPU and reorder
# checks feed the data pipeline's seeded ones (SyntheticLMDataset(cfg, B,
# S, seed).batch(0)), since zero frames give a zero encoder output and a
# cross attention that adds nothing.
CROSS_MIXES = (("whisper-large-v3",
                ("encdec", 8, None, 12, 4, 96, 261_489_028)),
               ("internvl2-1b", ("vlm", 8, None, 12, 4, 320, 3_933_444)))
# Their checks run in float32 (TF32 off): in bf16 Llama's 28-layer
# continuation came to 2.041e-02 of CONT_TOL's 3e-2 on an H100 (PERF.md),
# a 1.5x margin, and Whisper's decoder has two attentions a layer over 32
# layers.
# Continuation at full depth: both paths run the encoder and the cross K/V
# on the same frames with the same shapes, so they agree there; in the
# decoder the prefill of t tokens runs K7 and the step after a prefill of
# t-1 runs K8, each within F32_ATTN (2e-5 of max|want|) of plain
# attention, and the GEMMs sum in other orders (~1e-7 relative).  If every
# error adds, Whisper's 64 attentions (32 self + 32 cross) move a logit by
# at most ~1.3e-3 of its scale, InternVL2's 24 by ~5e-4: 2e-3 *
# max|logit|.  Card vs CPU at two layers (Whisper: two encoder and two
# decoder layers) at full width: cuBLAS against MKL and the kernels
# against the chunked path, 1e-3, as SSM_CPU_TOL.
CROSS_CONT_TOL, CROSS_CPU_TOL = 2e-3, 1e-3
CROSS_WHISPER_FRAMES = 1500     # encoder_seq: the rows of its cross cache
# ---- the dense decoders (phase llm-dense), after the cross-attention ones
# are freed, one at a time, at full width and depth, random bf16 weights
# drawn on the card by the launcher, the short mix as LLM_MIXES', with the
# bytes of a request's block (k + v = 2*L*96*K*128*2 B + pos + kv_pos):
# Qwen2-7B (28 layers, H 28 / K 4, QKV bias; 15.23 GB), GLM-4-9B (40, H 32
# / K 2: a group of 16, K8 in two chunks of 8 heads; 18.80 GB) and
# Phi-3-medium-14B (40, H 40 / K 10; 29.32 GB)
DENSE_MIXES = (("qwen2-7b", ("dense-qwen2", 8, None, 12, 4, 96, 5_505_412)),
               ("glm4-9b", ("dense-glm4", 8, None, 12, 4, 96, 3_932_548)),
               ("phi3-medium-14b",
                ("dense-phi3", 8, None, 12, 4, 96, 19_661_188)))
# Their checks run in float32 (TF32 off): in bf16 Llama's 28-layer
# continuation came to 2.041e-02 of CONT_TOL's 3e-2 on an H100 (PERF.md),
# and these have up to 40 layers.  The weights are the served bf16 ones
# widened exactly, in place a leaf at a time after the serve (Phi-3-medium
# is 58.64 GB in float32: beside its bf16 copy it would not fit 80 GB);
# Qwen2's QKV biases, zeros as the launcher draws them, get seeded values
# (DENSE_BIAS_STD) first, so that the checks see them.
# Continuation at full depth: the prefill of t tokens runs K7 and the step
# after a prefill of t-1 runs K8, each within F32_ATTN (2e-5 of
# max|want|) of plain attention, the GEMMs sum in other orders (~1e-7
# relative); if every layer's error adds, 40 attentions move a logit by at
# most ~8e-4 of its scale: 2e-3 * max|logit|, as CROSS_CONT_TOL.  Card vs
# CPU at 2 layers, full width: cuBLAS against MKL and the kernels against
# the chunked path, 1e-3, as CROSS_CPU_TOL.
DENSE_CONT_TOL, DENSE_CPU_TOL, DENSE_BIAS_STD = 2e-3, 1e-3, 0.5
# ---- the MoE decoder Phi-3.5-MoE (phase llm-phi-moe), after the dense
# ones: full width (d 4096, H 32 / K 8, 16 experts top 2 of d_ff 6 400),
# depth cut to 8 of its 32 layers (83.75 GB in bf16 at 32 does not fit one
# 80 GB card; 21.33 GB at 8), random bf16 weights drawn on the card as
# the launcher draws them (torch.Generator seed 0), the short mix with the
# block of 2*8*96*8*128*2 B + pos + kv_pos.  Its checks follow
# Granite's (MOE_CONT_TOL at capacity factor E/k, over the 8 served
# layers; MOE_CPU_TOL at the configured 1.25, 2 layers), in float32.
PHI_MOE_ARCH, PHI_MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 8
PHI_MOE_MIX = ("phi-moe", 8, None, 12, 4, 96, 3_146_116)
# ---- sliding-window attention (phase llm-window), after Llama's phases:
# Llama-3.2-3B at full width and depth, bf16, random weights drawn on the
# card from WINDOW_SEED, at launch/shapes.py's long_500k config (window
# 8 192) and cache (524 288 positions: a ring of 8 192 slots, the
# reference's kv_block_bytes 8 192 * 114 688 + 32 768 + 4 B), one request a
# batch (the shape's global batch): a prompt longer than the ring and not a
# multiple of it (12 000 % 8 192 = 3 808, the case of ROADMAP R8) and one
# whose 13th decode step writes position 8 192 at slot 0 (the ring wraps).
# Continuation and graphs checks as Llama's mixes (CONT_TOL).
WINDOW_SHAPE, WINDOW_SEED = "long_500k", 7
WINDOW_MIX = ("window", 2, (12_000, 8_180), (16, 24), 1, 524_288,
              939_556_868)
# card vs CPU (CPU_TOL, 2 layers) at a window of 512, so that the CPU side
# stays short: a prompt of 1 300 tokens (1 300 % 512 = 276), 8 steps
WINDOW_CPU = (512, 1300, 8)
# K7 is held against its plain version a block of this many query rows at
# a time over long prefills (12 000 rows: no 12 000^2 score matrix)
WINDOW_BLOCK = 1024
# ---- training (phase train), after every serving model is freed.
# train-llama: Llama-3.2-3B at full width and depth through
# repro_torch.launch.train's main (bf16 parameters and gradients, float32
# AdamW moments, one checkpointed body a layer, the chunked attention
# under autograd as the reference trains — K7 has no backward), B 4 x S
# 1 024, one microbatch, 6 steps (--eager: the plain step): the first is
# the warm-up; the steps are phase train-graph's reference.
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "llama3.2-3b", 4, 1024, 6
# train-graph: the train step as one captured CUDA graph
# (training.GraphedTrainStep, which launch.train uses on the card: two
# warm-up calls, each one eager step on a side stream, then the capture's
# call, which records the step and replays it, then replays) beside the
# eager step of the same seed and batches (launch.train --eager), at full
# width and depth, bf16, B TRAIN_B, remat: (arch, S, microbatches, steps,
# a note for its line).
# Every step's loss and grad_norm and a float64 checksum of every
# parameter leaf after the last step (its sum and the sum of its
# magnitudes) must equal the eager run's bit for bit: the same kernels on
# the same inputs.  Where they do not, a second eager run measures the
# eager spread, printed, and the graphed run is held to twice it.
# xLSTM-350M runs at S 512 (the 5th field says so in its line): at S
# 1 024 on an H100 (700 W) an eager step took 11.5 s and the capture
# 29.8 s, which would add ~180 s to the script, where ~90 s was its room.
GRAPH_RUNS = ((TRAIN_ARCH, TRAIN_S, 1, TRAIN_STEPS, ""),
              (TRAIN_ARCH, TRAIN_S, 2, TRAIN_STEPS, ""),
              ("xlstm-350m", 512, 1, 4, " (S cut from 1 024 to 512: "
               "GRAPH_RUNS)"))
# and each architecture at train-card-vs-cpu's sizes (full width, 2
# layers or one group, float32, TF32 off): GRAPH_SMALL_STEPS graphed
# steps from a copy of the state against two eager runs, every
# parameter, both moments, step and every step's metrics equal, or within
# twice the two eager runs' difference (the MoE's expert scatter may add
# atomically).  The planted fault: a graphed step whose static batch is
# filled at the first call only, so it trains on the first batch again,
# must land beyond that bound on the loss.
GRAPH_SMALL_STEPS = 4
# train-small: examples_torch/train_small.py's model (Llama smoke at 4
# layers, d 256, float32) on the card, 30 steps of B 8 x S 64, peak lr
# 3e-3, warm-up 5: the mean of the last five losses below the first
# five's minus 0.25, the reference test's rule (tests/test_training.py:
# 40-53).
SMALL_STEPS, SMALL_B, SMALL_S, SMALL_WARMUP, SMALL_DROP = 30, 8, 64, 5, 0.25
# train-card-vs-cpu: each registered architecture at full width in
# float32 (TF32 off), its depth cut by cut_depth to 2 layers (Whisper 2
# encoder + 2 decoder; Zamba2 and xLSTM one group of 6), B 2 x S 16 text
# tokens (InternVL2's 256 patch rows on top; S sets the CE's rows, its
# cost on the CPU) of the data pipeline with
# its seeded frames / patches (seed TRAIN_CPU_SEED), one make_train_step
# step from zero moments on the card and on the CPU.  Granite runs at
# capacity factor E / k, so that no expert drops a token on either side.
TRAIN_CPU_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "zamba2-2.7b",
                   "xlstm-350m", "whisper-large-v3", "internvl2-1b")
TRAIN_CPU_B, TRAIN_CPU_S, TRAIN_CPU_LR, TRAIN_CPU_SEED = 2, 16, 1e-4, 5
# The loss: both devices sum the same float32 terms in other orders
# (cuBLAS against MKL); a logsumexp over V <= 151 655 logits is within
# ~log2(V) * 2^-24 ~ 1e-6 of either, the few layers' activations within
# ~1e-6 of their scale: 1e-5 * |loss|.
TRAIN_LOSS_TOL = 1e-5
# The gradients, read from the first moment: after one step from zero
# moments mu = (1 - b1) * s * g with s = min(1, 1 / ||g||), one rounding
# from the gradient, so mu_card - mu_cpu is 0.1 * s times the gradients'
# difference.  Each leaf is held to 1e-3 * max|mu| (the card-vs-CPU bound
# of the serving checks at 2 layers) or, where larger, to twice the
# gradient's own float32 spread: how far the card's gradient moves when
# every parameter moves by one float32 rounding (x * (1 + 2^-24 n), n
# standard normal), measured in the phase and printed.  Zamba2's and
# xLSTM's gradients are that ill-conditioned: at smoke width one
# rounding moves them by up to ~1e-3 / ~5e-5 of max|g| in both packages
# (tests/test_torch_training.py), so neither device can pin them closer.
# grad_norm, a sum over every leaf: 1e-3 relative.
TRAIN_GRAD_TOL = 1e-3
# The parameters after the step: AdamW's first step moves an element by
# lr * (g / (|g| + 1e-8) + 0.1 p), about +-lr, so where a gradient lies
# within the two devices' difference of 0 (the embedding's and head's
# rows of tokens the batch barely touches) the two moves may differ by up
# to 2 lr, elsewhere by far less: |p_card - p_cpu| <= 2 lr + 2^-22 *
# max|p| (the rounding of p), with the elements apart by more than lr / 2
# counted on the line.
# K7/K8 against their plain versions.  float32: |got - want| <= F32_ATTN *
# max|want| (the JAX package's own kernel tests use 2e-5); bf16: within one
# bf16 ulp of want plus 1e-6 * max|want| — both compute in float32 from the
# same bf16 inputs and round once, so they differ by at most the rounding
# of two float32 values that differ in the last float32 bits.
F32_ATTN, BF16_ATTN_ABS = 2e-5, 1e-6
K8_CACHES = 6       # K8 is timed over this many caches in turn (see timing)
# K8 at GLM-4-9B's group of 16 (two chunks of 8 query heads, each reading
# the kv head's rows), timed at the long mix's shape: (B, S, H, K, D,
# lengths), bf16
K8_GLM = (4, 2048, 32, 2, 128, (1039, 2048, 700, 1))
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
              (2, 65, 150, 8, 8, 80, False, False),
              # Whisper's encoder (1 500 frames, longer than any row
              # above, non-causal: the bf16 body's P·V in three parts) and
              # its prefill cross attention (23 text rows over the frames)
              (4, 1500, 1500, 20, 20, 64, False, False),
              (4, 23, 1500, 20, 20, 64, False, False)]
# hostile windowed K7 shapes (B, Sq, Skv, H, K, D, window, packed), causal:
# W 1; W below one key tile (both of a row's edges in one tile); W one
# tile and one tile and a bit; W = S (bit for bit causal's) and W > S;
# Sq < Skv; D 40 / 64 / 80 / 128; several query blocks; Llama's heads at
# the card-vs-CPU window
HOSTILE_K7_WINDOW = [(1, 17, 17, 2, 2, 64, 1, False),
                     (2, 200, 200, 6, 2, 128, 5, False),
                     (1, 300, 300, 4, 4, 80, 64, True),
                     (1, 300, 300, 4, 2, 64, 70, False),
                     (2, 200, 200, 6, 2, 128, 200, False),
                     (1, 129, 129, 8, 2, 128, 500, True),
                     (1, 70, 333, 6, 3, 128, 50, False),
                     (2, 333, 1000, 8, 8, 80, 129, False),
                     (1, 256, 256, 4, 2, 40, 63, False),
                     (1, 1000, 1000, 14, 2, 64, 300, False),
                     (1, 2048, 2048, 24, 8, 128, 512, True)]
# hostile K8 shapes (B, S, H, K, D, lengths, strided): caches of 96 and
# 2048 rows, lengths 1, S and between, GQA 1, 3, 4, 12, 16, 20 and 32;
# `strided` caches are views of a longer cache, MISALIGNED ones start one
# element into it (no 16-byte load: the scalar path).  The split-K edges:
# length 1 with the largest split (B 1, 8 kv heads: 8 blocks a row),
# lengths below the split, D 40 and 96
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
              (3, 300, 8, 8, 80, (300, 1, 129), MISALIGNED),
              # Whisper's cross cache: every row of 1 500 frames, H = K
              (4, 1500, 20, 20, 64, (1500,) * 4, False),
              # groups above 8 (K8 in chunks of at most 8 heads a kv
              # head): GLM-4-9B's 16 with ragged lengths; 12, which a naive
              # split leaves 8 + 4 (chunks 6 + 6); 20 (chunks 6, 7 and 7);
              # 32 on a strided cache; 16 misaligned (the scalar path)
              (4, 2048, 32, 2, 128, (1039, 2048, 700, 1), False),
              (2, 300, 24, 2, 64, (300, 17), False),
              (1, 96, 20, 1, 80, (96,), False),
              (2, 1024, 32, 1, 128, (1024, 333), True),
              (2, 512, 32, 2, 128, (500, 3), MISALIGNED)]
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
# K9's hostile shapes (H, W, C): one element, odd counts (one byte a
# thread), multiples of 4 and of 16 (4- and 16-byte words where the lanes
# are aligned), MobileNetV2's widest add at 224
HOSTILE_ADD = [(1, 1, 1), (3, 5, 7), (2, 3, 12), (4, 4, 16), (7, 7, 160),
               (56, 56, 24)]
# K10's hostile shapes (H, W, C): one element, odd channel counts (one byte
# a thread), C a multiple of 4 and of 16 (4- and 16-byte words where the
# lanes are aligned), MobileNetV3-Large's widest channel scale at 224;
# (mult, zp_x, zp_g, zp_out): plain, and saturating both rails
HOSTILE_SCALE = [(1, 1, 1), (3, 5, 7), (2, 3, 12), (4, 4, 16),
                 (7, 7, 960), (28, 28, 120)]
SCALE_QP = ((0.0011, -9, -128, 3), (0.09, 40, 0, -100))
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


def h100():
    """The card's spec of the port's roofline (``repro_torch.analysis.
    roofline.H100``): ``hbm_bw`` bytes/s, ``peak_flops`` dense bf16."""
    from repro_torch.analysis.roofline import H100
    return H100


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
PROFILE_TRIES = 3


def device_time(torch, fn, reps: int = 3, counts=None):
    """Device busy time per call of ``fn`` (ms), summed over the CUDA
    activities ``torch.profiler`` records, with the top names by time and
    the time of every name (a kernel of the port by its ``<name>_kernel``
    function, device-to-device copies as ``COPY``).  ``counts``, a dict,
    receives the activities of each name per call.  Late in a long run
    the profiler can return a window without its device records, so a
    window with none is profiled again, up to ``PROFILE_TRIES`` times.
    Only the card's activities are recorded: nothing here reads the
    host's, and ``prof.events()`` builds a tree of all of them, which
    for an eager Zamba2 serve took longer than the serve (the busy times
    read the same without them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, seen = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                m = re.search(r"\w+_kernel|Memcpy \w+|Memset", e.name)
                name = m.group(0) if m else e.name[:40]
                if "copy_kernel" in e.name or name == "Memcpy DtoD":
                    name = COPY
                by_name[name] = by_name.get(name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / reps
                seen[name] = seen.get(name, 0) + 1 / reps
        if by_name:
            break
    if counts is not None:
        for name, n in seen.items():
            counts[name] = counts.get(name, 0) + n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), top, by_name


def dev(ms):
    """A profiler device time for a log line; a profile that recorded no
    device activity in ``PROFILE_TRIES`` windows is "not measured", never
    0."""
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
             aligned=False, clamp=None, table=None):
        """Route one int8 configuration as ``qconv_fused``/
        ``qdwconv_fused``/``qconv_add_fused`` (``addp`` given) do and
        compare the kernel with the plain version (once per ``tag`` and
        shape), over ``lanes`` lanes a byte stride apart (``aligned``: 16
        bytes).  ``ring = (ring_rows, src)``: K2/K3/K5 read the H-row input
        as the window (src, H) of a ring of ``ring_rows`` rows, held
        against the ring-view plain versions.  ``clamp = (lo, hi)``: the
        conv's int8 clamp pair (None: the fused ReLU's); ``table``: a
        table activation's 256 int8 values (K1–K3's table epilogue)."""
        hp = self._pads(h, k, stride, hpad)
        wp = self._pads(w, k, stride, wpad)
        oh = (h + hp[0] + hp[1] - k) // stride + 1
        ow = (w + wp[0] + wp[1] - k) // stride + 1
        key = (tag, kind, h, w, cin, cout, k, stride, hp, wp, addp, ring,
               aligned, clamp, table is not None)
        if key in self.configs:
            return
        rows, src = ring or (h, 0)
        x = self._lanes((rows, w, cin), lanes, aligned)
        # ring windows through the wrappers' src/n and the *_ring_ref plain
        # versions; a plain input through the calls every checkout has
        rk = dict(src=src, n=h) if ring else {}
        rs = "_ring" if ring else ""
        qp = dict(mult=mult, zp_in=zp_in, zp_out=zp_out)
        if clamp is not None:
            qp.update(lo=clamp[0], hi=clamp[1])
        if table is not None:
            assert addp is None, "K4/K5 take no table"
            qp["table"] = self.torch.as_tensor(table, device=self.device)
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

    def case_add(self, tag, h, w, c, addp, lanes=2, aligned=False,
                 inplace=False):
        """K9 against ``ref.qadd`` over ``lanes`` lanes a byte stride apart
        (``aligned``: 16 bytes); ``inplace``: the output is leg a's own
        bytes, as a plan may place it."""
        key = (tag, "qadd", h, w, c, addp, lanes, aligned, inplace)
        if key in self.configs:
            return
        a = self._lanes((h, w, c), lanes, aligned)
        b = self._lanes((h, w, c), lanes, aligned)
        ap = add_params(addp, -3)
        want = self.ref.qadd(a, b, *ap)
        out = a if inplace else self._lanes((h, w, c), lanes, aligned)
        got = self.ops.qadd(a, b, mult_a=ap[0], mult_b=ap[1], zp_a=ap[2],
                            zp_b=ap[3], zp_out=ap[4], out=out)
        self.torch.cuda.synchronize()
        assert got is out
        diff = (got.to(self.torch.int32) - want.to(self.torch.int32)).abs()
        self.max_err["qadd"] = max(self.max_err["qadd"], int(diff.max()))
        self.mismatches["qadd"] += int((diff != 0).sum())
        self.checked["qadd"] += 1
        self.configs[key] = ("qadd", 0, 3 * h * w * c, (h, w, c, addp))

    def case_scale(self, tag, h, w, c, qp, lanes=2, aligned=False,
                   inplace=False):
        """K10 against ``ref.qmul`` over ``lanes`` lanes a byte stride
        apart (``aligned``: 16 bytes), the gates in lanes of their own;
        ``inplace``: the output is the map's own bytes."""
        key = (tag, "qscale", h, w, c, qp, lanes, aligned, inplace)
        if key in self.configs:
            return
        x = self._lanes((h, w, c), lanes, aligned)
        g = self._lanes((1, 1, c), lanes, aligned)
        want = self.ref.qmul(x, g, *qp)
        out = x if inplace else self._lanes((h, w, c), lanes, aligned)
        got = self.ops.qscale(x, g, mult=qp[0], zp_x=qp[1], zp_g=qp[2],
                              zp_out=qp[3], out=out)
        self.torch.cuda.synchronize()
        assert got is out
        diff = (got.to(self.torch.int32) - want.to(self.torch.int32)).abs()
        self.max_err["qscale"] = max(self.max_err["qscale"],
                                     int(diff.max()))
        self.mismatches["qscale"] += int((diff != 0).sum())
        self.checked["qscale"] += 1
        self.configs[key] = ("qscale", 0, 3 * h * w * c + c, (h, w, c, qp))

    def tables_and_scales(self, d):
        """MobileNetV3's deployment: K10 at every channel-scale shape of its
        schedule (its own params, lanes aligned as the arena's and not, and
        in place), and K1–K3 at every table-activated conv shape with that
        conv's own table.  Returns the shapes and cases."""
        g, shapes = d.exec_graph, set()
        before = sum(self.checked.values())
        for op in d.schedule:
            a = op.attrs
            if op.kind == "qmul":
                h, w, c = g.tensors[op.output].shape
                qp = (a["mult"], a["zp_x"], a["zp_g"], a["zp_out"])
                shapes.add(("qmul", h, w, c))
                for aligned in (False, True):
                    self.case_scale("table", h, w, c, qp, aligned=aligned)
                self.case_scale("table", h, w, c, qp, aligned=True,
                                inplace=True)
            if op.kind not in ("qconv", "qdwconv") or "table" not in a:
                continue
            h, w, cin = g.tensors[op.inputs[0]].shape
            wq = a["weight_q"]
            args = (op.kind, h, w, cin,
                    wq.shape[3] if op.kind == "qconv" else 0, wq.shape[0],
                    a["stride"], a.get("pex_pads"), a.get("pex_wpads"),
                    a["mult"], a["zp_in"], a["zp_out"])
            shapes.add(args[:9])
            self.case("table", *args, clamp=(-128, 127), aligned=True,
                      table=a["table"])
            self.case("table", *args, clamp=(-128, 127), table=a["table"])
        return len(shapes), sum(self.checked.values()) - before

    def clamps_and_adds(self, d):
        """MobileNetV2's deployment: K9 at every add shape of its schedule
        (its own add params, lanes aligned as the arena's and not, and in
        place), and K1–K5 at every int8 conv shape with the linear clamp
        pair and a ReLU6 pair whose ceiling binds inside the grid (a range
        wider than 6: ``zp_out + 40``).  Returns the shapes and cases."""
        g, shapes = d.exec_graph, set()
        before = sum(self.checked.values())
        for op in d.schedule:
            a = op.attrs
            if op.kind == "qadd":
                h, w, c = g.tensors[op.output].shape
                addp = (a["mult_a"], a["mult_b"], a["zp_a"], a["zp_b"],
                        a["zp_out"])
                shapes.add(("qadd", h, w, c))
                for aligned in (False, True):
                    self.case_add("clamp", h, w, c, addp, aligned=aligned)
                self.case_add("clamp", h, w, c, addp, aligned=True,
                              inplace=True)
            if op.kind not in ("qconv", "qdwconv"):
                continue
            h, w, cin = g.tensors[op.inputs[0]].shape
            wq = a["weight_q"]
            args = (op.kind, h, w, cin,
                    wq.shape[3] if op.kind == "qconv" else 0, wq.shape[0],
                    a["stride"], a.get("pex_pads"), a.get("pex_wpads"),
                    a["mult"], a["zp_in"], a["zp_out"])
            shapes.add(args[:9])
            for clamp in ((-128, 127),
                          (a["zp_out"], min(127, a["zp_out"] + 40))):
                self.case("clamp", *args, clamp=clamp, aligned=True)
                if op.kind == "qconv":
                    self.case("clamp", *args, clamp=clamp, addp=ADD_QP[0])
        return len(shapes), sum(self.checked.values()) - before

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
        for (h, w, c) in HOSTILE_ADD:
            for addp in ADD_QP:
                for aligned in (False, True):
                    self.case_add("hostile", h, w, c, addp, lanes=3,
                                  aligned=aligned)
            self.case_add("hostile", h, w, c, ADD_QP[2], aligned=True,
                          inplace=True)
        for (h, w, c) in HOSTILE_SCALE:
            for qp in SCALE_QP:
                for aligned in (False, True):
                    self.case_scale("hostile", h, w, c, qp, lanes=3,
                                    aligned=aligned)
            self.case_scale("hostile", h, w, c, SCALE_QP[1], aligned=True,
                            inplace=True)
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
        t_bytes = nbytes / h100().hbm_bw * 1e3
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
                bound = max(nbytes / h100().hbm_bw,
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
            bound = max(nbytes / h100().hbm_bw,
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
            bound = max(nbytes / h100().hbm_bw,
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


@contextlib.contextmanager
def recording(torch, k7s, k8s):
    """Record every K7/K8 launch configuration of the model while the
    block runs eagerly, in ``k7s`` and ``k8s`` (the wrappers' counts are
    untouched; a call that a CUDA graph is capturing is not recorded: its
    lengths exist only at replay)."""
    import repro_torch.kernels as kernels
    fa, dec = kernels.flash_attention, kernels.decode_attention
    capturing = torch.cuda.is_current_stream_capturing

    def flash(q, k, v, *, causal=True, window=0):
        if not capturing():
            k7s.append((tuple(q.shape), tuple(k.shape), q.dtype, causal,
                        window))
        return fa(q, k, v, causal=causal, window=window)

    def decode(q, k_cache, v_cache, lengths):
        if not capturing():
            k8s.append((tuple(q.shape), tuple(k_cache.shape), q.dtype,
                        lengths.clone()))
        return dec(q, k_cache, v_cache, lengths)

    kernels.flash_attention, kernels.decode_attention = flash, decode
    try:
        yield
    finally:
        kernels.flash_attention, kernels.decode_attention = fa, dec


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

    def record(self):
        """``recording`` into ``main_k7`` / ``main_k8``."""
        return recording(self.torch, self.main_k7, self.main_k8)

    def add_configs(self, k7s, k8s):
        """Hold K7/K8 at configurations another process launched
        (``recording``'s, lengths as tuples) against their plain
        versions; returns how many were new."""
        n = len(self.seen)
        for (B, Sq, H, D), ks, dtype, causal, window in k7s:
            self.k7(B, Sq, ks[1], H, ks[2], D, dtype, causal, window=window)
        for (B, H, D), ks, dtype, lengths in k8s:
            self.k8(B, ks[1], H, ks[2], D, dtype, lengths)
        return len(self.seen) - n

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

    def k7(self, B, Sq, Skv, H, K, D, dtype, causal, packed=False,
           window=0):
        key = ("k7", B, Sq, Skv, H, K, D, dtype, causal, packed, window)
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
        got = self.fa_ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
        if window >= Skv:   # a window over every key is causal, bit for bit
            causal_out = self.fa_ops.flash_attention(q, k, v, causal=True)
            self.torch.cuda.synchronize()
            if not self.torch.equal(got, causal_out):
                self.mismatches["flash_attention"] += 1
        self._compare("flash_attention", got,
                      self.plain_k7(q, k, v, causal, window))

    def plain_k7(self, q, k, v, causal, window):
        """K7's plain version, a block of ``WINDOW_BLOCK`` query rows at a
        time over the keys up to the block's last row (its query offset:
        no Sq x Skv score matrix of a long prefill), all keys without
        ``causal``."""
        torch = self.torch
        Sq, Skv = q.shape[1], k.shape[1]
        if Sq * Skv <= WINDOW_BLOCK * WINDOW_BLOCK * 16:
            return self.fa_ref.attention_ref(q, k, v, causal=causal,
                                             window=window)
        out = []
        for r0 in range(0, Sq, WINDOW_BLOCK):
            r1 = min(Sq, r0 + WINDOW_BLOCK)
            end = Skv - Sq + r1 if causal else Skv
            out.append(self.fa_ref.attention_ref(
                q[:, r0:r1], k[:, :end], v[:, :end], causal=causal,
                window=window))
        return torch.cat(out, 1)

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
        return self.add_configs(self.main_k7, [
            (qs, ks, dtype, tuple(lengths.tolist()))
            for qs, ks, dtype, lengths in self.main_k8])

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
            (B, Sq, H, D), ks, dtype, causal, window = \
                config or self.largest(name)
            Skv, K = ks[1], ks[2]
            q = self._randn((B, Sq, H, D), dtype)
            k = self._randn((B, Skv, K, D), dtype)
            v = self._randn((B, Skv, K, D), dtype)
            run = lambda: self.fa_ops.flash_attention(  # noqa: E731
                q, k, v, causal=causal, window=window)
            plain = lambda: self.plain_k7(  # noqa: E731
                q, k, v, causal, window)
            off = Skv - Sq
            mask = None
            if window:      # keep j <= i + off and j > i + off - window
                i = torch.arange(Sq, device=self.device)[:, None] + off
                j = torch.arange(Skv, device=self.device)[None]
                mask = (j <= i) & (j > i - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)
            # query-key pairs the mask keeps (queries are the last Sq
            # positions): each costs 2·D flops in q·k and 2·D in p·v
            pairs = sum(min(Skv, max(0, off + i + 1))
                        - (max(0, off + i - window + 1) if window else 0)
                        for i in range(Sq)) if causal else Sq * Skv
            flops = 4 * B * H * D * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            shape = (f"B{B} Sq{Sq} Skv{Skv} H{H}/K{K} D{D} {dtype} "
                     f"causal={causal} window={window}, {pairs} "
                     f"(query, key) pairs")
            lib_name = ("F.scaled_dot_product_attention(bool window mask, "
                        "enable_gqa)" if window else
                        "F.scaled_dot_product_attention(is_causal, "
                        "enable_gqa)")
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
        peak = h100().peak_flops if dtype == torch.bfloat16 \
            else H100_F32_OPS_PER_S
        kernel_ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=10, warmup=2)
        library_ms = time_ms(torch, lib)
        dev_ms, lib_dev_ms = (device_time(torch, f, reps=12)[0]
                              for f in (run, lib))
        t_bytes = nbytes / h100().hbm_bw * 1e3
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


    def whisper_timings(self, card):
        """``timing`` at Whisper's own shapes, bf16, as its phase launched
        them: the encoder, the largest prefill cross attention and a decode
        step's cross attention over all ``CROSS_WHISPER_FRAMES`` rows."""
        bf16, Se = self.torch.bfloat16, CROSS_WHISPER_FRAMES
        enc, cross = [], []
        for c in self.main_k7:
            if c[1][1] == Se and c[2] == bf16 and not c[3]:
                (enc if c[0][1] == Se else cross).append(c)
        self.timing("flash_attention", card, label="Whisper encoder",
                    config=enc[0])
        self.timing("flash_attention", card,
                    label="Whisper's largest prefill cross attention",
                    config=max(cross, key=lambda c: c[0][1]))
        self.timing("decode_attention", card,
                    label="Whisper decode step's cross attention",
                    config=next(c for c in self.main_k8
                                if c[1][1] == Se and c[2] == bf16))

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
            + f"; planned {dec._plan(B, K * dec.plan_chunks(H // K), S,
                                    self.device.index or 0)}, "
            f"mismatches {self.mismatches['decode_attention']} [{card}]")


def attn_launches(cfg):
    """(K7 launches per prefill, K8 launches per decode step): one each per
    layer of a uniform stack and per group of Zamba2 (its shared attention
    block), none in xLSTM; Whisper runs K7 once per encoder layer and twice
    per decoder layer (self, then cross attention) and K8 twice per
    decoder layer."""
    from repro_torch.models.model import model_layout
    lay = model_layout(cfg)
    if lay.kind == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    n = {"uniform": cfg.num_layers, "zamba": lay.groups}.get(lay.kind, 0)
    return n, n


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def cut_depth(params, layers):
    """The weights of a model's first ``layers`` layers: a uniform stack's
    first layers (Whisper's: its encoder's first ``layers`` too), or for
    Zamba2 and xLSTM (``layers`` a multiple of 6) the first ``layers //
    6`` groups, the shared attention block whole."""
    g = layers // 6
    keep = {"blocks": layers, "encoder": layers, "mamba": layers,
            "mlstm": 5 * g, "slstm": g}
    return {k: ({n: t[:keep[k]] for n, t in v.items()} if k in keep else v)
            if isinstance(v, dict) else v for k, v in params.items()}


class Llm:
    """An LLM serving path of the port at full width and depth in bf16
    through ``repro_torch.launch.serve``'s engine, K7 on every prefill
    attention, K8 on every decode attention: Llama-3.2-3B (``LLM_ARCH``),
    the MoE decoder Granite-3.0-1B-A400M (``MOE_ARCH``), a recurrent
    decoder of ``SSM_MIXES`` (Zamba2: one attention a group; xLSTM:
    none), a model of ``CROSS_MIXES`` (Whisper: the encoder and cross
    attention too; InternVL2: the patch rows in every prefill), a dense
    decoder of ``DENSE_MIXES`` or Phi-3.5-MoE at a cut depth
    (``layers``)."""

    def __init__(self, torch, np, device, paths, attn, card, arch=LLM_ARCH,
                 mix=LLM_MIXES[0], shape=None, seed=0, layers=None):
        from repro_torch.configs import get_config
        from repro_torch.launch import serve as launch_serve
        from repro_torch.launch.shapes import config_for_shape
        from repro_torch.models.model import init_params, model_layout
        self.torch, self.np, self.device = torch, np, device
        self.paths, self.attn, self.card = paths, attn, card
        self.launch_serve = launch_serve
        t0 = time.perf_counter()
        self.cfg = get_config(arch)
        full_depth = self.cfg.num_layers
        if shape is None and layers is None:
            # the launcher's own engine: random bf16 weights drawn on the
            # card (seed 0)
            self.params = launch_serve.build_engine(
                arch, max_batch=mix[4], cache_len=mix[5],
                device=device).params
        else:       # the shape's config or a cut depth, weights drawn from
            # ``seed`` as the launcher draws them
            if shape is not None:
                self.cfg = config_for_shape(self.cfg, shape)
            if layers is not None:
                self.cfg = self.cfg.replace(num_layers=layers)
            self.params = init_params(
                self.cfg, torch.Generator(device=device).manual_seed(seed),
                device)
        self.n_k7, self.n_k8 = attn_launches(self.cfg)
        lay = model_layout(self.cfg)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in self._leaves(self.params))
        moe = (f", {self.cfg.num_experts} experts top "
               f"{self.cfg.experts_per_token}, capacity factor "
               f"{self.cfg.capacity_factor}" if self.cfg.is_moe else "")
        if lay.kind in ("zamba", "xlstm"):
            moe += (f", layout {lay.kind}: {lay.groups} groups of "
                    f"{lay.per_group}, {self.n_k8} attention "
                    f"applications a step")
        if lay.kind == "encdec":
            moe += (f", encoder {self.cfg.encoder_layers} layers over "
                    f"{self.cfg.encoder_seq} frames of "
                    f"{self.cfg.frontend_dim}, cross attention in every "
                    f"decoder layer")
        if self.cfg.num_patch_tokens:
            moe += (f", {self.cfg.num_patch_tokens} patch rows of "
                    f"{self.cfg.frontend_dim} before each prompt")
        if self.cfg.sliding_window:
            moe += (f", {shape}'s sliding window {self.cfg.sliding_window}, "
                    f"weights seed {seed}")
        if self.cfg.qkv_bias:
            moe += ", QKV bias"
        depth = (f" (depth {layers} of {full_depth})" if layers is not None
                 else "")
        log(f"phase llm-init: {arch} ({self.cfg.num_layers} layers{depth}, "
            f"d {self.cfg.d_model}, {self.cfg.num_heads} heads / "
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
        return requests_for(self.np, self.cfg, n, prompt, max_new)

    def serve(self, label, n, prompt, max_new, max_batch, cache_len,
              block_bytes):
        """One traffic mix through ``ServingEngine.serve``: a warm-up
        batch (which captures the decode step of ``max_batch`` rows), then
        the counted run (``attn_launches``: K7 28x per prefill and K8 28x
        per replayed decode step for Llama), then a profiled run for the
        device's busy time.  Returns (engine, requests, results, profiler
        busy ms)."""
        from repro_torch.serving import ServingEngine
        torch, np = self.torch, self.np
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
        want = {"flash_attention": self.n_k7 * len(batches),
                "decode_attention": self.n_k8 * steps}
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
            f"launches {launches} (K7 {self.n_k7}/prefill, K8 "
            f"{self.n_k8}/decode step); "
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
        logits, cache = model.prefill(self.params,
                                      self._feed(self._padded(batch)),
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
            first, cache = model.prefill(self.params,
                                         self._feed(self._padded(b)),
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
        assert busy_g > 0 and (by_g.get(k8, 0) > 0) == (self.n_k8 > 0), (
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

    def _feed(self, tokens, seed=None, cfg=None, device=None):
        """A prefill's batch of ``tokens`` [B, S] on ``device`` (default the
        card) and, for a VLM or Whisper, its patches / frames: the
        engine's zero stubs (``seed`` None), or the data pipeline's seeded
        ones, ``SyntheticLMDataset(cfg, B, patch rows + S, seed)
        .batch(0)``'s."""
        from repro_torch.data import SyntheticLMDataset
        from repro_torch.serving.engine import modality_stubs
        torch = self.torch
        cfg, device = cfg or self.cfg, device or self.device
        B, S = tokens.shape
        if seed is None:
            feed = modality_stubs(cfg, B, device)
        else:
            batch = SyntheticLMDataset(
                cfg, B, (cfg.num_patch_tokens or 0) + S, seed).batch(0)
            feed = {n: torch.as_tensor(a, device=device)
                    for n, a in batch.items() if n != "tokens"}
        feed["tokens"] = torch.as_tensor(tokens, device=device)
        return feed

    def _padded(self, batch):
        return padded(self.np, batch)

    def float32(self, layers=None, **changes):
        """(config, parameters) of this model in float32 — the same
        weights, widened exactly — with ``changes`` to the config; with
        ``layers``, of its first ``layers`` layers only (``cut_depth``)."""
        assert not self.torch.backends.cuda.matmul.allow_tf32
        params = self.params
        if layers is not None:
            params = cut_depth(params, layers)
            changes["num_layers"] = layers
        params = tree_map(lambda t: t.to(self.torch.float32), params)
        return self.cfg.replace(dtype="float32", **changes), params

    def widen(self):
        """This model in float32 from here on: each leaf replaced by its
        exact float32 widening, one leaf at a time, so the bf16 and the
        float32 weights are never both whole on the card (Phi-3-medium:
        29.32 + 58.64 GB).  Nothing else may hold the bf16 leaves (serve
        and reorder run before)."""
        assert not self.torch.backends.cuda.matmul.allow_tf32

        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                else:
                    tree[k] = v.to(self.torch.float32)
        walk(self.params)
        self.cfg = self.cfg.replace(dtype="float32")
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()

    def continuation(self, label="llm", cfg=None, params=None,
                     tol=CONT_TOL):
        """Decoding token t after a prefill of t-1 tokens gives the logits
        of prefilling t tokens (tests/test_arch_smoke.py:78-93) at full
        width and depth: K7 against K8.  ``cfg``/``params`` replace the
        served model (the MoE check runs it in float32).  A VLM's or
        Whisper's patches / frames come from the data pipeline (seed 2),
        the same in both prefills; positions count the patch rows."""
        from repro_torch.models import Model
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        cfg, params = cfg or self.cfg, params or self.params
        model = Model(cfg)
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                 (2, CONT_T))
        stubs = self._feed(toks, seed=2, cfg=cfg)
        self.paths.reset()
        with self.attn.record():
            full, _ = model.prefill(params, stubs)
            _, cache = model.prefill(
                params, dict(stubs, tokens=stubs["tokens"][:, :-1]),
                cache_len=(cfg.num_patch_tokens or 0) + CONT_T)
            dec, _ = model.decode_step(params, cache, stubs["tokens"][:, -1])
        launches = self.paths.read()
        k7, k8 = attn_launches(cfg)
        assert launches["flash_attention"] == 2 * k7, launches
        assert launches["decode_attention"] == k8, launches
        assert torch.isfinite(full).all() and torch.isfinite(dec).all()
        err = float((dec - full).abs().max())
        scale = float(full.abs().max())
        log(f"phase {label}-continuation: B 2, t {CONT_T}, {cfg.dtype}, "
            f"{cfg.num_layers} layers"
            + (f", capacity factor {cfg.capacity_factor}" if cfg.is_moe
               else "")
            + f": max|decode(t) - prefill(t)| {err:.3e} of max|logit| "
            f"{scale:.5f} (ratio {err / scale:.3e}, tolerance {tol}); "
            f"launches {launches} ({time.perf_counter() - t0:.2f} s)")
        assert err <= tol * scale, (err, scale)
        return err / scale

    def card_vs_cpu(self, label="llm", cfg=None, params=None, tol=CPU_TOL,
                    layers=CPU_LAYERS, prompt=CPU_S, n_steps=CPU_STEPS):
        """A ``layers``-layer variant at full width (the first layers'
        weights; whole groups for Zamba2 and xLSTM) on the card and on the
        port's plain CPU path: prefill and teacher-forced decode steps
        agree.  ``cfg``/``params`` replace the served model (the MoE,
        recurrent and cross-attention checks run it in float32).  A VLM's
        or Whisper's patches / frames come from the data pipeline (seed
        3), the same on both sides."""
        from repro_torch.models import Model
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        cfg, params = cfg or self.cfg, params or self.params
        cfg = cfg.replace(num_layers=layers, encoder_layers=layers
                          if cfg.encoder_layers else 0)
        card = cut_depth(params, layers)
        cpu = tree_map(lambda t: t.cpu(), card)
        model = Model(cfg)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab_size, (2, prompt))
        steps = rng.integers(0, cfg.vocab_size, (n_steps, 2))
        cache_len = (cfg.num_patch_tokens or 0) + prompt + n_steps
        self.paths.reset()
        with self.attn.record():
            got = [model.prefill(card, self._feed(toks, seed=3, cfg=cfg),
                                 cache_len=cache_len)]
            for t in steps:
                got.append(model.decode_step(card, got[-1][1],
                                             torch.as_tensor(t)))
        launches = self.paths.read()
        want = [model.prefill(cpu, self._feed(toks, seed=3, cfg=cfg,
                                              device=torch.device("cpu")),
                              cache_len=cache_len)]
        for t in steps:
            want.append(model.decode_step(cpu, want[-1][1],
                                          torch.as_tensor(t)))
        ratios = []
        for (g, _), (w, _) in zip(got, want):
            err = float((g.cpu() - w).abs().max())
            ratios.append(err / float(w.abs().max()))
        k7, k8 = attn_launches(cfg)
        assert launches["flash_attention"] == k7, launches
        assert launches["decode_attention"] == k8 * n_steps, launches
        log(f"phase {label}-card-vs-cpu: {layers} layers at full width, "
            f"prefill of {prompt} tokens + {n_steps} decode steps"
            + (f", window {cfg.sliding_window}" if cfg.sliding_window
               else "") + ", "
            f"{cfg.dtype}: max|card - cpu| / max|cpu logit| per call "
            + ", ".join(f"{r:.3e}" for r in ratios)
            + f" (tolerance {tol}); launches {launches} "
            f"({time.perf_counter() - t0:.2f} s)")
        assert max(ratios) <= tol, ratios
        return max(ratios)

    def window_continuation(self, eng, reqs, results):
        """ROADMAP R8's check on the card: each served request's prompt
        prefilled into the engine's ring, then an eager ``decode_step``
        loop fed its served tokens, against a windowed prefill of the
        prompt and the tokens so far (``decode(t)`` vs ``prefill(t+1)``)
        at the first step, the step that writes slot 0 of the ring and the
        last: within ``CONT_TOL`` of max|logit|."""
        from repro_torch.models import Model
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        model, W = Model(self.cfg), self.cfg.sliding_window
        parts = []
        for r, res in zip(reqs, results):
            S, n = len(r.prompt), len(res.tokens)
            toks = np.concatenate([r.prompt, res.tokens]).astype(np.int64)
            # step i feeds served token i-1 at position S + i - 1
            wraps = [i for i in range(1, n) if (S + i - 1) % W == 0]
            check = sorted({1, n - 1, *wraps[:1]})
            _, cache = model.prefill(self.params,
                                     self._feed(toks[None, :S]),
                                     cache_len=eng.cache_len)
            assert cache["k"].shape[2] == W
            errs = []
            for i in range(1, n):
                tok = torch.as_tensor(toks[S + i - 1:S + i],
                                      device=self.device)
                logits, cache = model.decode_step(self.params, cache, tok)
                if i in check:
                    full, _ = model.prefill(self.params,
                                            self._feed(toks[None, :S + i]))
                    assert torch.isfinite(logits).all()
                    err = float((logits - full).abs().max())
                    scale = float(full.abs().max())
                    errs.append((i, S + i - 1, (S + i - 1) % W, err, scale))
            del cache
            parts.append((S, errs))
        log(f"phase llm-window-continuation: B 1, {self.cfg.dtype}, window "
            f"{W}, decode(t) vs windowed prefill(t+1), max|delta logit| / "
            f"max|logit| (tolerance {CONT_TOL}): " + "; ".join(
                f"prompt {S} ({S} % {W} = {S % W}): " + ", ".join(
                    f"step {i} (pos {p}, slot {sl}) {e / sc:.3e}"
                    for i, p, sl, e, sc in errs) for S, errs in parts)
            + f" ({time.perf_counter() - t0:.2f} s)")
        assert all(e <= CONT_TOL * sc for _, errs in parts
                   for *_, e, sc in errs), parts

    def window_bounds(self, reqs, results):
        """Each served request's prefill ms and graphed decode ms/step
        beside ``roofline_report(..., hw=H100)`` of the work: the weights'
        bf16 products over the prompt (the head over its last row) plus
        the windowed attention's 4·H·D flops a (query, key) pair, and the
        weights read once plus the K/V rows the ring keeps; a step, the
        weights and the ``min(pos + 1, W)`` rows it reads."""
        from repro_torch.analysis.roofline import H100, roofline_report
        from repro_torch.models.model import init_params
        cfg, W = self.cfg, self.cfg.sliding_window
        meta = init_params(cfg, device="meta")
        L, H, K, D = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim_)
        blocks = sum(t.numel() for t in meta["blocks"].values())
        head = cfg.padded_vocab * cfg.d_model
        wbytes = sum(t.numel() * t.element_size()
                     for t in self._leaves(meta))
        if not cfg.tie_embeddings:      # the lookup reads a row a token
            wbytes -= meta["embed"].numel() * meta["embed"].element_size()
        kv_row = 2 * L * K * D * meta["embed"].element_size()
        lines = []
        for r, res in zip(reqs, results):
            S, n = len(r.prompt), len(res.tokens)
            pairs = sum(min(i + 1, W) for i in range(S))
            pre = roofline_report(
                flops=2 * blocks * S + 2 * head + 4 * H * D * pairs * L,
                bytes_accessed=wbytes + min(S, W) * kv_row,
                collective_bytes=0.0, hw=H100)
            rows = min(S + n - 1, W)        # the last step's
            step = roofline_report(
                flops=2 * blocks + 2 * head + 4 * H * D * rows * L,
                bytes_accessed=wbytes + rows * kv_row,
                collective_bytes=0.0, hw=H100)
            lines.append(
                f"prompt {S}: prefill {res.prefill_ms:.3f} ms, bound "
                f"{pre['step_time_lb_s'] * 1e3:.4f} ms "
                f"({pre['dominant']}); graphed decode "
                f"{res.decode_ms / (n - 1):.3f} ms/step, bound "
                f"{step['step_time_lb_s'] * 1e3:.4f} ms ({step['dominant']}, "
                f"{rows} rows)")
        log(f"phase llm-window bounds (roofline_report, {H100.name}): "
            + "; ".join(lines) + f" [{self.card}]")

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
        order, so nothing may differ.  A VLM's or Whisper's patches /
        frames come from the data pipeline (seed 4)."""
        from repro_torch.models import Model
        from repro_torch.serving import ServingEngine
        torch, L = self.torch, self.n_k8
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
        logits, cache = model.prefill(self.params,
                                      self._feed(prompts, seed=4),
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


def window_phase(torch, np, device, paths, attn, card):
    """``phase llm-window``: sliding-window attention on the card.  K7 with
    a window against its plain version at ``HOSTILE_K7_WINDOW``; then
    Llama-3.2-3B at ``WINDOW_SHAPE``'s config and cache through
    ``ServingEngine`` with the captured decode step (``WINDOW_MIX``:
    ``block_bytes``, K7 28x a prefill with the window, K8 28x a step over
    the ring); K7 at the 12 000-row prefill against its plain version
    (``WINDOW_BLOCK`` rows at a time) and timed there with and without the
    window beside its bound and SDPA's; ``phase graphs llm-window``; the
    continuation at the first step, the step that writes slot 0 and the
    last; card vs CPU at ``WINDOW_CPU``; the bounds of a prefill and a
    decode step from ``repro_torch.analysis.roofline`` beside their
    times."""
    from repro_torch.launch.shapes import SHAPES
    t0 = time.perf_counter()
    n0 = attn.checked["flash_attention"]
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Skv, H, K, D, window, packed) in HOSTILE_K7_WINDOW:
            attn.k7(B, Sq, Skv, H, K, D, dtype, True, packed, window)
    log(f"phase llm-window hostile: K7 with a window vs plain at "
        f"{attn.checked['flash_attention'] - n0} windowed configurations "
        f"(W 1 to W > S, Sq < Skv, D 40-128, float32 and bf16; W >= Skv "
        f"bit for bit causal's), mismatches {attn.mismatches} "
        f"({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in attn.mismatches.values()), attn.mismatches
    assert WINDOW_MIX[5] == SHAPES[WINDOW_SHAPE].seq_len
    win = Llm(torch, np, device, paths, attn, card, arch=LLM_ARCH,
              mix=WINDOW_MIX, shape=WINDOW_SHAPE, seed=WINDOW_SEED)
    W = win.cfg.sliding_window
    n_rec = len(attn.main_k7)
    eng, reqs, results, busy, by_name, wall = win.serve(*WINDOW_MIX)
    assert eng.decode_step(1).cache["k"].shape[2] == W
    served = attn.main_k7[n_rec:]
    assert len(served) == win.n_k7 * len(reqs) and all(
        c[4] == W and c[3] for c in served), served
    # K7 at the longest prefill's own shape against its plain version, and
    # timed there with the window and without it
    big = max(served, key=lambda c: c[0][1])
    (B, Sq, H, D), (_, Skv, K, _), dtype = big[0], big[1], big[2]
    t1 = time.perf_counter()
    attn.k7(B, Sq, Skv, H, K, D, dtype, True, window=W)
    log(f"phase llm-window K7 at B{B} Sq{Sq} H{H}/K{K} D{D} {dtype} window "
        f"{W} vs plain ({WINDOW_BLOCK} query rows at a time): mismatches "
        f"{attn.mismatches['flash_attention']}, max_abs_err "
        f"{attn.max_err['flash_attention']:.3e} "
        f"({time.perf_counter() - t1:.2f} s)")
    assert attn.mismatches["flash_attention"] == 0
    k7w = attn.timing("flash_attention", card, config=big,
                      label=f"{WINDOW_SHAPE} prefill, windowed")
    k7c = attn.timing("flash_attention", card,
                      config=big[:4] + (0,),
                      label=f"{WINDOW_SHAPE} prefill, causal, no window")
    log(f"phase llm-window K7 {Sq} rows: windowed {k7w['ms']:.5f} ms "
        f"(bound {k7w['bound_ms']:.5f}), causal without the window "
        f"{k7c['ms']:.5f} ms (bound {k7c['bound_ms']:.5f}); SDPA "
        f"{k7w['library_ms']:.5f} / {k7c['library_ms']:.5f} ms [{card}]")
    win.graphs(WINDOW_MIX[0], eng, reqs, results, busy, by_name, wall)
    win.window_continuation(eng, reqs, results)
    cpu_w, cpu_s, cpu_n = WINDOW_CPU
    win.card_vs_cpu("llm-window", win.cfg.with_sliding_window(cpu_w),
                    win.params, prompt=cpu_s, n_steps=cpu_n)
    win.window_bounds(reqs, results)
    log(f"phase llm-window: {time.perf_counter() - t0:.2f} s")


# ---- the mesh (phase llm-mesh), after the MoE phase with Llama's and
# Granite's weights still on the card: two ranks on the one card, each on
# cuda:0, over a (1, 2) ("data", "model") mesh (make_local_mesh(2)), gloo
# (NCCL refuses two ranks on one device) on a free port, weights drawn by
# each rank from the launcher's seed 0 and kept as its pieces.  Each job:
# (label, arch, config changes, mix): Llama-3.2-3B's short mix with its
# cache over the KV heads (4 of 8 a rank, 12 of 24 query heads: K7 and K8
# on them), its long mix with the cache over the rows (1 024 of 2 048 a
# rank: the sequence-sharded decode attention), its short mix context
# parallel (act_shard="cp": each rank's prefill rows through K7 over the
# keys up to its last row, the weights whole on each rank), Granite's
# short mix expert-parallel (16 of 32 experts a rank; with "data" 1 its
# capacity is the single-process run's).
MESH_RANKS, MESH_TIMEOUT = 2, 600
MESH_JOBS = (("llama-heads", LLM_ARCH, {"kv_mode": "heads"}, LLM_MIXES[0]),
             ("llama-sequence", LLM_ARCH, {"kv_mode": "sequence"},
              LLM_MIXES[1]),
             ("llama-cp", LLM_ARCH, {"act_shard": "cp"}, LLM_MIXES[0]),
             ("granite-ep", MOE_ARCH, {}, MOE_MIX))
# The sharded logits against the single-process run's at the same tokens
# (the single-process greedy tokens fed to both), at every step of every
# batch: bf16, full depth.  Per layer the sharded run rounds each rank's
# half of the wo and wdn products to bf16 before the all-reduce adds the
# halves, and sums the rest in another order: the continuation check's
# one-ulp-a-layer argument twice over predicted ~1 % of max|logit|; the
# readings are 2 %, and context parallel, whose weights are whole on each
# rank, reads the same, so it is the bf16 noise of two differently
# ordered runs rather than the half-sums alone.  The bound sits between
# the readings (PERF.md §5): the sound runs' largest, over every step of
# every batch, 0.0225 of max|logit| (context parallel; heads 0.0221,
# sequence 0.0220; the first five steps read 0.0195-0.0220 in earlier
# runs), and the planted faults' smallest (MESH_FAULTS), 0.0711 (the
# sequence merge without its correction; wo unreduced 1.2036): 3e-2 is
# 1.33x the one and 1/2.37 of the other.  Each fault must land beyond it.
MESH_TOL = 3e-2
# Granite in bf16 flips MoE routing at near-ties (see MOE_CONT_TOL), so
# its logits are held in float32 (TF32 off): the same float32 products
# summed in another order (a rank's 16 experts, then the all-reduce),
# ~1e-7 relative a layer, 1e-3 * max|logit| as MOE_CPU_TOL; its bf16
# served tokens are printed beside the single process's, not held.
MESH_MOE_TOL = 1e-3
# The served tokens equal the single-process run's up to a request's
# first difference.  There the two runs read the same tokens, so the
# single-process logits' margin of its token over the sharded run's can
# be no more than the two logits' deltas at that step: held as at most
# twice that step's measured max|delta| of the request's row.
# Planted faults (job, fault): the wo product's partial sums left
# unreduced (each rank keeps its own heads' half), and the sequence
# merge's correction dropped (each rank's partial softmax scaled by its
# own max, pmax skipped); each reruns the job's first batch over this many
# decode steps and must fail MESH_TOL.
MESH_FAULTS = (("llama-heads", "wo-unreduced"),
               ("llama-sequence", "corr-dropped"))
MESH_FAULT_STEPS = 4
# phase dryrun: the reference's slow-test combo (rolled) and Llama's
# decode_32k with the unrolled analysis pass, each in its own process
DRYRUN_COMBOS = (("xlstm-350m", "decode_32k", ["--no-unroll"]),
                 ("llama3.2-3b", "decode_32k", []))


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _local_bytes(tree):
    from repro_torch.models.sharding import local
    from repro_torch.training.optimizer import tree_leaves
    return sum(local(t).numel() * local(t).element_size()
               for t in tree_leaves(tree))


def _split_bytes(tree, specs, sizes):
    """The bytes each rank must hold of ``tree`` placed by ``specs``: each
    leaf's whole divided by the sizes of the mesh axes its spec names."""
    from repro_torch.training.optimizer import tree_leaves
    total = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        div = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                div *= sizes[a]
        total += t.numel() * t.element_size() // div
    return total


def requests_for(np, cfg, n, prompt, max_new):
    """``n`` requests: the reference launcher's traffic (``prompt``
    None), or random prompts of ``prompt`` tokens and ``max_new`` new
    ones, each an int or a tuple of one per request."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import Request
    if prompt is None:      # the reference launcher's traffic
        return launch_serve.make_requests(cfg, n, max_new)

    def each(x):
        return x if isinstance(x, tuple) else (x,) * n
    rng = np.random.default_rng(1)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, p).astype(np.int32), max_new_tokens=m)
        for i, (p, m) in enumerate(zip(each(prompt), each(max_new)))]


def padded(np, batch):
    """The batch's prompts left-padded with token 0, as the engine pads
    them."""
    S = max(len(r.prompt) for r in batch)
    toks = np.zeros((len(batch), S), np.int64)
    for i, r in enumerate(batch):
        toks[i, S - len(r.prompt):] = r.prompt
    return toks


def forced_logits(torch, model, params, toks, tokens, cache_len, device):
    """Prefill ``toks`` and decode feeding ``tokens`` [B, T] (token t is
    fed at step t + 1): the logits of every step on the host, [T, B,
    vocab], and the decode seconds a step."""
    from repro_torch.models.sharding import full
    feed = {"tokens": torch.as_tensor(toks, device=device)}
    logits, cache = model.prefill(params, feed, cache_len=cache_len)
    out = [full(logits).cpu()]
    _sync(torch, device)
    t0 = time.perf_counter()
    for t in range(1, tokens.shape[1]):
        logits, cache = model.decode_step(
            params, cache, torch.as_tensor(tokens[:, t - 1], device=device))
        out.append(full(logits).cpu())
    _sync(torch, device)
    return torch.stack(out), (time.perf_counter() - t0) / max(
        tokens.shape[1] - 1, 1)


def greedy(torch, model, params, toks, max_new, cache_len, device):
    """The single-process run's tokens [B, max_new] and logits
    [max_new, B, vocab] (host, float32) of one batch, greedy."""
    feed = {"tokens": torch.as_tensor(toks, device=device)}
    logits, cache = model.prefill(params, feed, cache_len=cache_len)
    tok = torch.argmax(logits, -1)
    toks_out, logs = [tok], [logits.float().cpu()]
    for _ in range(1, max_new):
        logits, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)
        toks_out.append(tok)
        logs.append(logits.float().cpu())
    return torch.stack(toks_out, 1).cpu().numpy(), torch.stack(logs)


# the registrations of use_c10d_collectives, kept alive for the process
_C10D_LIBS: list = []


def use_c10d_collectives() -> None:
    """Route the functional collectives of CUDA tensors (the ops DTensor's
    redistributions and the mapped bodies issue) through the c10d
    collectives of their process group, synchronously.  Under gloo on an
    H100 the c10d collectives of CUDA tensors complete while a
    functional one (``all_gather_into_tensor`` waited on) never returns;
    this registers CUDA kernels of ``_c10d_functional``'s ops that call
    c10d instead (``wait_tensor`` then has nothing to wait for).  Gloo
    has no average: "avg" is a sum divided by the group's size.  Once a
    process, in each rank before its mesh is made; the package's mesh
    code keeps torch's own collectives (NCCL on several cards)."""
    if _C10D_LIBS:
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def group(name):
        return name if isinstance(name, dist.ProcessGroup) \
            else _resolve_process_group(name)

    def reduce(t, op, pg):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "avg"
                        else getattr(dist.ReduceOp, op.upper()), group=pg)
        if op == "avg":
            t.div_(dist.get_world_size(pg))
        return t

    def all_reduce(input, reduce_op, group_name):
        return reduce(input.clone(), reduce_op, group(group_name))

    def all_reduce_(input, reduce_op, group_name):
        return reduce(input, reduce_op, group(group_name))

    def all_gather_into_tensor(input, group_size, group_name):
        out = input.new_empty((input.shape[0] * group_size,)
                              + input.shape[1:])
        dist.all_gather_into_tensor(out, input.contiguous(),
                                    group=group(group_name))
        return out

    def reduce_scatter_tensor(input, reduce_op, group_size, group_name):
        full = reduce(input.clone(), reduce_op, group(group_name))
        rank = dist.get_rank(group(group_name))
        n = input.shape[0] // group_size
        return full[rank * n:(rank + 1) * n].clone()

    def all_to_all_single(input, output_split_sizes, input_split_sizes,
                          group_name):
        rows = sum(output_split_sizes) if output_split_sizes \
            else input.shape[0]
        out = input.new_empty((rows,) + input.shape[1:])
        dist.all_to_all_single(out, input.contiguous(),
                               list(output_split_sizes) or None,
                               list(input_split_sizes) or None,
                               group=group(group_name))
        return out

    def wait_tensor(tensor):
        return tensor

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_reduce", all_reduce), ("all_reduce_", all_reduce_),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_to_all_single", all_to_all_single),
                     ("wait_tensor", wait_tensor)):
        lib.impl(name, fn, "CUDA")
    _C10D_LIBS.append(lib)


@contextlib.contextmanager
def planted(fault):
    """One of ``MESH_FAULTS`` planted in the model's mesh code while the
    block runs (this process only)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.models import model as mm
    name = {"wo-unreduced": "_out_proj", "corr-dropped": "all_reduce"}[fault]
    orig = getattr(mm, name)

    def unreduced(out, wo):     # each rank's half taken for the sum
        y = orig(out, wo)
        return DTensor.from_local(
            y.to_local(), y.device_mesh,
            [Replicate() if isinstance(p, Partial) else p
             for p in y.placements], run_check=False, shape=y.shape,
            stride=y.stride())

    def no_pmax(t, op, mesh, axis):     # corr = 1 on every rank
        return t if op == "max" else orig(t, op, mesh, axis)
    setattr(mm, name, unreduced if fault == "wo-unreduced" else no_pmax)
    try:
        yield
    finally:
        setattr(mm, name, orig)


def mesh_rank(rank, world, port, jobs, refs, device, queue):
    """One rank of ``phase llm-mesh`` (a process of its own, on cuda:0):
    each job served through ``ServingEngine(..., mesh=)`` over the rank's
    pieces, its K7/K8 launches and their configurations, bytes,
    collectives a decode step and forced logits put on ``queue``; an
    error puts its traceback there and fails the process."""
    import traceback
    try:
        queue.put((rank, "ok", _mesh_rank(rank, world, port, jobs, refs,
                                            device)))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def _mesh_rank(rank, world, port, jobs, refs, device):
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import (Model, cache_specs, init_params,
                                          param_specs, shard_params)
    from repro_torch.serving import ServingEngine
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    wrappers = {**fa_ops.KERNEL_WRAPPERS, **dec_ops.KERNEL_WRAPPERS}
    k7s, k8s = [], []
    try:
        if device.type == "cuda":
            use_c10d_collectives()
        mesh = make_local_mesh(world, device=device)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out = {"mesh": sizes, "faults": {}}
        with recording(torch, k7s, k8s):
            for label, arch, changes, mix in jobs:
                t0 = time.perf_counter()
                cfg = get_config(arch).replace(**changes)
                _, n, _, max_new, B, cache_len = mix[:6]
                params = init_params(cfg, torch.Generator(device).manual_seed(
                    0), device, mesh=mesh)
                eng = ServingEngine(cfg, params, max_batch=B,
                                    cache_len=cache_len, device=device,
                                    mesh=mesh)
                reqs = requests_for(np, cfg, *mix[1:4])
                for w in wrappers.values():
                    w.launches = 0
                n7, n8 = len(k7s), len(k8s)
                results = eng.serve(reqs)
                _sync(torch, device)
                launches = {k: w.launches for k, w in wrappers.items()}
                # every launch of the serve is among the configurations
                assert launches == {"flash_attention": len(k7s) - n7,
                                    "decode_attention": len(k8s) - n8}, (
                    label, launches, len(k7s) - n7, len(k8s) - n8)
                step = eng.decode_step(B)
                with CommDebugMode() as comm:
                    step()
                    _sync(torch, device)
                rec = {
                    "launches": launches,
                    "tokens": [r.tokens for r in results],
                    "prefill_ms": [r.prefill_ms for r in results[::B]],
                    "decode_ms": [r.decode_ms for r in results[::B]],
                    "param_bytes": _local_bytes(params),
                    "param_bytes_even": _split_bytes(
                        params, param_specs(cfg, mesh), sizes),
                    "cache_bytes": _local_bytes(step.cache),
                    "cache_bytes_even": _split_bytes(
                        step.cache, cache_specs(cfg, mesh, B), sizes),
                    "collectives": {str(k).split(".")[-1]: v for k, v in
                                    comm.get_comm_counts().items()},
                    "serve_s": time.perf_counter() - t0}
                del eng, step
                if cfg.is_moe:      # held in float32 (MESH_MOE_TOL)
                    cfg = cfg.replace(dtype="float32")
                    whole = init_params(get_config(arch), torch.Generator(
                        device).manual_seed(0), device)
                    params = shard_params(tree_map(lambda t: t.float(),
                                                   whole), cfg, mesh)
                    del whole
                model = Model(cfg, mesh)
                runs = [forced_logits(torch, model, params,
                                      padded(np, reqs[i * B:(i + 1) * B]),
                                      toks, cache_len, device)
                        for i, toks in enumerate(refs[label])]
                rec["forced_step_ms"] = runs[0][1] * 1e3
                if rank == 0:   # by value: a shared tensor dies with the rank
                    rec["logits"] = [lg.float().numpy() for lg, _ in runs]
                for job, fault in MESH_FAULTS:
                    if job == label:
                        with planted(fault):
                            lg, _ = forced_logits(
                                torch, model, params, padded(np, reqs[:B]),
                                refs[label][0][:, :MESH_FAULT_STEPS + 1],
                                cache_len, device)
                        if rank == 0:
                            out["faults"][fault] = lg.float().numpy()
                out[label] = rec
                del params, model
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        out["k7"] = sorted(set(k7s), key=str)
        out["k8"] = sorted({(q, k, d, tuple(n.tolist()))
                            for q, k, d, n in k8s}, key=str)
        return out
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phase(torch, np, device, paths, attn, llm, moe, card):
    """``phase llm-mesh``: the sharded model on two ranks of the one card
    (``MESH_JOBS``), each job's forced logits held against this process's
    single-process run of the same weights at every step, its served
    tokens against that run's up to a difference the step's deltas
    explain, the planted faults (``MESH_FAULTS``) beyond the bound, K7/K8
    launched on every rank and held against their plain versions at
    every configuration a rank launched, bytes a rank the even split of
    the whole, collectives a decode step counted by ``CommDebugMode``.
    Two ranks time-slice one card and their collectives go through gloo
    on the host: the times are that arrangement's, not two cards'."""
    import multiprocessing as mp
    import queue as queue_mod
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    owners = {LLM_ARCH: llm, MOE_ARCH: moe}
    refs, want = {}, {}     # tokens fed to the ranks; their logits here
    ref_tokens = {}
    for label, arch, changes, mix in MESH_JOBS:
        m = owners[arch]
        _, n, _, max_new, B, cache_len = mix[:6]
        reqs = requests_for(np, m.cfg, *mix[1:4])
        toks = [padded(np, reqs[i:i + B]) for i in range(0, n, B)]
        cfg, params = m.cfg, m.params
        served = [greedy(torch, Model(cfg), params, t, max_new, cache_len,
                         device) for t in toks]
        ref_tokens[label] = [t for t, _ in served]
        if cfg.is_moe:
            cfg, params = m.float32()
            served = [greedy(torch, Model(cfg), params, toks[0], max_new,
                             cache_len, device)]
            del params
        refs[label] = [t for t, _ in served]
        want[label] = [lg for _, lg in served]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"phase llm-mesh references: single-process greedy runs of "
        f"{[j[0] for j in MESH_JOBS]} ({time.perf_counter() - t_phase:.2f} "
        f"s)")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=mesh_rank, args=(
        r, MESH_RANKS, port, MESH_JOBS, refs, str(device), queue))
        for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < len(procs):
            try:
                rank, status, res = queue.get(timeout=5)
            except queue_mod.Empty:     # a rank that died puts nothing
                dead = [p.exitcode for p in procs if p.exitcode]
                assert not dead, f"phase llm-mesh: a rank exited {dead}"
                assert time.perf_counter() - t0 < MESH_TIMEOUT, \
                    "phase llm-mesh: the ranks took too long"
                continue
            if status != "ok":
                raise AssertionError(f"phase llm-mesh rank {rank} failed:\n"
                                     f"{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks_s = time.perf_counter() - t0
    # K7/K8 at every configuration the ranks launched, against plain
    t1 = time.perf_counter()
    k7s = sorted({c for r in got.values() for c in r["k7"]}, key=str)
    k8s = sorted({c for r in got.values() for c in r["k8"]}, key=str)
    new = attn.add_configs(k7s, k8s)
    log(f"phase llm-mesh attention: K7/K8 vs plain at the ranks' {len(k7s)} "
        f"K7 and {len(k8s)} K8 launch configurations ({new} not checked "
        f"before; K7 query / key shapes "
        f"{sorted({(c[0], c[1], str(c[2])) for c in k7s})}): checked "
        f"{attn.checked}, mismatches {attn.mismatches} "
        f"({time.perf_counter() - t1:.2f} s)")
    assert all(v == 0 for v in attn.mismatches.values()), attn.mismatches
    for label, arch, changes, mix in MESH_JOBS:
        m = owners[arch]
        kv_mode = changes.get("kv_mode")
        _, n, _, max_new, B, cache_len = mix[:6]
        recs = [got[r][label] for r in range(MESH_RANKS)]
        tol = MESH_MOE_TOL if m.cfg.is_moe else MESH_TOL
        mine = [torch.from_numpy(lg) for lg in recs[0]["logits"]]
        scale = max(float(w.abs().max()) for w in want[label])
        err = max(float((g - w).abs().max())
                  for g, w in zip(mine, want[label]))
        assert err <= tol * scale, (label, err, tol * scale)
        faults = []
        for job, fault in MESH_FAULTS:
            if job == label:
                lg = torch.from_numpy(got[0]["faults"][fault])
                e = float((lg - want[label][0][:len(lg)]).abs().max())
                faults.append(f"{fault} {e:.4e} ({e / scale:.4f} of "
                              f"max|logit|)")
                assert e > tol * scale, (label, fault, e, tol * scale)
        single = [row for t in ref_tokens[label] for row in t]
        agree, worst = 0, 0.0
        for r in recs:
            assert r["tokens"] == recs[0]["tokens"], label   # every rank
        for i, (ours, theirs) in enumerate(zip(recs[0]["tokens"], single)):
            theirs = list(theirs)
            agree += ours == theirs
            if ours == theirs or m.cfg.is_moe:
                continue
            t = next(j for j, (a, b) in enumerate(zip(ours, theirs))
                     if a != b)
            ws = want[label][i // B][t, i % B]
            delta = float((mine[i // B][t, i % B] - ws).abs().max())
            margin = float(ws[theirs[t]] - ws[ours[t]])
            assert margin <= 2 * delta, (label, i, t, margin, delta)
            worst = max(worst, margin / delta if margin > 0 else 0.0)
        k7 = [r["launches"]["flash_attention"] for r in recs]
        k8 = [r["launches"]["decode_attention"] for r in recs]
        batches = n // B
        steps = batches * (max_new - 1)
        L = m.cfg.num_layers
        if device.type == "cuda":   # the CPU path has no kernel
            assert k7 == [L * batches] * MESH_RANKS, (label, k7)
            assert k8 == ([0] * MESH_RANKS if kv_mode == "sequence"
                          else [L * steps] * MESH_RANKS), (label, k8)
        for r in recs:
            assert r["param_bytes"] == r["param_bytes_even"], label
            assert r["cache_bytes"] == r["cache_bytes_even"], label
        for name, v in (("flash_attention", sum(k7)),
                        ("decode_attention", sum(k8))):
            paths.launches[name] += v
        whole_p = sum(t.numel() * t.element_size()
                      for t in Llm._leaves(m.params))
        from repro_torch.serving.engine import kv_block_bytes
        whole_c = kv_block_bytes(m.cfg, cache_len) * B
        dec_ms = [d / (max_new - 1) for d in recs[0]["decode_ms"]]
        tps = [B * (max_new - 1) / (d / 1e3) for d in recs[0]["decode_ms"]]
        log(f"phase llm-mesh {label}: {arch} over (data 1, model "
            f"{MESH_RANKS}) on one card, {changes or 'kv_mode heads'}"
            + (f", {m.cfg.num_experts // MESH_RANKS} of "
               f"{m.cfg.num_experts} experts a rank" if m.cfg.is_moe
               else "") + ": "
            f"{n} requests, max_batch {B}, cache_len {cache_len}; launches "
            f"per rank K7 {k7[0]}, K8 {k8[0]}; per rank prefill_ms "
            + "/".join(f"{p:.3f}" for p in recs[0]["prefill_ms"])
            + ", decode ms/step " + "/".join(f"{d:.3f}" for d in dec_ms)
            + ", tokens/s " + "/".join(f"{t:.2f}" for t in tps)
            + f" (rank 1: prefill_ms "
            + "/".join(f"{p:.3f}" for p in recs[1]["prefill_ms"])
            + f"); forced decode {recs[0]['forced_step_ms']:.3f} ms/step; "
            f"bytes a rank: params {recs[0]['param_bytes']} of {whole_p} "
            f"({recs[0]['param_bytes'] / whole_p:.6f}), cache "
            f"{recs[0]['cache_bytes']} of ~{whole_c} "
            f"({recs[0]['cache_bytes'] / whole_c:.6f}), both == the even "
            f"split; collectives a decode step {recs[0]['collectives']}; "
            f"{'float32 ' if m.cfg.is_moe else ''}logits at "
            f"{sum(len(x) for x in mine)} steps x {len(mine[0][0])} rows "
            f"max|delta| {err:.4e} ({err / scale:.4f} of max|logit| "
            f"{scale:.4e}) <= {tol}"
            + (f"; planted faults {'; '.join(faults)}, each > {tol}"
               if faults else "")
            + f"; served tokens == single process for {agree}/{n} requests"
            + (" (bf16, not held)" if m.cfg.is_moe else
               f", at each difference the single-process margin <= 2 x "
               f"the step's max|delta| (largest margin / delta "
               f"{worst:.3f})")
            + f" [{card}] ({recs[0]['serve_s']:.2f} s)")
    log(f"phase llm-mesh: {MESH_RANKS} ranks {ranks_s:.2f} s "
        f"({time.perf_counter() - t_phase:.2f} s with the references)")


def dryrun_start(out):
    """Start ``phase dryrun``'s processes (host only, one fake world of 256
    ranks each): ``repro_torch.launch.dryrun`` of ``DRYRUN_COMBOS``,
    writing to ``out``; ``dryrun_phase`` waits for them."""
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    return [(arch, shape, extra, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", out, *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for arch, shape, extra in DRYRUN_COMBOS]


def dryrun_phase(procs, out):
    """``phase dryrun``: each record's keys, chips and per-device numbers
    printed; its seconds are the process's, which ran beside ``phase
    llm-mesh``."""
    t_phase = time.perf_counter()
    for arch, shape, extra, t0, proc in procs:
        text, _ = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        assert proc.returncode == 0, text
        rec = json.loads((Path(out) / f"{arch}__{shape}__single.json")
                         .read_text())
        assert rec["chips"] == 256, rec["chips"]
        assert rec["analysis_mode"] == ("scan" if extra
                                        else "unrolled"), rec
        mem = rec["memory_analysis"]
        assert mem["peak_memory_in_bytes"] > 0, mem
        r, h = rec["roofline"], rec["roofline_h100"]
        log(f"phase dryrun {arch} x {shape} x single "
            f"({rec['analysis_mode']}): per device flops "
            f"{rec['flops_per_device']:.6e}, bytes "
            f"{rec['bytes_per_device']:.6e}, collectives "
            + ", ".join(f"{k} {v}" for k, v in rec["collectives"].items()
                        if v) + f", peak memory "
            f"{mem['peak_memory_in_bytes']} B (args "
            f"{mem['argument_size_in_bytes']}, out "
            f"{mem['output_size_in_bytes']}, temp "
            f"{mem['temp_size_in_bytes']}); roofline tpu-v5e "
            f"{r['dominant']} {r['step_time_lb_s'] * 1e3:.4f} ms, "
            f"h100 {h['dominant']} {h['step_time_lb_s'] * 1e3:.4f} ms; "
            f"model flops {rec['model_flops_global']:.6e} "
            f"({secs:.2f} s in its process)")
    log(f"phase dryrun: {time.perf_counter() - t_phase:.2f} s after "
        f"phase llm-mesh")


def _served(m, mix):
    """``m.serve(*mix)`` then ``m.graphs`` on it: a summary of the serve
    for the phase's line, the engine itself dropped (its captured step
    holds the weights and a cache).  The graphed decode ms/step stands
    beside the step's bytes bound: every weight read once (the MoE's
    batched experts read all of theirs; a step reads one row of the
    embedding table a token, not counted) and the K/V rows of the
    longest request's last step in every layer and row of the batch, at
    the card's HBM rate (``h100()``)."""
    eng, reqs, results, *rest = m.serve(*mix)
    m.graphs(mix[0], eng, reqs, results, *rest)
    cfg, B = m.cfg, mix[4]
    steps = sum(max(r.max_new_tokens for r in reqs[i:i + B]) - 1
                for i in range(0, len(reqs), B))
    dec_ms = sum(results[i].decode_ms for i in range(0, len(reqs), B)) \
        / steps
    wbytes = sum(t.numel() * t.element_size() for t in m._leaves(m.params))
    emb = m.params["embed"]
    wbytes -= emb.numel() * emb.element_size()
    rows = max(len(r.prompt) + r.max_new_tokens - 1 for r in reqs)
    kv = (2 * cfg.num_layers * B * rows * cfg.num_kv_heads * cfg.head_dim_
          * emb.element_size())
    bound = (wbytes + kv) / h100().hbm_bw * 1e3
    return (f"served block_bytes {eng.block_bytes} B, kv_arena_peak_bytes "
            f"{eng.stats.kv_arena_peak_bytes} B; graphed decode "
            f"{dec_ms:.3f} ms/step against a bytes bound of {bound:.4f} ms "
            f"({(wbytes + kv) / 1e9:.3f} GB: weights but the embedding "
            f"table, {rows} K/V rows)")


def dense_phase(torch, np, device, paths, attn, card):
    """``phase llm-dense``: each model of ``DENSE_MIXES`` at full width
    and depth, one at a time, each freed before the next: the short mix
    through the launcher's engine (its block bytes, K7 once a layer a
    prefill, K8 once a layer a step), ``phase graphs``, the L1 report and
    the reordered step at cache 96, then in float32 (``DENSE_*_TOL``)
    card vs CPU at two layers and, the weights widened in place, the
    continuation at full depth.  Then K8 timed at GLM-4-9B's group of 16
    at the long mix's shape (``K8_GLM``) beside its bytes bound."""
    from repro_torch.kernels.decode_attention.ops import plan_chunks
    t_phase = time.perf_counter()
    for arch, mix in DENSE_MIXES:
        t0 = time.perf_counter()
        m = Llm(torch, np, device, paths, attn, card, arch=arch, mix=mix)
        cfg, label = m.cfg, f"llm-{mix[0]}"
        served = _served(m, mix)
        m.reorder(label, mix[5:6])
        if cfg.qkv_bias:    # the launcher's zeros: seeded values instead
            gen = torch.Generator(device=device).manual_seed(0)
            for n in ("bq", "bk", "bv"):
                b = m.params["blocks"][n]
                b.copy_(DENSE_BIAS_STD * torch.randn(
                    b.shape, generator=gen, device=device))
        cpu = m.card_vs_cpu(label, *m.float32(layers=CPU_LAYERS),
                            tol=DENSE_CPU_TOL)
        gc.collect()
        m.widen()
        cont = m.continuation(label, tol=DENSE_CONT_TOL)
        group = cfg.num_heads // cfg.num_kv_heads
        log(f"phase llm-dense {arch}: {cfg.num_layers} layers (full depth),"
            f" d {cfg.d_model}, H {cfg.num_heads} / K {cfg.num_kv_heads} of "
            f"{cfg.head_dim_} (group {group}: K8 in {plan_chunks(group)} "
            f"chunk(s) of heads a kv head), QKV bias {cfg.qkv_bias}"
            + (f" (std {DENSE_BIAS_STD} in the float32 checks)"
               if cfg.qkv_bias else "")
            + f"; {served}; continuation ratio {cont:.3e} (tolerance "
            f"{DENSE_CONT_TOL}, "
            f"float32, full depth); card vs CPU ratio {cpu:.3e} (tolerance "
            f"{DENSE_CPU_TOL}, float32, {CPU_LAYERS} layers); K7 "
            f"{m.n_k7}/prefill, K8 {m.n_k8}/step [{card}] "
            f"({time.perf_counter() - t0:.2f} s)")
        del m
        gc.collect()
        torch.cuda.empty_cache()
    B, S, H, K, D, lengths = K8_GLM
    attn.timing("decode_attention", card, label="GLM-4-9B group 16 (2 "
                "chunks) at the long mix's shape", config=(
                    (B, H, D), (B, S, K, D), torch.bfloat16,
                    torch.tensor(lengths, dtype=torch.int32)))
    log(f"phase llm-dense: {time.perf_counter() - t_phase:.2f} s")


def phi_moe_phase(torch, np, device, paths, attn, card):
    """``phase llm-phi-moe``: Phi-3.5-MoE at full width, its depth cut to
    ``PHI_MOE_LAYERS`` of 32, as ``phase llm-moe`` runs Granite: the
    short mix, ``phase graphs``, the reordered step at cache 96, card vs
    CPU at two layers in float32 (capacity factor 1.25) and, the weights
    widened in place, the continuation over the 8 layers at capacity
    factor E/k."""
    t0 = time.perf_counter()
    m = Llm(torch, np, device, paths, attn, card, arch=PHI_MOE_ARCH,
            mix=PHI_MOE_MIX, layers=PHI_MOE_LAYERS)
    cfg, label = m.cfg, f"llm-{PHI_MOE_MIX[0]}"
    served = _served(m, PHI_MOE_MIX)
    m.reorder(label, PHI_MOE_MIX[5:6])
    cpu = m.card_vs_cpu(label, *m.float32(layers=CPU_LAYERS),
                        tol=MOE_CPU_TOL)
    gc.collect()
    E, k = cfg.num_experts, cfg.experts_per_token
    m.widen()
    cont = m.continuation(label, m.cfg.replace(capacity_factor=E / k),
                          m.params, tol=MOE_CONT_TOL)
    log(f"phase llm-phi-moe {PHI_MOE_ARCH}: full width (d {cfg.d_model}, H "
        f"{cfg.num_heads} / K {cfg.num_kv_heads} of {cfg.head_dim_}, {E} "
        f"experts top {k} of d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"depth {cfg.num_layers} of 32; {served}; continuation ratio "
        f"{cont:.3e} "
        f"(tolerance {MOE_CONT_TOL}, float32, {cfg.num_layers} layers, "
        f"capacity factor {E / k}); card vs CPU ratio {cpu:.3e} (tolerance "
        f"{MOE_CPU_TOL}, float32, {CPU_LAYERS} layers, capacity factor "
        f"{cfg.capacity_factor}); K7 {m.n_k7}/prefill, K8 {m.n_k8}/step "
        f"[{card}] ({time.perf_counter() - t0:.2f} s)")
    del m
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(torch, np, device, paths, card):
    """``phase train``: a full-width training run of Llama-3.2-3B through
    the launcher, the step as a CUDA graph against the eager step, the
    example's model learning on the card, and one step of every
    architecture on the card against the CPU.  No K1-K8 launch in any of
    it: training runs the chunked attention under autograd, as the
    reference does."""
    t0 = time.perf_counter()
    eager = train_llama(torch, np, device, paths, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_graph(torch, np, device, paths, card, eager)
    train_small(torch, paths, card)
    train_card_vs_cpu(torch, np, device, paths)
    log(f"phase train: {time.perf_counter() - t0:.2f} s")


def no_launches(launches, where):
    assert all(v == 0 for v in launches.values()), (where, launches)


def step_bound(cfg, B, S):
    """(seconds, derivation) of the least time one remat step could take:
    6 x the weights' FLOPs (every weight but the embedding lookup) plus
    the remat forward of the layers, bf16 on the tensor cores; the chunked
    attention's float32 products over every chunk (forward, recomputed
    forward, backward = 2 forwards) on the CUDA cores; AdamW's bytes
    (read p, g, both moments and g again for the norm, write p and both
    moments).  Summed, as the three run one after another."""
    from repro_torch.models.model import init_params
    meta = init_params(cfg, device="meta")
    n_all = sum(t.numel() for t in Llm._leaves(meta))
    n_layers = sum(t.numel() for t in meta["blocks"].values())
    rows = B * S
    mm = (6 * (n_all - meta["embed"].numel()) + 2 * n_layers) * rows
    skv = -(-S // cfg.attn_chunk) * cfg.attn_chunk
    attn = 4 * (4 * B * cfg.num_heads * S * skv * cfg.head_dim_) \
        * cfg.num_layers
    adam = n_all * (2 + 2 + 4 + 4 + 2 + 2 + 4 + 4)
    parts = (mm / h100().peak_flops, attn / H100_F32_OPS_PER_S,
             adam / h100().hbm_bw)
    return sum(parts), (f"matmuls {mm / 1e12:.2f} TFLOP bf16 "
                        f"{parts[0]:.4f} s + attention {attn / 1e12:.2f} "
                        f"TFLOP f32 {parts[1]:.4f} s + AdamW "
                        f"{adam / 1e9:.1f} GB {parts[2]:.4f} s")


def train_llama(torch, np, device, paths, card):
    """``phase train-llama``: ``repro_torch.launch.train.main --eager``
    at ``TRAIN_ARCH``'s full width and depth; each step after the warm-up
    with its ms, tokens/s, loss, grad_norm and the peak of
    ``max_memory_allocated``; then one more step under the profiler:
    device busy, idle share against the steps' median wall time, the
    five largest kernels.  K7/K8 launch no time.  Returns the run's
    record (``launcher_run``), taken before the profiled step: ``phase
    train-graph``'s reference."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    t0 = time.perf_counter()
    eager, run = launcher_run(torch, paths, TRAIN_ARCH, TRAIN_S, 1,
                              TRAIN_STEPS, eager=True)
    launches = eager["launches"]
    tokens, walls = TRAIN_B * TRAIN_S, []
    for i, rec in enumerate(run.steps[1:], 1):
        loss = float(rec["metrics"]["loss"])
        gnorm = float(rec["metrics"]["grad_norm"])
        assert math.isfinite(loss) and math.isfinite(gnorm), (loss, gnorm)
        walls.append(rec["seconds"])
        log(f"phase train-llama step {i}: {rec['seconds'] * 1e3:.3f} ms, "
            f"{tokens / rec['seconds']:.2f} tokens/s, loss {loss:.5f}, "
            f"grad_norm {gnorm:.5f}, max_memory_allocated "
            f"{rec['peak_bytes']} B [{card}]")
    batch = launch_train.device_batch(run.dataset.batch(TRAIN_STEPS), device)
    state = [run.state]

    def step():
        state[0], _ = run.step_fn(state[0], batch)

    paths.reset()
    busy, _, by_name = device_time(torch, step, reps=1)
    no_launches(paths.read(), "train-llama profile")
    wall = statistics.median(walls) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    cfg = get_config(TRAIN_ARCH)
    bound, how = step_bound(cfg, TRAIN_B, TRAIN_S)
    parts = step_parts(torch, cfg, state[0], batch, device)
    log(f"phase train-llama profile: B {TRAIN_B} x S {TRAIN_S}, one step "
        f"busy {dev(busy)} ms against the steps' median wall {wall:.3f} "
        f"ms: idle share "
        + (f"{1 - busy / wall:.3f}" if busy > 0 else "not measured")
        + f"; bound {bound * 1e3:.1f} "
        f"ms ({how}); largest: "
        + ", ".join(f"{n} {t:.3f} ms" for n, t in top)
        + f"; by events: {parts}; peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; K7/K8 launches "
        f"{launches['flash_attention']}/{launches['decode_attention']} "
        f"[{card}] ({time.perf_counter() - t0:.2f} s)")
    del run, state, batch
    return eager


def step_parts(torch, cfg, state, batch, device):
    """Where a training step's time goes, by CUDA events: the loss and its
    gradients (``loss_fn`` and ``torch.autograd.grad``), the chunked
    attention of one layer forward and backward at the step's shapes
    (a step runs it forward twice a layer with remat, backward once),
    and ``adamw_update`` with those gradients (it updates ``state``)."""
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_update, tree_leaves
    model, params, held = Model(cfg), state.params, {}

    def loss_and_grads():
        held.clear()
        loss, _ = model.loss_fn(params, batch)
        held["g"] = torch.autograd.grad(loss, tree_leaves(params))

    grads_ms = time_ms(torch, loss_and_grads, iters=2, warmup=1)
    gen = torch.Generator(device=device).manual_seed(9)
    B, S, H, K, D = TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim_
    q, k, v = (torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_()
               for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    pos = torch.arange(S, device=device)

    def attend():
        return chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                 q_positions=pos, kv_positions=pos)

    fwd_ms = time_ms(torch, attend, iters=5, warmup=1)
    g = torch.randn((B, S, H, D), generator=gen, device=device,
                    dtype=torch.bfloat16)
    both_ms = time_ms(torch, lambda: torch.autograd.grad(attend(), (q, k, v),
                                                         g),
                      iters=5, warmup=1)
    lr = torch.tensor(1e-6, device=device)
    adam_ms = time_ms(torch, lambda: adamw_update(
        params, held["g"], state.opt, lr=lr), iters=2, warmup=1)
    return (f"loss + gradients {grads_ms:.3f} ms, of which the chunked "
            f"attention ~{cfg.num_layers * (fwd_ms + both_ms):.3f} ms "
            f"({cfg.num_layers} layers x (forward {fwd_ms:.3f} + forward "
            f"and backward {both_ms:.3f} ms)); adamw_update {adam_ms:.3f} "
            f"ms")


def param_sums(torch, params):
    """Per parameter leaf, in ``tree_leaves`` order: (sum, sum of
    magnitudes), in float64, over pieces of 2^24 elements in order (a
    whole leaf widened to float64 would not fit beside a graph's pool)."""
    from repro_torch.training.optimizer import tree_leaves

    def sums(t):
        parts = t.detach().reshape(-1).split(1 << 24)
        return (sum(float(p.double().sum()) for p in parts),
                sum(float(p.double().abs().sum()) for p in parts))
    return [sums(t) for t in tree_leaves(params)]


def launcher_run(torch, paths, arch, S, microbatches, steps, eager):
    """(record, run) of ``launch.train.main`` at ``arch``, B ``TRAIN_B`` x
    ``S``: eager (``--eager``) or graphed; the record holds every step's
    loss, grad_norm and wall ms, ``param_sums`` after the last step, the
    peak allocated and the reserved bytes, the kernels' launches (K1-K8
    launch no time) and, graphed, the capture and warm-up ms."""
    from repro_torch.launch import train as launch_train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paths.reset()
    run = launch_train.main(
        ["--arch", arch, "--steps", str(steps), "--batch", str(TRAIN_B),
         "--seq", str(S), "--microbatches", str(microbatches)]
        + (["--eager"] if eager else []))
    launches = paths.read()
    no_launches(launches, f"train {arch}")
    return {"loss": [float(r["metrics"]["loss"]) for r in run.steps],
            "gnorm": [float(r["metrics"]["grad_norm"]) for r in run.steps],
            "ms": [r["seconds"] * 1e3 for r in run.steps],
            "sums": param_sums(torch, run.state.params),
            "peak": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "capture_ms": run.capture_ms,
            "warmup_ms": run.warmup_ms, "launches": launches}, run


def run_spread(a, b):
    """max |a - b| over the loss, grad_norm and checksums of two
    records."""
    def worst(x, y):
        return max((abs(u - v) for u, v in zip(x, y)), default=0.0)
    return {"loss": worst(a["loss"], b["loss"]),
            "gnorm": worst(a["gnorm"], b["gnorm"]),
            "sums": worst([v for p in a["sums"] for v in p],
                          [v for p in b["sums"] for v in p])}


def busy_ms(torch, fn):
    """(busy, wall, activities) of one call of ``fn``: the ms of the
    card's activities ``torch.profiler`` records, summed from its raw
    events (a replayed xLSTM step has ~10^5 kernels; ``device_time``'s
    tree of named events would outlast the step), the call's own wall
    ms, the card synchronised before and after, and the number of those
    activities.  Busy 0: not measured."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
        if ns:
            return sum(ns) / 1e6, wall, len(ns)
    return 0.0, wall, 0


def stale_batch_step():
    """The planted fault: a ``GraphedTrainStep`` whose static batch is
    filled at the first call only, so every step trains on the first
    batch."""
    from repro_torch.training import GraphedTrainStep

    class StaleBatchStep(GraphedTrainStep):
        def _load(self, batch):
            if self._batch is None:
                super()._load(batch)
    return StaleBatchStep


def train_graph(torch, np, device, paths, card, eager_llama):
    """``phase train-graph``: each of ``GRAPH_RUNS`` through the launcher
    graphed beside its eager run (Llama's first: ``eager_llama``, from
    ``phase train-llama``): every step's loss and grad_norm and the
    parameter checksums equal (or within twice a measured eager spread);
    step ms and tokens/s eager and graphed, capture and warm-up ms, the
    busy time and idle share of one more, replayed step, peak allocated
    and reserved bytes.  Then ``train_graph_small``."""
    from repro_torch.cuda_graphs import WARMUP_RUNS
    from repro_torch.launch import train as launch_train
    t_phase = time.perf_counter()
    for arch, S, mb, steps, cut in GRAPH_RUNS:
        t0 = time.perf_counter()
        if (arch, S, mb, steps, cut) == GRAPH_RUNS[0]:
            eager = eager_llama
        else:
            eager, run = launcher_run(torch, paths, arch, S, mb, steps,
                                      eager=True)
            del run
        graphed, run = launcher_run(torch, paths, arch, S, mb, steps,
                                    eager=False)
        assert run.step_fn.graph is not None and \
            run.step_fn.calls == steps, run.step_fn.calls
        assert int(run.state.opt.step) == steps
        batch = launch_train.device_batch(run.dataset.batch(steps), device)
        state = [run.state]

        def step():
            state[0], _ = run.step_fn(state[0], batch)

        busy, wall, n_kernels = busy_ms(torch, step)
        no_launches(paths.read(), f"train-graph {arch} replay")
        del run, state, batch
        diff = run_spread(graphed, eager)
        if any(diff.values()):
            again, run = launcher_run(torch, paths, arch, S, mb, steps,
                                      eager=True)
            del run
            spread = run_spread(again, eager)
            held = (f"graphed != eager: max|d| loss {diff['loss']:.6e}, "
                    f"grad_norm {diff['gnorm']:.6e}, checksums "
                    f"{diff['sums']:.6e}; two eager runs: {spread['loss']:.6e}"
                    f", {spread['gnorm']:.6e}, {spread['sums']:.6e} (bound: "
                    f"twice those)")
            log(f"phase train-graph {arch}: {held}")
            assert all(diff[k] <= 2 * spread[k] for k in diff), (diff,
                                                                 spread)
        else:
            held = (f"every step's loss and grad_norm and the "
                    f"{len(graphed['sums'])} parameter leaves' float64 "
                    f"checksums graphed == eager bit for bit")
        tokens = TRAIN_B * S
        e_ms = statistics.median(eager["ms"][1:])
        g_ms = statistics.median(graphed["ms"][WARMUP_RUNS + 1:])
        log(f"phase train-graph {arch} B {TRAIN_B} x S {S}{cut}, "
            f"microbatches {mb}, {steps} steps: eager {e_ms:.3f} ms/step ({tokens / e_ms * 1e3:.2f} "
            f"tokens/s), graphed {g_ms:.3f} ms/step ({tokens / g_ms * 1e3:.2f} "
            f"tokens/s; the replays' median); capture "
            f"{graphed['capture_ms']:.3f} ms, warm-up calls "
            f"{graphed['warmup_ms']:.3f} ms, the capture's call "
            f"{graphed['ms'][WARMUP_RUNS]:.3f} ms; one more replayed "
            f"step under the profiler: {n_kernels} device activities, "
            f"busy "
            + (f"{busy:.3f} ms, idle share {1 - busy / wall:.3f} of its "
               f"{wall:.3f} ms, {1 - busy / g_ms:.3f} against the "
               f"replays' median (the profiler's cost a kernel is in the "
               f"first)" if busy > 0 else "not measured")
            + f"; {held}; losses {graphed['loss']}; peak allocated eager "
            f"{eager['peak']} B graphed {graphed['peak']} B, reserved "
            f"eager {eager['reserved']} B graphed {graphed['reserved']} B; "
            f"K1-K8 launches 0 [{card}] ({time.perf_counter() - t0:.2f} s)")
    train_graph_small(torch, device, paths, card)
    log(f"phase train-graph: {time.perf_counter() - t_phase:.2f} s")


def train_graph_small(torch, device, paths, card):
    """``phase train-graph`` at ``train-card-vs-cpu``'s sizes: for each
    of ``TRAIN_CPU_ARCHS`` two eager runs and a graphed run of
    ``GRAPH_SMALL_STEPS`` steps from copies of one float32 state, each
    step with its own batch; every parameter, moment, the step and every
    step's metrics of the graphed run equal to the first eager run's, or
    within twice the two eager runs' difference tensor by tensor.  For
    the first architecture the planted fault too."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.model import Model
    from repro_torch.training import (GraphedTrainStep, TrainState,
                                      adamw_init, make_train_step)
    from repro_torch.training.optimizer import tree_leaves
    assert not torch.backends.cuda.matmul.allow_tf32
    t_all = time.perf_counter()
    for arch in TRAIN_CPU_ARCHS:
        t0 = time.perf_counter()
        cfg, params, layers = small_train_model(torch, device, arch)
        model = Model(cfg)
        ds = SyntheticLMDataset(cfg, TRAIN_CPU_B, (cfg.num_patch_tokens or 0)
                                + TRAIN_CPU_S, TRAIN_CPU_SEED)
        batches = [{k: torch.as_tensor(v, device=device)
                    for k, v in ds.batch(i).items()}
                   for i in range(GRAPH_SMALL_STEPS)]

        def run(graphed=None):
            """The final parameters, moments and step, then each step's
            metrics (sorted by name) as one tensor a step."""
            p = tree_map(lambda t: t.detach().clone().requires_grad_(),
                         params)
            state = TrainState(p, adamw_init(p))
            step = make_train_step(model, peak_lr=TRAIN_CPU_LR, warmup=0,
                                   total_steps=10)
            if graphed is not None:
                step = graphed(step, device)
            paths.reset()
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append(torch.stack([m[k] for k in sorted(m)]))
            no_launches(paths.read(), f"train-graph {arch}")
            if graphed is not None:
                assert step.graph is not None
            return [t.detach() for t in tree_leaves(state.params)
                    + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
                    + [state.opt.step]] + metrics

        def gaps(a, b):
            return [float((x.double() - y.double()).abs().max())
                    for x, y in zip(a, b)]

        def losses(r):      # metrics sorted: aux, ce, grad_norm, loss, lr
            return [float(m[3]) for m in r[-GRAPH_SMALL_STEPS:]]

        first, second = run(), run()
        spread = gaps(first, second)
        got = gaps(run(GraphedTrainStep), first)
        over = [(i, g, s) for i, (g, s) in enumerate(zip(got, spread))
                if g > 2 * s]
        equal = sum(g == 0 for g in got)
        fault = ""
        if arch == TRAIN_CPU_ARCHS[0]:
            bound = 2 * max(abs(a - b) for a, b in zip(losses(first),
                                                      losses(second)))
            stale = max(abs(a - b) for a, b in zip(
                losses(run(stale_batch_step())), losses(first)))
            fault = (f"; planted fault (the static batch filled at the "
                     f"first call only): loss max|d| {stale:.6e} against "
                     f"the bound {bound:.6e}")
            assert stale > bound, (stale, bound)
        del second
        log(f"phase train-graph {arch}: {layers} layers at full width, "
            f"float32, B {TRAIN_CPU_B} x S {TRAIN_CPU_S}, "
            f"{GRAPH_SMALL_STEPS} steps: {equal} of {len(got)} tensors "
            f"(every parameter, both moments, step, each step's metrics) "
            f"graphed == eager bit for bit; two eager runs' largest "
            f"difference {max(spread):.6e}, graphed's {max(got):.6e} "
            f"(bound: twice the eager difference, tensor by tensor)"
            f"{fault}; K1-K8 launches 0 [{card}] "
            f"({time.perf_counter() - t0:.2f} s)")
        assert not over, (arch, over)
        del params, first, batches
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase train-graph small: {len(TRAIN_CPU_ARCHS)} architectures "
        f"({time.perf_counter() - t_all:.2f} s)")


def train_small(torch, paths, card):
    """``phase train-small``: ``examples_torch/train_small.py``'s ``main``
    on the card for ``SMALL_STEPS`` steps; its loss must fall by more
    than ``SMALL_DROP``."""
    import runpy
    import tempfile
    t0 = time.perf_counter()
    main = runpy.run_path(str(ROOT / "examples_torch" /
                              "train_small.py"))["main"]
    paths.reset()
    with tempfile.TemporaryDirectory() as d:
        losses = main(["--steps", str(SMALL_STEPS), "--batch", str(SMALL_B),
                       "--seq", str(SMALL_S), "--warmup", str(SMALL_WARMUP),
                       "--ckpt-dir", d])
    no_launches(paths.read(), "train-small")
    first = statistics.mean(losses[:5])
    last = statistics.mean(losses[-5:])
    log(f"phase train-small: {SMALL_STEPS} steps, B {SMALL_B} x S "
        f"{SMALL_S}: mean loss of the first five {first:.5f}, of the last "
        f"five {last:.5f} (must fall by > {SMALL_DROP}) [{card}] "
        f"({time.perf_counter() - t0:.2f} s)")
    assert last < first - SMALL_DROP, (first, last)


def moe_bf16_check(torch, cfg, params, device):
    """The MoE's expert products in bf16 under autograd on the card: one
    ``loss_fn`` and backward of ``cfg`` (bf16) through
    ``moe._BmmF32`` — cuBLAS's ``bmm(out_dtype=float32)`` forward and the
    Function's float32 backward — with every call's operands recorded;
    then at each recorded shape the Function's forward and gradients
    against autograd of the widened product ``bmm(a.float(),
    b.float())`` on the same operands and a seeded output gradient.  Both
    sum exact float32 products of K terms in other orders: each result is
    within K * 2^-24 * (|a| @ |b|) of the exact sum, so the two forwards
    within twice that, and a gradient, rounded to bf16 after that sum,
    within one bf16 ulp (2^-7 relative) more."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import tree_leaves
    t0 = time.perf_counter()
    apply, seen = moe._BmmF32.apply, {}

    def record(a, b):
        seen.setdefault((tuple(a.shape), tuple(b.shape)),
                        (a.detach(), b.detach()))
        record.calls += 1
        return apply(a, b)

    record.calls = 0
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             SyntheticLMDataset(cfg, TRAIN_CPU_B, TRAIN_CPU_S,
                                TRAIN_CPU_SEED).batch(0).items()}
    moe._BmmF32.apply = record
    try:
        loss, _ = Model(cfg).loss_fn(params, batch, remat=False)
        grads = torch.autograd.grad(loss, tree_leaves(params))
    finally:
        del moe._BmmF32.apply           # the inherited Function.apply
    assert record.calls == 3 * cfg.num_layers, record.calls
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
    gen = torch.Generator(device=device).manual_seed(8)

    def bound(x, y):            # K * 2^-24 * (|x| @ |y|), K = x.shape[-1]
        return x.shape[-1] * 2.0 ** -24 * torch.bmm(x.float().abs(),
                                                    y.float().abs())

    worst = 0.0
    for (sa, sb), (a, b) in seen.items():
        a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
        a2, b2 = a.float().requires_grad_(), b.float().requires_grad_()
        y1, y2 = apply(a1, b1), torch.bmm(a2, b2)
        g = torch.randn(y1.shape, generator=gen, device=device)
        got = torch.autograd.grad(y1, (a1, b1), g)
        want = [w.to(torch.bfloat16)
                for w in torch.autograd.grad(y2, (a2, b2), g)]
        checks = [(y1, y2, bound(a, b)),
                  (got[0], want[0], bound(g, b.transpose(1, 2))),
                  (got[1], want[1], bound(a.transpose(1, 2), g))]
        for x, w, bd in checks:
            excess = (x.float() - w.float()).abs() - (
                2 * bd + (2.0 ** -7 * w.float().abs()
                          if x.dtype == torch.bfloat16 else 0))
            worst = max(worst, float(excess.max()))
            assert float(excess.max()) <= 0, ((sa, sb), float(excess.max()))
    log(f"phase train-card-vs-cpu {cfg.name} bf16 experts: "
        f"{record.calls} bmm(out_dtype=float32) calls in one loss "
        f"(3 a layer), backward through _BmmF32; at shapes "
        f"{sorted(seen)} forward and gradients against the widened "
        f"product within the float32 sum bound (+ one bf16 ulp): largest "
        f"excess {worst:.3e} <= 0; loss {float(loss):.5f} "
        f"({time.perf_counter() - t0:.2f} s)")


def small_train_model(torch, device, arch, check_moe=False):
    """(cfg, params, layers): ``arch`` at full width, its depth cut to
    2 layers (Whisper 2 encoder + 2 decoder; one group of 6 for Zamba2
    and xLSTM), in float32, the MoE at
    capacity factor E / k, from seed 0 on the card; with ``check_moe``
    the MoE's bf16 expert products are checked first
    (``moe_bf16_check``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, model_layout
    cfg = get_config(arch)
    layers = 6 if model_layout(cfg).kind in ("zamba", "xlstm") else 2
    full = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
    changes = dict(num_layers=layers,
                   encoder_layers=layers if cfg.encoder_layers else 0)
    if cfg.is_moe:
        changes["capacity_factor"] = cfg.num_experts / cfg.experts_per_token
        if check_moe:
            moe_bf16_check(torch, cfg.replace(**changes),
                           cut_depth(full, layers), device)
    params = tree_map(lambda t: t.float(), cut_depth(full, layers))
    return cfg.replace(dtype="float32", **changes), params, layers


def train_card_vs_cpu(torch, np, device, paths):
    """``phase train-card-vs-cpu``: for each of ``TRAIN_CPU_ARCHS`` one
    ``make_train_step`` step from the same float32 parameters and zero
    moments on the card and on the CPU: loss, grad_norm, every gradient
    leaf (through the first moment) and every parameter after the step,
    each within its tolerance above."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.model import Model
    from repro_torch.training import TrainState, adamw_init, make_train_step
    from repro_torch.training.optimizer import tree_items, tree_leaves
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = torch.device("cpu")
    t_all = time.perf_counter()
    for arch in TRAIN_CPU_ARCHS:
        t0 = time.perf_counter()
        cfg, card, layers = small_train_model(torch, device, arch,
                                              check_moe=True)
        model = Model(cfg)
        batch = SyntheticLMDataset(
            cfg, TRAIN_CPU_B, (cfg.num_patch_tokens or 0) + TRAIN_CPU_S,
            TRAIN_CPU_SEED).batch(0)
        on_card = {k: torch.as_tensor(v, device=device)
                   for k, v in batch.items()}

        def grads(params):
            params = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, _ = model.loss_fn(params, on_card)
            return torch.autograd.grad(loss, tree_leaves(params))

        # the gradients' own float32 spread, on the card
        gen = torch.Generator(device=device).manual_seed(7)
        paths.reset()
        spread = [float((a - b).abs().max()) for a, b in zip(
            grads(card), grads(tree_map(lambda t: t * (1 + 2.0 ** -24 * (
                torch.randn(t.shape, generator=gen, device=device))),
                card)))]
        host = tree_map(lambda t: t.to(cpu, copy=True).requires_grad_(),
                        card)
        card = tree_map(lambda t: t.requires_grad_(), card)
        step = make_train_step(model, peak_lr=TRAIN_CPU_LR, warmup=0,
                               total_steps=10)
        got, mc = step(TrainState(card, adamw_init(card)), on_card)
        no_launches(paths.read(), f"train-card-vs-cpu {arch}")
        want, mp = step(TrainState(host, adamw_init(host)), batch)
        lc, lp = float(mc["loss"]), float(mp["loss"])
        nc, npu = float(mc["grad_norm"]), float(mp["grad_norm"])
        lr = float(mp["lr"])
        s = min(1.0, 1.0 / npu)
        worst_mu, spread_mu, worst_p, apart, n = (0.0, ""), 0.0, 0.0, 0, 0
        for (key, mu_c), mu_p, sp in zip(tree_items(got.opt.mu),
                                         tree_leaves(want.opt.mu), spread):
            err = float((mu_c.cpu() - mu_p).abs().max())
            scale = max(float(mu_p.abs().max()), 1e-30)
            sp = (1 - 0.9) * s * sp         # the spread of mu
            tol = max(TRAIN_GRAD_TOL * scale, 2 * sp)
            assert err <= tol, (arch, key, err, tol)
            worst_mu = max(worst_mu, (err / scale, key))
            spread_mu = max(spread_mu, sp / scale)
        for (key, p_c), p_p in zip(tree_items(got.params),
                                   tree_leaves(want.params)):
            diff = (p_c.detach().cpu() - p_p.detach()).abs()
            err = float(diff.max())
            assert err <= 2 * lr + 2.0 ** -22 * float(
                p_p.detach().abs().max()), \
                (arch, key, err, lr)
            worst_p = max(worst_p, err)
            apart += int((diff > lr / 2).sum())
            n += diff.numel()
        log(f"phase train-card-vs-cpu {arch}: {layers} layers at full "
            f"width, float32, B {TRAIN_CPU_B} x S {TRAIN_CPU_S}: loss card "
            f"{lc:.7f} cpu {lp:.7f} (|d|/|loss| {abs(lc - lp) / abs(lp):.3e}"
            f", tolerance {TRAIN_LOSS_TOL}); grad_norm card {nc:.7f} cpu "
            f"{npu:.7f} (|d|/norm {abs(nc - npu) / npu:.3e}, tolerance "
            f"{TRAIN_GRAD_TOL}); worst max|d mu| / max|mu| {worst_mu[0]:.3e} "
            f"({worst_mu[1]}), largest float32 spread / max|mu| "
            f"{spread_mu:.3e}; parameters after the step: max|d| "
            f"{worst_p:.3e} = "
            f"{worst_p / lr:.3f} lr, {apart} of {n} elements apart by > "
            f"lr/2; K1-K8 launches 0 ({time.perf_counter() - t0:.2f} s)")
        assert abs(lc - lp) <= TRAIN_LOSS_TOL * abs(lp), (arch, lc, lp)
        assert abs(nc - npu) <= TRAIN_GRAD_TOL * npu, (arch, nc, npu)
        del card, host, got, want
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase train-card-vs-cpu: {len(TRAIN_CPU_ARCHS)} architectures "
        f"({time.perf_counter() - t_all:.2f} s)")


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
    from repro_torch.graphs import (mobilenet_v1_graph, mobilenet_v2_graph,
                                    mobilenet_v3_large_graph,
                                    swiftnet_cell_graph)
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
    mnv2 = planned("mnv2 int8 budget=320K", mobilenet_v2_graph(*MNV2),
                   MNV2_INT8, quantize=True, arena_budget=MNV2_BUDGET)
    mnv3 = planned("mnv3 int8 budget=320K",
                   mobilenet_v3_large_graph(*MNV3), MNV3_INT8,
                   quantize=True, arena_budget=MNV2_BUDGET)
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
    # K9 and K10 get no timing line: their device times are the
    # benchmark's add_roofline and scale_roofline (portbench/, the
    # mnv2_int8_320k and mnv3l_int8_320k cells)
    timings = {name: checks.timing(name, card) for name in cnn_wrappers
               if name not in ("qadd", "qscale")}
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
    t0 = time.perf_counter()
    n_shapes, n_cases = checks.clamps_and_adds(mnv2)
    log(f"phase fused-add mnv2: {mnv2.schedule_result.method}, "
        f"{n_shapes} add and conv shapes, {n_cases} cases: K9 == ref.qadd, "
        f"K1-K5 with the linear and a binding ReLU6 clamp pair == their "
        f"plain versions; checked {checks.checked}, mismatches "
        f"{checks.mismatches} ({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in checks.mismatches.values()), checks.mismatches
    per_inf = paths.deployment("mnv2 int8 budget=320K", mnv2, 302,
                               exact=True)
    assert per_inf.get("qadd", 0) == sum(
        op.kind == "qadd" for op in mnv2.schedule), per_inf
    t0 = time.perf_counter()
    n_shapes, n_cases = checks.tables_and_scales(mnv3)
    log(f"phase tables mnv3: {mnv3.schedule_result.method}, {n_shapes} "
        f"channel-scale and table-conv shapes, {n_cases} cases: K10 == "
        f"ref.qmul, K1-K3 with their tables == their plain versions; "
        f"checked {checks.checked}, mismatches {checks.mismatches} "
        f"({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in checks.mismatches.values()), checks.mismatches
    per_inf = paths.deployment("mnv3 int8 budget=320K", mnv3, 303,
                               exact=True)
    assert per_inf.get("qscale", 0) == sum(
        op.kind == "qmul" for op in mnv3.schedule), per_inf
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
    # PERF.md's K7/K8 rows, at the shapes of every earlier run: the long
    # mix's largest prefill and decode step (Whisper's encoder and cross
    # cache are larger and get lines of their own), and the short mix's
    # largest prefill.  Timed here rather than at the end: the profiler
    # loses more device records the more windows a run has opened
    # (PERF.md §7)
    timings.update({
        "flash_attention": attn.timing(
            "flash_attention", card, label="long mix's largest",
            config=attn.largest("flash_attention", n_k7["long"])),
        "decode_attention": attn.timing(
            "decode_attention", card, label="long mix's largest",
            config=attn.largest("decode_attention"))})
    attn.timing("flash_attention", card, label="short mix's largest prefill",
                config=attn.largest("flash_attention", n_k7["short"]))
    llm.continuation()
    llm.card_vs_cpu()
    llm.reorder("llm", REORDER_CACHES)
    window_phase(torch, np, device, paths, attn, card)
    gc.collect()
    torch.cuda.empty_cache()
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
    # the sharded model: two ranks on the card against this process, the
    # dry-run's host processes beside it
    with tempfile.TemporaryDirectory() as dry_out:
        dry = dryrun_start(dry_out)
        mesh_phase(torch, np, device, paths, attn, llm, moe, card)
        dryrun_phase(dry, dry_out)
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
    # the encoder-decoder and the vision-language decoder, one at a time,
    # the earlier models freed
    for arch, mix in CROSS_MIXES:
        t0 = time.perf_counter()
        m = Llm(torch, np, device, paths, attn, card, arch=arch, mix=mix)
        m.graphs(mix[0], *m.serve(*mix))
        if m.cfg.encoder_layers:
            attn.whisper_timings(card)
        label = f"llm-{mix[0]}"
        m.continuation(label, *m.float32(), tol=CROSS_CONT_TOL)
        m.card_vs_cpu(label, *m.float32(), tol=CROSS_CPU_TOL)
        m.reorder(label, mix[5:6])
        del m
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase {label}: {time.perf_counter() - t0:.2f} s")
    # the dense decoders and Phi-3.5-MoE, one at a time, the earlier
    # models freed
    dense_phase(torch, np, device, paths, attn, card)
    phi_moe_phase(torch, np, device, paths, attn, card)
    train_phase(torch, np, device, paths, card)
    t0 = time.perf_counter()
    n_main = attn.main_path()
    log(f"phase attention-main-path: K7/K8 vs plain at the {n_main} "
        f"launch configurations of the LLM phases not checked above: "
        f"checked {attn.checked}, mismatches {attn.mismatches} "
        f"({time.perf_counter() - t0:.2f} s)")
    assert all(v == 0 for v in attn.mismatches.values()), attn.mismatches
    checks.max_err.update(attn.max_err)
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
