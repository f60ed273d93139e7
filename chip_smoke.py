#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result. ``compile_cache`` runs beside
``serve_tp`` (whose ranks share the card over gloo: no speed of theirs
is a result), for the script's time:

- ``build``: compiles every kernel source under
  k8s_device_plugin_tpu_torch/csrc/ with nvcc, all at once; ptxas's
  registers and spills of every kernel instance.
- ``device_plugin``: the device-plugin daemon's path on this node, real
  roots (cmd/device_plugin.py and what it calls). (a) ``get_gpu_chips``
  finds the GPUs nvidia-smi lists, by UUID and normalised PCI address
  (nvidia-smi's ``[N/A]`` where the host hides PCI info), every device
  node opens, and where NVML loads and procfs shows GPUs both paths give
  the same ones. (b) The best-effort policy places one GPU; the Allocate
  core (plugin/allocation.py) gives its device specs (its node and the
  control nodes) and ``NVIDIA_VISIBLE_DEVICES`` = ``CUDA_VISIBLE_DEVICES``
  = its UUID. (c) A child process under exactly those envs loads B1's
  library built by ``build`` (no nvcc), launches B1 once at
  DP_CHILD_SHAPE against its plain version (TOL) and reports the UUID
  CUDA shows, which must be the allotted one. (d) Where grpcio and
  protobuf import: the daemon's own command under a kubelet stub on the
  port's api copies: Register, the first ListAndWatch list (one Healthy
  device per GPU with its NUMA node), GetPreferredAllocation and
  Allocate equal to (b)'s, a clean exit on SIGTERM; otherwise the line
  says ``"grpc": false`` and (a)–(c) decide.
- ``metrics_exporter``: the metrics exporter (cmd/metrics_exporter.py,
  exporter/telemetry.py, exporter/runtime.py over NVML) and the device
  plugin's health through it. (a) In process: ``read_runtime_metrics``
  ("nvml") and ``read_chip_telemetry`` for each GPU against nvidia-smi by
  UUID: memory total within 1 MiB (the memory gauges must be there),
  utilisation, temperature (within 3 °C) and the PCIe link present
  exactly where nvidia-smi prints a number, the link exact; what NVML
  answered and refused; one read's latency. (b) A child holds 4 GiB on
  the card and launches B1 (phase_build's library, no nvcc) for 3 s
  while NVML is read every 0.2 s: usage rises by 4 GiB less 256 MiB,
  utilisation reads above 0 (where nvidia-smi shows it), usage comes
  back within 512 MiB within 10 s of the child's exit. (c) The
  exporter's command on a scratch dev root of symlinks to /dev/nvidia*:
  List gives each GPU by key, healthy; /metrics the families of (a),
  held to nvidia-smi read beside the scrape; /healthz 200 with every
  GPU healthy. (d) The device plugin's command under the kubelet stub
  with ``--health-socket`` at
  (c)'s socket and ``--pulse 1``: the first list Healthy, Unhealthy
  within 10 pulses of the GPU's symlink going (the 3-of-5 demote rule;
  the real node still opens), Healthy within 15 of its return (the
  lifecycle's soak cut to ME_SOAK_S), SIGTERM: both exit 0, both sockets
  gone. grpcio and protobuf must import.
- ``kernel``: each kernel's wrapper against its plain PyTorch version on
  the card, at the serving path's shapes and edge cases, with the
  tolerances stated in KERNEL_CASES (a rank's share of the serving
  default at tp2 among them); CUDA-event times of the kernel, the
  plain version and one PyTorch library call, beside the kernel's bound,
  with the achieved TFLOP/s and the bound's share of the kernel's time,
  and the wrapper's host time per call (host clock).
- ``model``: DecoderLM at the serving default's full width, the kernel
  against plain attention: greedy tokens identical in float32, logits
  within atol 0.1 / rtol 0.05 in bfloat16.
- ``profile``: torch.profiler over one admission prefill and one decode
  segment at the serving default (rows KV), and over one 64-token paged
  prefill chunk, one paged decode segment and one paged speculative
  segment (2-layer self-draft, k = 4; 4 rows at ~1000 tokens, pages of
  16): device busy time, idle share, launches, host reads (the spec
  segment's must be one a verify round plus the entry test), the
  largest kernels.
- ``kernel_paged``: the paged-attention kernel B2 against the plain
  paged read on the card (PAGED_CASES: decode steps and prefill chunks
  at the serving default with ragged row lengths up to 1024, the
  profile's 4 rows at 1000 tokens, rows on split boundaries, GQA, MQA,
  pages of 8 and 16, rows on the scratch page, d = 128 and 256 on both
  routes, the speculative verify block at L = 4 for MHA and GQA, a
  rank's share at tp2 of the serving default and of TinyLlama in both
  types; the tolerances in PAGED_TOL), two launches bit-equal; each
  case's route and splits (paged_attn_plan); CUDA-event times of B2, the
  plain version and SDPA over already-gathered K/V (a yardstick that
  skips the page indirection), beside B2's bound by bytes.
- ``serve``: the llm-serve daemon (models/serve_http.main) in-process
  on a free port at the full-width default config, bf16, rows KV,
  --max-batch 4, warmed up: concurrent completions of mixed prompt
  lengths (one streamed), /healthz, /metrics, the kernels' launch counts
  over exactly this traffic, and a clean drain.
- ``serve_paged``: the same daemon at its default, paged KV: five
  completions of mixed prompt lengths (one streamed), the last sharing
  the first's page-aligned prefix; a prefix hit, copy-on-extend page
  copies, B2 launched exactly layers x (prefill chunks + decode steps)
  and B1 never over this traffic, /healthz, /metrics, a clean drain.
- ``serve_spec``: speculative decoding. float32 at the full-width
  default config: greedy tokens of ``complete_batch_spec`` and of paged
  and rows ContinuousBatchers with a 2-layer self-draft at k = 4
  identical to the plain paths', each with verify rounds; a perfect
  draft (draft = target) identical too, with more than one token a row
  a round. Then the daemon at its default with ``--draft-layers 2
  --speculative-k 4`` over serve_paged's prompts, all greedy: /healthz's
  speculative block, the tpu_serve_speculative_* families, B2 launched
  exactly layers x (chunks + plain decode steps) + verify rounds x (k x
  draft layers + layers), aggregate tokens/s, and the share of its bf16
  tokens the plain paged path agrees with.
- ``serve_handoff``: the disaggregated roles. float32 at the full-width
  default config: a prefill/decode pair of paged ContinuousBatchers
  over the in-process transport serves single requests one after
  another (one a prefix hit) with tokens identical to the single paged
  engine's and logprobs within 1e-4. Then two daemons at their default
  (paged KV, bf16, --max-batch 4), ``--role prefill`` and ``--role
  decode --handoff-peer`` it, with ``ml_dtypes`` unimportable: the
  serve_paged traffic through the decode daemon over HTTP, every
  request exported and imported once (no fallback, no orphan, no lease
  left), B2 launched exactly layers x prefill chunks inside the prefill
  replica's dispatches and layers x decode steps inside the decode
  replica's, B1 never; aggregate tokens/s, the share of its bf16 tokens
  serve_paged's agree with, the hop's latency and bundle size; one bf16
  page block through export, bundle bytes and import, bit-equal.
- ``serve_static``: the static batcher. float32 at the default config's
  full width (STATIC_LAYERS layers): the ``Batcher``'s tokens for the serve phase's prompts
  equal ``complete_batch``'s over the same batches and the rows
  ContinuousBatcher's, logprobs within 1e-4. Then the daemon with
  ``--batching static --max-batch 4 --batch-window-ms 8 --warmup-tokens
  48`` (bf16) over the serve phase's traffic: startup with warmup, TTFTs,
  aggregate tokens/s, the static groups; B1 launched exactly layers x
  prefills during warmup (row buckets x length buckets + 2 x row
  buckets, the reference's count) and layers x groups during the
  traffic, B2 never; no program built for the first time during the
  traffic; the share of its bf16 tokens the serve phase's agree with.
- ``serve_checkpoint``: serving from a checkpoint directory at
  TinyLlama-1.1B's published width (hidden 2048, 32 heads over 4 kv
  heads, MLP 5632 SwiGLU, RMSNorm, RoPE, vocab 32000, context 2048; its
  22 layers cut to CHECKPOINT_LAYERS), random weights from seed 0
  written by ``save_checkpoint``
  (float32): the file's bytes, the write's and ``LMServer(checkpoint=)``'s
  seconds; the loaded server equal to the in-memory one in float32
  (tokens identical, logprobs bit-equal); then two daemons from the one
  directory over serve_paged's traffic: the default (paged KV, B2
  launched exactly layers x (chunks + decode steps), B1 never) and
  ``--batching static`` (B1 layers x groups, B2 never), tokens/s, TTFTs,
  the bf16 agreement between the two. The directory is removed
  afterwards.
- ``compile_cache``: the persistent kernel cache (``--compile-cache-dir``,
  models/compile_cache.py) across four daemon processes at the default
  (paged KV, bf16, --max-batch 4) on one fresh directory under build/:
  a cold start (nvcc builds each library it launches and writes it back:
  cache misses = writes = nvcc runs = entries), a warm restart (no nvcc,
  hits = entries, no miss or write, ``phase="load"`` dispatches, tokens
  and logprobs identical to the cold run), a restart after truncating
  one entry (quarantined as ``*.corrupt-<ts>``, counted corrupt, rebuilt
  once, tokens identical) and a restart with ``compile_cache.read=error``
  armed (every library rebuilt, tokens identical, a clean exit); each
  run's startup seconds (spawn to /healthz 200) and TTFTs. Three of
  serve_paged's prompts go one after another, so every run's batches
  are the same.
- ``serve_moe``: switch-MoE layers. float32 at the width ``--experts 8``
  selects (``LMConfig(num_experts=8)``): greedy tokens of the rows and
  paged ContinuousBatchers with the kernels equal those with plain
  attention. Then the daemon with ``--experts 8`` at its default (paged
  KV, bf16, --max-batch 4) over serve_paged's traffic: B2 launched
  exactly layers x (prefill chunks + decode steps), B1 never, aggregate
  tokens/s, the share of its bf16 tokens the plain-attention path agrees
  with. Then three AdamW steps at the flagship width with 8 experts,
  kernels against plain attention from the same weights and tokens:
  finite losses within MOE_LOSS_RTOL, B1/B3/B4 each once per layer per
  step.
- ``serve_tp``: tensor-parallel serving (models/serve_engine.py on a ``dp
  x tp`` mesh, parallel/serve_ranks.py) over ranks that share the card
  (gloo; so its speeds are not results). The kernels are built in this
  process first; parallel/launch.py spawns the ranks
  (``workers.serve``). In float32, at the default config's full width
  (SERVE_TP_LAYERS layers) at ``tp2`` and ``dp2 x tp2`` (the paged and
  the rows ContinuousBatcher over the serve phases' five prompts, 48
  tokens each: one after another at ``tp2``, and all queued at once,
  where several rows must decode in one call, paged at ``tp2`` and both
  layouts at ``dp2 x tp2``) and at TinyLlama-1.1B's width (TINYLLAMA_LAYERS layers) at ``tp2`` (paged,
  the first two prompts: B2 at 16 q heads over 2 kv heads a rank):
  every rank's per-call results
  equal rank 0's, and the one-device engine driven with the same jobs
  gives rank 0's tokens and launches B1 and B2 as often as each rank.
  bf16 at ``tp2`` records its agreement. Then the daemon's
  own command, ``python -m torch.distributed.run --standalone
  --nproc-per-node N -m k8s_device_plugin_tpu_torch.models.serve`` at
  its default (bf16) from a checkpoint of the default width at
  SERVE_TP_LAYERS layers, paged at 2 ranks, and with ``--no-warmup``
  paged at 4 and ``--kv-cache rows`` at 2, the three at once:
  serve_paged's traffic answered
  through rank 0's port (the only one listening), SIGTERM to rank 0,
  every rank exiting 0; startup seconds, TTFTs, aggregate tokens/s and
  each rank's all-reduced bytes beside serve_paged's one-device figures.
- ``serve_handoff_tp``: the prefill/decode roles over ``dp x tp``
  ranks sharing the card (gloo; models/serve_engine.py ``export_pages``
  gathers a bundle's whole pages over tp, ``import_pages`` keeps each
  rank's kv heads). In float32 in process (``workers.handoff``), five
  pairs of paged ContinuousBatchers over the in-process transport,
  serve_paged's prompts one at a time, 48 tokens each: ``tp2 -> tp2``,
  ``tp2 -> one rank`` and ``one rank -> dp2 x tp2`` at the serving
  default's width (HANDOFF_TP_LAYERS layers, three prompts),
  TinyLlama's width (TINYLLAMA_LAYERS layers; 4 kv heads split over 2 ranks) at ``tp2``
  and the serving default's with 2 kv heads at ``tp4`` (16 q heads
  over 2 kv heads: shared), two prompts each, all in one spawn of 4
  ranks: tokens equal to the one-device single engine's and a
  one-device pair's, every request handed off with no lease left,
  every rank in step, a seeded page block through each replica's
  import and export bit for bit, the bundles' page bytes one device's
  (pages within workers.BUNDLE_TOL), each rank's B2 launches the
  one-device pair's for the replicas it serves. Then a bf16 daemon
  pair at the serving default under ``torch.distributed.run``, both
  ``--no-warmup``: ``--role prefill`` at 2 ranks and ``--role decode``
  at 2 ranks, serve_paged's traffic
  through the decode daemon, every request imported, one more hop's
  seconds and its bundle's page bytes (equal to serve_handoff's one-rank
  bundle's), each rank's B2 launches from its stop line (equal within a
  replica), the share of the texts the one-rank pair agrees with.
- ``kernel_bwd``: the backward kernels B3 (dQ) and B4 (dK/dV) through
  ``FlashAttention.backward`` against the plain backward on the same
  inputs, random output and lse cotangents, at the training shapes and
  edge cases of BWD_CASES (tolerances there); CUDA-event times of each
  kernel, the plain backward and SDPA's backward, beside the bounds, with
  TFLOP/s and bound shares; B3 and B4 each launched twice on the same
  inputs must give bitwise-equal dQ and dK/dV (one block owns each output
  row, and B4 sums GQA groups without atomics).
- ``train``: the trainer (models/train.main) at the ``LMConfig()``
  default, batch 8: 6 steps with checkpoints, then a resume to step 8;
  ``benchmark_train()`` at the flagship config (3 warm-up + 10 steps):
  step time, tokens/s, MFU, a falling loss; each of B1, B3, B4 launched
  exactly once per layer per step; float32 gradients of one
  flagship-width step (2 layers) with the kernels against plain
  attention.
- ``train_profile``: torch.profiler over one flagship training step:
  device busy time, idle share, the largest kernels, B1/B3/B4's share.
- ``train_parallel``: sharded training (parallel/, the sharded
  ``make_sharded_train_step`` and the trainer's mesh) over 4 ranks that
  share the one card: gloo, since NCCL refuses two ranks on one GPU,
  with point-to-point and all-to-all tensors staged through host memory
  (so its speed is not a result). The kernels are built in this process
  first; parallel/launch.py spawns the ranks, each printing its backend,
  device and staged bytes. Ring attention (causal and not) and Ulysses
  over ``sp4`` at the flagship attention width ``[2, 2048, 8, 128]`` and
  the trainer default's d = 64, bf16 and float32: output, LSE and
  dQ/dK/dV gathered whole against the one-device ``FlashAttention`` and
  the plain version (RING_TOL), and each rank's B1/B3/B4 launches by the
  ring's formulas (rank r of a causal ring: r + 1 of each; non-causal:
  4; Ulysses: 1). One step of the flagship width (2 layers, float32,
  batch 2) on ``sp4`` ring, ``sp4`` Ulysses, ``dp2 x tp2``, ``sp2 x
  tp2`` and ``dp2 x ep2`` with 4 experts: loss and every gathered
  gradient against the one-device step from the same weights and batch
  (TRAIN_GRAD_TOL), launches per layer by the same formulas, seconds of
  a second step beside the one-device step's. Then the trainer's own
  command, ``python -m torch.distributed.run --standalone
  --nproc-per-node 4 -m k8s_device_plugin_tpu_torch.models.train
  --steps 3 --mesh-axes dp,sp,tp --checkpoint-dir <dir>
  --checkpoint-every 3`` at the
  ``LMConfig()`` default (bf16), and one rank (in this process) with
  ``--steps 5`` that resumes from that directory: its losses within
  TRAINER_BF16_TOL (absolute) of the one-device trainer's; and two
  controls that this tolerance must see: the losses a 4-rank run that
  never stepped its optimizer, and a resume that restored nothing,
  would log.
- ``train_pp``: pipeline-parallel LM training (parallel/pipeline_1f1b.py,
  pipeline_interleaved.py; models/transformer_pp.py, transformer_tp.py)
  over ranks sharing the card (gloo). float32 at lm-train-pp's width
  (embed 1024, 8 heads, mlp 4096, seq 2048; lm-train-pp-tp's 16 heads)
  cut to TRAIN_PP_LAYERS layers, batch 4, seed-0 weights, in process
  (``workers.pp_train``): pp4 (1F1B, M = 4), pp2 x chunks 2
  (interleaved), dp2 x pp2 (M = 2), pp2 x tp2 and dp2 x pp2 x tp2 with
  the fused update: every rank's loss within 1e-5 and every gradient
  within 2e-4 (allclose) of one device's autograd through
  transformer_pp.reference_loss, B1 launched 2·M·L/S times and B3, B4
  M·L/S times on each rank; the fused step's parameters the unfused
  one's. Then the two pods' commands under ``torch.distributed.run``
  at full width (bf16, 8 layers): ``transformer_pp --steps 3 --batch 8
  --microbatches 4`` at 4 ranks and ``transformer_tp ... --dp 2 --tp 2
  --chunks 2 --fuse-update`` at 8, the two at once: the reference's
  line, a finite final loss below the first step's, the same embedding
  and head on every rank.
- ``convnets``: the conv workloads (models/alexnet.py, resnet.py,
  mobilenet.py, inception.py; ops/s2d.py's stems). One train step of
  AlexNet (224^2, batch 4), ResNet-50 (224^2, 2), MobileNetV2 (224^2, 4)
  and InceptionV3 (299^2, 2) from one seeded init and batch, on the card
  against the CPU path in float64: in float64, the loss and train-mode
  logits and every parameter and running statistic after it within 1e-4;
  in float32 (TF32 off), the loss and logits within 1e-4 and each
  tensor's error recorded, beside the CPU's own float32 step's.
  Then the example pod's command as a process (``python -m
  k8s_device_plugin_tpu_torch.models.alexnet --steps 100 --batch-size
  128 --json``: spawn-to-exit wall, img/s, a final loss below the first
  step's); ``benchmark()`` at the published batches for 20 steps each
  (AlexNet 1024, bench/hw.py's; ResNet-50 256, resnet-tpu.yaml's;
  ResNet-50, MobileNetV2, InceptionV3 32, the convnet pod's): img/s and peak
  memory; the flagship forward (__graft_entry__: AlexNet inference,
  batch 16) by CUDA events; torch.profiler over one AlexNet step at
  batch 128 and one ResNet-50 step at batch 256 (busy time, idle share,
  launches, largest kernels, TFLOP/s from the layer shapes against the
  bf16 peak); ``space_to_depth_conv`` against ``direct_conv`` at the
  stems' shapes (float32 outputs agree, bf16 times). No kernel of the
  port launches: B1-B4's counts stay 0.

Then the card's name and power limit (nvidia-smi), the ``{"kernels":
[...]}`` line and, last, ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
before any phase.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import logging
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): memory bytes/s
# and operations/s by input type. bound_ms = max(bytes / HBM, ops / peak).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# (name, batch, heads, kv_heads, seq, head_dim, dtype, causal). The first
# case is the serving path's widest prefill at the default config
# ([rows=4, 16 heads, 1024 tokens, d=64], bf16, causal): its times are
# the ones reported for the kernel.
KERNEL_CASES = [
    ("serve_b4_s1024_bf16", 4, 16, 16, 1024, 64, "bfloat16", True),
    # TinyLlama-1.1B's attention (32 q heads over 4 kv heads, d = 64): the
    # static checkpoint daemon's widest prefill
    ("tinyllama_b4_s1024_bf16", 4, 32, 4, 1024, 64, "bfloat16", True),
    ("b1_s1_bf16", 1, 16, 16, 1, 64, "bfloat16", True),
    ("b1_s128_bf16", 1, 16, 16, 128, 64, "bfloat16", True),
    ("b1_s1024_bf16", 1, 16, 16, 1024, 64, "bfloat16", True),
    ("b4_s128_bf16", 4, 16, 16, 128, 64, "bfloat16", True),
    ("b1_s128_f32", 1, 16, 16, 128, 64, "float32", True),
    ("b1_s1024_f32", 1, 16, 16, 1024, 64, "float32", True),
    ("b4_s128_f32", 4, 16, 16, 128, 64, "float32", True),
    ("b4_s1024_f32", 4, 16, 16, 1024, 64, "float32", True),
    ("gqa_d128_bf16", 2, 16, 4, 512, 128, "bfloat16", True),
    ("gqa_d128_f32", 2, 16, 4, 512, 128, "float32", True),
    ("noncausal_bf16", 2, 8, 8, 256, 64, "bfloat16", False),
    ("noncausal_d128_f32", 2, 8, 8, 256, 128, "float32", False),
    ("s200_bf16", 2, 8, 8, 200, 64, "bfloat16", True),
    ("s200_f32", 2, 8, 8, 200, 64, "float32", True),
    ("s129_d128_bf16", 2, 8, 2, 129, 128, "bfloat16", True),
    # the trainer default's shape (LMConfig(): d = 64)
    ("train_b8_s2048_d64_bf16", 8, 8, 8, 2048, 64, "bfloat16", True),
    # the flagship training shape (reported as B1's training time)
    ("train_b8_s2048_d128_bf16", 8, 8, 8, 2048, 128, "bfloat16", True),
    # d = 256 runs its own instance; d = 192 is zero-padded to it
    ("d256_b2_s2048_bf16", 2, 8, 8, 2048, 256, "bfloat16", True),
    ("d256_gqa_s512_f32", 2, 8, 2, 512, 256, "float32", True),
    ("d256_s129_bf16", 2, 4, 4, 129, 256, "bfloat16", False),
    ("pad_d192_s512_bf16", 2, 8, 8, 512, 192, "bfloat16", True),
    ("pad_d192_s200_f32", 2, 4, 2, 200, 192, "float32", True),
    # a rank's share of the serving default at tp2 (8 q heads over 8 kv
    # heads, d = 64): the rows batcher's prefills under serve_tp
    ("tp2_serve_b4_s1024_bf16", 4, 8, 8, 1024, 64, "bfloat16", True),
    ("tp2_serve_b4_s1024_f32", 4, 8, 8, 1024, 64, "float32", True),
    ("tp2_serve_b2_s200_f32", 2, 8, 8, 200, 64, "float32", True),
]
TP_FWD_CASES = ("tp2_serve_b4_s1024_bf16", "tp2_serve_b4_s1024_f32",
                "tp2_serve_b2_s200_f32")
TRAIN_FWD_CASE = "train_b8_s2048_d128_bf16"
TINYLLAMA_FWD_CASE = "tinyllama_b4_s1024_bf16"
# Tolerances against the plain version on the same inputs. float32: the
# two differ only in summation order. bfloat16: the plain version rounds
# QK^T to bf16 before the softmax (as the reference's jnp code does) and
# the kernel keeps it in fp32; at unit-normal inputs that moves scaled
# scores by up to ~1e-2, and O is rounded to bf16 on output.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}

# Backward cases, same fields. The first is the flagship training shape
# (benchmark_train's config: batch 8, 8 heads, 2048 tokens, d = 128) and
# gives the times reported for B3 and B4; the second is the trainer's
# LMConfig() default (d = 64). "pad_d32" runs d = 32 through the
# zero-padding to the kernels' 64.
BWD_CASES = [
    ("train_b8_s2048_d128_bf16", 8, 8, 8, 2048, 128, "bfloat16", True),
    ("train_b8_s2048_d64_bf16", 8, 8, 8, 2048, 64, "bfloat16", True),
    ("gqa_d128_bf16", 2, 16, 4, 512, 128, "bfloat16", True),
    ("gqa_d128_f32", 2, 16, 4, 512, 128, "float32", True),
    ("noncausal_d128_bf16", 2, 8, 8, 256, 128, "bfloat16", False),
    ("noncausal_d64_f32", 2, 8, 8, 256, 64, "float32", False),
    ("s200_bf16", 2, 8, 8, 200, 64, "bfloat16", True),
    ("s200_f32", 2, 8, 8, 200, 64, "float32", True),
    ("pad_d32_bf16", 2, 8, 8, 256, 32, "bfloat16", True),
    # d = 256 (B4 as two column halves per key tile); d = 192 padded to it
    ("d256_b2_s2048_bf16", 2, 8, 8, 2048, 256, "bfloat16", True),
    ("d256_gqa_s512_bf16", 2, 8, 2, 512, 256, "bfloat16", True),
    ("d256_gqa_s256_f32", 1, 8, 2, 256, 256, "float32", True),
    ("d256_s129_bf16", 2, 4, 4, 129, 256, "bfloat16", False),
    ("pad_d192_s512_bf16", 2, 8, 8, 512, 192, "bfloat16", True),
    ("pad_d192_s200_f32", 1, 4, 2, 200, 192, "float32", True),
]
# Backward tolerances, on max |kernel - plain| / max |plain| of each of
# dQ, dK, dV. float32: summation order only. bfloat16: the kernels round
# P and dS to bf16 as the A operands of their tensor-core products (the
# plain version keeps fp32); the reference's own bf16 backward bar is
# 0.25 (tests/test_workloads.py:147-150).
BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# float32 gradients of a whole flagship-width step, kernels vs plain
# attention, relative to each parameter's largest gradient.
TRAIN_GRAD_TOL = 1e-3


_T0 = time.perf_counter()


def _jline(obj) -> None:
    """Print one JSON line; a phase's line gets ``at_s``, the script's
    seconds when the phase ended."""
    if "phase" in obj:
        obj["at_s"] = time.perf_counter() - _T0
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after ``warmup`` calls). The launches
    queue behind a sleep kernel that outlasts their enqueueing, so a
    kernel shorter than its wrapper's host time is timed on the device,
    not at the host's pace. ``queued=False`` leaves the sleep out (the
    host-paced timer of earlier revisions of this script, kept to compare
    revisions with it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued:
        # ~2 GHz: twice the calls' host time, at least 1 ms
        torch.cuda._sleep(int(4e9 * max(1e-3, iters * host_s)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host time of one ``fn`` call in ms (host clock over ``iters``
    calls, no synchronisation between them): what the wrapper costs the
    host per launch, however short the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def attention_ops(b, h, s, d, causal, products: int = 2) -> float:
    """FLOP of ``products`` attention-shaped products (2 per multiply-add)
    over the query/key pairs the mask leaves visible."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return products * 2.0 * b * h * d * pairs


def attention_bound_ms(b, h, kvh, s, d, dtype, causal) -> tuple[float, str]:
    """(least ms, what bounds it) for one flash forward: Q, K, V read
    once, O and LSE written once, over HBM; the QK^T and PV products over
    the card's peak for the input type."""
    import torch

    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    nbytes = esize * (2 * b * h * s * d + 2 * b * kvh * s * d) + 4 * b * h * s
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = attention_ops(b, h, s, d, causal) / PEAK_OPS_PER_S[f"torch.{dtype}"]
    return 1e3 * max(t_bytes, t_ops), \
        ("operations" if t_ops >= t_bytes else "bytes")


def rates(row: dict, ms_key: str, bound_key: str, ops: float,
          prefix: str = "") -> None:
    """Achieved TFLOP/s and the bound's share of the measured time."""
    row[f"{prefix}tflops"] = ops / (row[ms_key] * 1e-3) / 1e12
    row[f"{prefix}bound_share"] = row[bound_key] / row[ms_key]


def phase_build() -> dict:
    from k8s_device_plugin_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.compile_source, names)))
    report = {}
    for name, (_, text) in built.items():
        report.update(ptxas_report(text))
    spills = sorted(k for k, v in report.items()
                    if re.search(r"[1-9]\d* bytes spill", v))
    return {"phase": "build", "ok": True, "kernels": names,
            "seconds": time.perf_counter() - t0, "ptxas": report,
            "kernels_with_spills": spills}


_TYPE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}


def _demangle_kernel(mangled: str) -> str:
    """``..21flash_fwd_bf16_kernelILi128ELb1EE..`` -> ``flash_fwd_bf16_kernel
    <128,1>``, ``..24paged_attn_decode_kernelI13__nv_bfloat16Li64EE..`` ->
    ``paged_attn_decode_kernel<bf16,64>`` (Itanium names carry their length
    before them)."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length may follow other digits
            ident = mangled[m.end():m.end() + int(m.group()[i:])]
            if ident.endswith("_kernel"):
                args = re.match(r"I((?:L[ib]\d+E|f|13__nv_bfloat16)+)E",
                                mangled[m.end() + len(ident):])
                vals = re.findall(r"L[ib](\d+)E|(f|13__nv_bfloat16)",
                                  args.group(1)) if args else []
                names = [n or _TYPE_ARGS[t] for n, t in vals]
                return f"{ident}<{','.join(names)}>"
    return mangled


def ptxas_report(text: str) -> dict:
    """``-Xptxas -v`` output as {"kernel<template args>": "Used N
    registers; spill stores, spill loads"}, plus any C75xx advice."""
    report, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _demangle_kernel(m.group(1))
            report[name] = ""
        elif name and ("spill" in ln or "Used" in ln):
            report[name] = (report[name] + "; " + ln.split(":")[-1].strip()
                            if "Used" in ln else ln.strip())
        elif "C75" in ln:
            report.setdefault("advice", []).append(ln.strip()[:200])
    return report


def phase_kernel() -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F

    from k8s_device_plugin_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, worst = [], 0.0
    for name, b, h, kvh, s, d, dt, causal in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, kvh, s, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, kvh, s, d, device="cuda", generator=gen).to(dtype)
        # a head dim without its own instance goes through the padding
        fwd = attention.flash_forward_cuda
        if attention.kernel_head_dim(d) != d:
            fwd = attention.flash_attention_with_lse
        out, lse = fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention.reference_attention_with_lse(
            q, k, v, causal)
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"kernel {name}: non-finite output")
        if max(err_o, err_l) > TOL[dt]:
            raise AssertionError(
                f"kernel {name}: |O - plain| {err_o:.3g}, |LSE - plain| "
                f"{err_l:.3g} over tolerance {TOL[dt]}")
        worst = max(worst, err_o, err_l)
        ke, ve = attention.expand_kv(k, h), attention.expand_kv(v, h)
        row = {
            "case": name, "shape": [b, h, kvh, s, d], "dtype": dt,
            "causal": causal, "max_abs_err_out": err_o,
            "max_abs_err_lse": err_l, "tol": TOL[dt],
            "ms": cuda_ms(lambda: fwd(q, k, v, causal)),
            "host_ms": host_ms(lambda: fwd(q, k, v, causal)),
            "plain_ms": cuda_ms(
                lambda: attention.reference_attention_with_lse(
                    q, k, v, causal), iters=5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=causal)),
        }
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, kvh, s, d, dt, causal)
        rates(row, "ms", "bound_ms", attention_ops(b, h, s, d, causal))
        cases.append(row)
    main = cases[0]
    train = next(c for c in cases if c["case"] == TRAIN_FWD_CASE)
    tiny = next(c for c in cases if c["case"] == TINYLLAMA_FWD_CASE)
    summary = {
        "name": attention.FLASH_FWD.name, "route": "cuda",
        "source": attention.FLASH_FWD.source,
        "replaces": attention.FLASH_FWD.replaces,
        "max_abs_err": worst, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "timed_case": main["case"], "host_ms": main["host_ms"],
        "train_case": {k: train[k] for k in (
            "case", "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
            "tflops", "bound_share")},
        "tinyllama_case": {k: tiny[k] for k in (
            "case", "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops", "bound_share")},
        "tp_cases": [{k: c[k] for k in (
            "case", "max_abs_err_out", "max_abs_err_lse", "tol", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for c in cases if c["case"] in TP_FWD_CASES],
    }
    return {"phase": "kernel", "ok": True, "cases": cases}, summary


def bwd_bound(b, h, kvh, s, d, dtype, causal, kernel) -> tuple[float, str]:
    """(least ms, what bounds it) of one backward kernel: B3 ("dq") reads
    q, k, v, dO, LSE, delta and writes dQ, three products (S, dP, dQ);
    B4 ("dkv") reads the same and writes dK, dV, four products (S, dP,
    dV, dK); 2 FLOP per multiply-add over the visible pairs."""
    import torch

    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    rows_h, rows_kv, products = (3, 2, 3) if kernel == "dq" else (2, 4, 4)
    nbytes = esize * (rows_h * b * h + rows_kv * b * kvh) * s * d \
        + 8 * b * h * s
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = products * 2.0 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[f"torch.{dtype}"]
    return 1e3 * max(t_bytes, t_ops), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_bwd() -> tuple[dict, list]:
    """B3 and B4 through FlashAttention.backward, against the plain
    backward on the same saved tensors and cotangents."""
    import torch
    import torch.nn.functional as F

    from k8s_device_plugin_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, b, h, kvh, s, d, dt, causal in BWD_CASES:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        q, k, v = (rand(b, n, s, d).to(dtype) for n in (h, kvh, kvh))
        g, g_lse = rand(b, h, s, d).to(dtype), rand(b, h, s)
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out, lse = attention.FlashAttention.apply(qq, kk, vv, causal)
        torch.autograd.backward((out, lse), (g, g_lse))
        torch.cuda.synchronize()
        out, lse = out.detach(), lse.detach()
        want = attention.reference_attention_backward(q, k, v, out, lse, g,
                                                      g_lse, causal=causal)
        row = {"case": name, "shape": [b, h, kvh, s, d], "dtype": dt,
               "causal": causal, "tol": BWD_TOL[dt]}
        for gname, got, ref in zip(("dq", "dk", "dv"),
                                   (qq.grad, kk.grad, vv.grad), want):
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"kernel_bwd {name}: {gname} shape "
                                     f"{tuple(got.shape)} or non-finite")
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            row[f"rel_err_{gname}"] = rel
            row[f"max_abs_err_{gname}"] = diff
            kernel = "dq" if gname == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], diff)
            if rel > BWD_TOL[dt]:
                raise AssertionError(
                    f"kernel_bwd {name}: {gname} off the plain backward by "
                    f"{rel:.3g} of its largest value (tolerance "
                    f"{BWD_TOL[dt]})")
        if d in (64, 128, 256):
            delta = attention.attention_delta(out, g, g_lse)
            row["dq_ms"] = cuda_ms(lambda: attention.flash_bwd_dq_cuda(
                q, k, v, g, lse, delta, causal))
            row["dkv_ms"] = cuda_ms(lambda: attention.flash_bwd_dkv_cuda(
                q, k, v, g, lse, delta, causal))
            row["plain_ms"] = cuda_ms(
                lambda: attention.reference_attention_backward(
                    q, k, v, out, lse, g, g_lse, causal=causal),
                iters=3, warmup=1)
            # SDPA's backward alone (the whole dQ, dK, dV), over K/V
            # expanded to q's heads.
            qs, ke, ve = (x.clone().requires_grad_() for x in (
                q, attention.expand_kv(k, h), attention.expand_kv(v, h)))
            o = F.scaled_dot_product_attention(qs, ke, ve, is_causal=causal)
            row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                o, (qs, ke, ve), g, retain_graph=True))
            del o, qs, ke, ve
            for kernel, products in (("dq", 3), ("dkv", 4)):
                row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = \
                    bwd_bound(b, h, kvh, s, d, dt, causal, kernel)
                rates(row, f"{kernel}_ms", f"{kernel}_bound_ms",
                      attention_ops(b, h, s, d, causal, products),
                      prefix=f"{kernel}_")
            if dt == "bfloat16":
                # One block owns each dQ row (B3), and B4 sums each GQA
                # group in registers: two launches on the same inputs must
                # agree bit for bit.
                first = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                    causal)
                second = attention.flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                     causal)
                if not torch.equal(first, second):
                    raise AssertionError(f"kernel_bwd {name}: B3 is not "
                                         f"deterministic")
                row["dq_deterministic"] = True
                first = attention.flash_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                                     causal)
                second = attention.flash_bwd_dkv_cuda(q, k, v, g, lse,
                                                      delta, causal)
                if not all(torch.equal(x, y) for x, y in zip(first, second)):
                    raise AssertionError(f"kernel_bwd {name}: B4 is not "
                                         f"deterministic")
                row["dkv_deterministic"] = True
                del first, second
        cases.append(row)
        del q, k, v, g, qq, kk, vv, out, lse, want
        torch.cuda.empty_cache()
    main = cases[0]
    summaries = []
    for kernel, stats in (("dq", attention.FLASH_BWD_DQ),
                          ("dkv", attention.FLASH_BWD_DKV)):
        summaries.append({
            "name": stats.name, "route": "cuda", "source": stats.source,
            "replaces": stats.replaces, "max_abs_err": worst[kernel],
            "ms": main[f"{kernel}_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main[f"{kernel}_bound_ms"],
            "bound_by": main[f"{kernel}_bound_by"],
            "library_ms": main["library_ms"], "timed_case": main["case"],
        })
    return {"phase": "kernel_bwd", "ok": True, "cases": cases}, summaries


# Paged-attention cases of B2: (name, batch, L, heads, kv_heads, head_dim,
# page_tokens, row lengths, dtype). Row r's queries sit at positions
# lens[r] .. lens[r] + L - 1; a length of -1 is a row whose table points
# at scratch page 0 only (a padding row of the engine). The first case is
# a decode step of the serving default (4 rows, 16 heads, d = 64, pages
# of 16) with ragged lengths up to 1024 and gives the times reported for
# B2; the second a 64-token prefill chunk at the same shape.
PAGED_CASES = [
    ("decode_b4_p16_bf16", 4, 1, 16, 16, 64, 16, (1023, 700, 301, 37),
     "bfloat16"),
    ("chunk_b4_L64_p16_bf16", 4, 64, 16, 16, 64, 16, (960, 512, 100, 0),
     "bfloat16"),
    ("decode_b4_p16_f32", 4, 1, 16, 16, 64, 16, (1023, 700, 301, 37),
     "float32"),
    ("chunk_b4_L64_p16_f32", 4, 64, 16, 16, 64, 16, (960, 512, 100, 0),
     "float32"),
    ("gqa_decode_p8_bf16", 4, 1, 16, 4, 64, 8, (1000, 17, 5, -1),
     "bfloat16"),
    ("mqa_chunk_L16_p8_f32", 2, 16, 8, 1, 128, 8, (333, -1), "float32"),
    ("gqa_chunk_L64_p8_bf16", 3, 64, 8, 2, 128, 8, (900, 64, -1),
     "bfloat16"),
    ("d256_chunk_L8_p16_bf16", 2, 8, 8, 4, 256, 16, (700, 3), "bfloat16"),
    ("d256_decode_p16_f32", 2, 1, 8, 8, 256, 16, (511, -1), "float32"),
    # the profile's decode step: 4 rows at 1000 tokens
    ("decode_b4_1000_p16_bf16", 4, 1, 16, 16, 64, 16, (1000,) * 4,
     "bfloat16"),
    # rows whose keys end on a split's last key (128 keys a split here),
    # start the next split, or sit at position 0
    ("edge_decode_b4_p16_bf16", 4, 1, 16, 16, 64, 16, (127, 255, 0, 1023),
     "bfloat16"),
    ("edge_chunk_b4_L64_p16_bf16", 4, 64, 16, 16, 64, 16, (64, 128, 0, 960),
     "bfloat16"),
    ("edge_decode_b4_p16_f32", 4, 1, 16, 16, 64, 16, (127, 128, 0, 1023),
     "float32"),
    # d = 256 on the chunk route; GQA with 64 query rows a kv head
    ("d256_chunk_L16_p16_bf16", 2, 16, 8, 8, 256, 16, (700, 3), "bfloat16"),
    ("gqa_chunk_L8_n8_p16_bf16", 4, 8, 16, 2, 128, 16, (1000, 500, 60, 0),
     "bfloat16"),
    # the speculative verify block at k = 4 over the serving default: MHA
    # (4 query rows a kv head: the decode route in bf16 with L > 1) and
    # GQA with 4 q heads a kv head (16 rows: the chunk route's minimum)
    ("verify_b4_L4_p16_bf16", 4, 4, 16, 16, 64, 16, (1019, 700, 301, 37),
     "bfloat16"),
    ("verify_gqa_L4_p16_bf16", 4, 4, 16, 4, 64, 16, (1019, 700, 301, 37),
     "bfloat16"),
    # TinyLlama-1.1B's attention (32 q heads over 4 kv heads, n_rep 8), as
    # the checkpoint daemon runs it: a decode step (n_rep·L = 8: the decode
    # route) and a 64-token chunk, rows up to its 2048-token context
    ("tinyllama_decode_b4_p16_bf16", 4, 1, 32, 4, 64, 16,
     (2000, 1400, 700, 37), "bfloat16"),
    ("tinyllama_chunk_b4_L64_p16_bf16", 4, 64, 32, 4, 64, 16,
     (1920, 1024, 100, 0), "bfloat16"),
    ("tinyllama_decode_b4_p16_f32", 4, 1, 32, 4, 64, 16,
     (2000, 1400, 700, 37), "float32"),
    # a rank's share at tp2 (serve_tp): the serving default's 8 q heads
    # over 8 kv heads, and TinyLlama's 16 q heads over 2 kv heads (n_rep
    # 8), each a decode step (one with a padding row) and a 64-token
    # chunk, in both types; B2's plan follows the local head counts
    ("tp2_decode_b4_p16_bf16", 4, 1, 8, 8, 64, 16, (1023, 700, 301, 37),
     "bfloat16"),
    ("tp2_chunk_b4_L64_p16_bf16", 4, 64, 8, 8, 64, 16, (960, 512, 100, 0),
     "bfloat16"),
    ("tp2_decode_b4_p16_f32", 4, 1, 8, 8, 64, 16, (1023, 700, 37, -1),
     "float32"),
    ("tp2_chunk_b4_L64_p16_f32", 4, 64, 8, 8, 64, 16, (960, 512, 100, 0),
     "float32"),
    ("tp2_tinyllama_decode_b4_p16_bf16", 4, 1, 16, 2, 64, 16,
     (2000, 1400, 700, 37), "bfloat16"),
    ("tp2_tinyllama_chunk_b4_L64_p16_bf16", 4, 64, 16, 2, 64, 16,
     (1920, 1024, 100, 0), "bfloat16"),
    ("tp2_tinyllama_decode_b4_p16_f32", 4, 1, 16, 2, 64, 16,
     (2000, 1400, 37, -1), "float32"),
    ("tp2_tinyllama_chunk_b4_L64_p16_f32", 4, 64, 16, 2, 64, 16,
     (1920, 1024, 100, 0), "float32"),
]
# B2 against the plain paged read. float32: summation order only (fp32
# products on both sides). bfloat16: the plain version rounds the scores
# and the probabilities to bf16 (as the reference's gather does), B2 keeps
# them in fp32; outputs are rounded to bf16. bfloat16 outputs are also
# held row by row against the read in float32 from the same operands
# (paged_attention_fp32, P rounded on the chunk route), within
# PAGED_BF16_ROW_TOL of each row's largest value (ops/paged_attention.py).
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def paged_case_inputs(b, L, h, kvh, d, page_tokens, lens, dtype, gen):
    """(q, k_pages, v_pages, bt, q_pos, live pages) on the card for one
    case: each row's pages drawn from the pool in a scrambled order, the
    table one slot wider than the longest row needs, scratch page 0 in
    every slot a row does not use."""
    import torch

    span = max(max(lens) + L, L)
    W = -(-span // page_tokens) + 1
    pool_pages = 1 + b * W
    perm = torch.randperm(pool_pages - 1, generator=gen) + 1
    # int64, as the serving engine hands them to B2
    bt = torch.zeros((b, W), dtype=torch.int64)
    q_pos = torch.zeros((b, L), dtype=torch.int64)
    live = 0
    for r, n in enumerate(lens):
        q_pos[r] = max(n, 0) + torch.arange(L)
        used = -(-(max(n, 0) + L) // page_tokens)
        live += used
        if n >= 0:
            bt[r, :used] = perm[r * W:r * W + used]

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).cuda()

    return (rand(b, L, h, d), rand(pool_pages, page_tokens, kvh, d),
            rand(pool_pages, page_tokens, kvh, d), bt.cuda(), q_pos.cuda(),
            live)


def paged_bound_ms(b, L, h, kvh, d, page_tokens, live_pages, dtype,
                   q_pos) -> tuple[float, str]:
    """(least ms, what bounds it) of one paged read: each live K/V page
    read once, q read and out written once, over HBM; 4·d FLOP (QK^T and
    PV) per query and visible key over the card's peak for the type."""
    import torch

    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (esize * (2 * live_pages * page_tokens * kvh * d
                       + 2 * b * L * h * d)
              + q_pos.element_size() * q_pos.numel())
    visible = float((q_pos.double() + 1).sum().item()) * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * d * visible / PEAK_OPS_PER_S[str(dtype)]
    return 1e3 * max(t_bytes, t_ops), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_paged_kernel() -> tuple[dict, dict]:
    """B2 against the plain paged read on the card (PAGED_CASES), two
    launches bit-equal, CUDA-event times of B2, the plain version and
    SDPA over K/V already gathered into contiguous rows (a yardstick
    that skips the page indirection), beside B2's bound."""
    import torch
    import torch.nn.functional as F

    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    cases, worst, worst_row = [], 0.0, 0.0
    for name, b, L, h, kvh, d, page_tokens, lens, dt in PAGED_CASES:
        dtype = getattr(torch, dt)
        q, kp, vp, bt, q_pos, live = paged_case_inputs(
            b, L, h, kvh, d, page_tokens, lens, dtype, gen)
        args = (q, kp, vp, bt, q_pos)
        plan = pa.paged_attn_plan(b, L, h, kvh, d, page_tokens,
                                  bt.shape[1], dtype)
        out = pa.paged_attention_cuda(*args)
        again = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(*args)
        err = (out.float() - want.float()).abs().max().item()
        if not torch.isfinite(out).all() or err > PAGED_TOL[dt]:
            raise AssertionError(f"paged {name}: |B2 - plain| {err:.3g} "
                                 f"over tolerance {PAGED_TOL[dt]}")
        if not torch.equal(out, again):
            raise AssertionError(f"paged {name}: two launches differ")
        row_err = row_tol = None
        if dtype == torch.bfloat16:
            row_tol = pa.PAGED_BF16_ROW_TOL
            row_err = pa.row_rel_err(out, pa.paged_attention_fp32(
                *args, round_p=plan.route == "chunk"))
            if row_err > row_tol:
                raise AssertionError(
                    f"paged {name}: row |B2 - fp32 read| / row max "
                    f"{row_err:.3g} over {row_tol}")
            worst_row = max(worst_row, row_err)
        worst = max(worst, err)
        # The yardstick: SDPA over each row's gathered [W·P] keys with the
        # position mask, q heads over expanded kv heads.
        span = bt.shape[1] * page_tokens
        kc = kp[bt.long()].reshape(b, span, kvh, d).transpose(1, 2)
        vc = vp[bt.long()].reshape(b, span, kvh, d).transpose(1, 2)
        kc = kc.repeat_interleave(h // kvh, 1).contiguous()
        vc = vc.repeat_interleave(h // kvh, 1).contiguous()
        qs = q.transpose(1, 2).contiguous()
        mask = (torch.arange(span, device="cuda")[None, None, :]
                <= q_pos[:, :, None])[:, None]
        row = {
            "case": name, "shape": [b, L, h, kvh, d], "page_tokens":
            page_tokens, "lens": list(lens), "dtype": dt,
            "route": plan.route, "n_splits": plan.n_splits,
            "keys_per_split": plan.keys_per_split, "blocks": plan.blocks,
            "max_abs_err": err, "tol": PAGED_TOL[dt],
            "row_rel_err": row_err, "row_tol": row_tol,
            "bit_equal_launches": True, "live_pages": live,
            "ms": cuda_ms(lambda: pa.paged_attention_cuda(*args)),
            "host_ms": host_ms(lambda: pa.paged_attention_cuda(*args)),
            "plain_ms": cuda_ms(
                lambda: pa.paged_attention_reference(*args), iters=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask)),
        }
        row["bound_ms"], row["bound_by"] = paged_bound_ms(
            b, L, h, kvh, d, page_tokens, live, dtype, q_pos)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        cases.append(row)
        del args, q, kp, vp, kc, vc, qs, out, again, want
    torch.cuda.empty_cache()
    main, chunk = cases[0], cases[1]
    by_name = {c["case"]: c for c in cases}
    keys = ("case", "route", "n_splits", "ms", "host_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share")
    summary = {
        "name": pa.PAGED_ATTN.name, "route": "cuda",
        "source": pa.PAGED_ATTN.source, "replaces": pa.PAGED_ATTN.replaces,
        "max_abs_err": worst, "max_row_rel_err_bf16": worst_row,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "scaled_dot_product_attention over pre-gathered K/V "
                   "(a yardstick: it skips the page indirection)",
        "timed_case": main["case"], "host_ms": main["host_ms"],
        "timed_route": main["route"], "n_splits": main["n_splits"],
        "chunk_case": {k: chunk[k] for k in keys},
        "verify_cases": [{k: by_name[n][k] for k in keys} for n in (
            "verify_b4_L4_p16_bf16", "verify_gqa_L4_p16_bf16")],
        "tinyllama_cases": [{k: by_name[n][k] for k in keys} for n in (
            "tinyllama_decode_b4_p16_bf16",
            "tinyllama_chunk_b4_L64_p16_bf16")],
        "tp_cases": [{k: c[k] for k in keys + (
            "max_abs_err", "tol", "row_rel_err", "row_tol")}
            for c in cases if c["case"].startswith("tp2_")],
    }
    return {"phase": "kernel_paged", "ok": True, "cases": cases}, summary


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain PyTorch versions
    (the comparison side of the model, serve_moe and train phases): B1's
    flash attention and B2's paged read."""
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.ops import attention
    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

    kernels = transformer.flash_attention, transformer.paged_attention
    transformer.flash_attention = attention.reference_attention
    transformer.paged_attention = pa.paged_attention_reference
    try:
        yield
    finally:
        transformer.flash_attention, transformer.paged_attention = kernels


MODEL_PROMPT_LENS = (100, 300, 700, 900)


def phase_model() -> dict:
    """Full-width DecoderLM (the serving default), kernel vs plain."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        LMServer,
        default_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 32000, (n,), generator=rng).tolist()
               for n in MODEL_PROMPT_LENS]
    res = {"phase": "model", "prompt_lens": list(MODEL_PROMPT_LENS)}

    # float32: greedy tokens identical over 16 steps for 4 prompts.
    srv = LMServer(config=dataclasses.replace(default_config(),
                                              dtype=torch.float32),
                   device="cuda")
    budgets = [16] * len(prompts)
    got, _ = srv.complete_batch(prompts, budgets)
    with plain_attention():
        want, _ = srv.complete_batch(prompts, budgets)
    if got != want:
        raise AssertionError("model fp32: kernel and plain attention "
                             "decode different greedy tokens")
    res["fp32_greedy_identical"] = True
    res["fp32_tokens"] = [g[len(p):] for g, p in zip(got, prompts)]
    del srv
    torch.cuda.empty_cache()

    # bfloat16: prefill logits within atol 0.1 / rtol 0.05.
    srv = LMServer(device="cuda")
    bucket = srv._prefill_bucket(max(MODEL_PROMPT_LENS))
    toks = torch.tensor([p + [0] * (bucket - len(p)) for p in prompts],
                        device="cuda")
    got_logits, _ = srv._prefill(toks)
    with plain_attention():
        want_logits, _ = srv._prefill(toks)
    if not torch.isfinite(got_logits).all():
        raise AssertionError("model bf16: non-finite logits")
    diff = (got_logits - want_logits).abs()
    excess = (diff - (0.1 + 0.05 * want_logits.abs())).max().item()
    if excess > 0:
        raise AssertionError(f"model bf16: logits outside atol 0.1 / "
                             f"rtol 0.05 (by {excess:.3g})")
    res["bf16_max_abs_logit_diff"] = diff.max().item()
    res["bf16_logit_absmax"] = want_logits.abs().max().item()
    res["ok"] = True
    del srv
    torch.cuda.empty_cache()
    return res


def _device_events(prof):
    """(kernel name, device ms, calls) of every CUDA-side event. User
    annotations (``record_function`` ranges such as the optimizer's
    ``Optimizer.step#AdamW.step``) are skipped: they span kernels that
    are counted on their own."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, us / 1e3, e.count))
    return sorted(out, key=lambda x: -x[1])


def _host_reads(prof) -> int:
    """Device-to-host reads the host waited on (``aten::_local_scalar_dense``:
    ``.item()``, ``bool()`` of a CUDA tensor)."""
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_local_scalar_dense")


def _profiled(srv, fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall and device busy
    time, idle share, launches, host reads, verify rounds, the flash
    (B1) and paged (B2) kernels' time and the largest kernels. B2's
    launches are its wrapper's count; the profiler's count of its kernel
    events stands beside it (CUPTI can drop an activity record, so the
    trace may count one launch fewer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.ops.paged_attention import PAGED_ATTN

    torch.cuda.synchronize()
    srv.reset_spec_stats()
    launched = PAGED_ATTN.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = PAGED_ATTN.launches - launched
    events = _device_events(prof)
    busy = sum(ms for _, ms, _ in events)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "flash_fwd_ms": sum(ms for k, ms, _ in events if "flash_fwd" in k),
        "paged_attn_ms": sum(ms for k, ms, _ in events
                             if "paged_attn" in k),
        "kernels": len(events),
        "launches": sum(n for _, _, n in events),
        "paged_attn_launches": launched,
        "paged_attn_traced": sum(
            n for k, _, n in events if "paged_attn" in k
            and "combine" not in k),
        "host_reads": _host_reads(prof),
        "verify_rounds": srv.spec_stats_snapshot()["verify_rounds"],
        "top": [[k[:80], ms, n] for k, ms, n in events[:6]],
    }


def phase_profile() -> dict:
    """Device time of one admission prefill ([4 rows, 1024 tokens]) and
    one 16-token decode segment over 4 rows at the serving default
    (bf16, rows KV), of one paged prefill chunk and one paged decode
    segment at the same width, and of one 16-token paged speculative
    segment there (2-layer self-draft, k = 4), under torch.profiler:
    busy time, idle share of the wall time, launches, host reads, the
    largest kernels and the flash (B1) and paged (B2) kernels'
    shares."""
    import numpy as np
    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer

    srv = LMServer(device="cuda")
    rows, lb, seg = 4, srv.config.max_seq_len, 16
    gen = srv.generator(0)
    zeros = dict(temps=[0.0] * rows, topks=[0] * rows)

    def prefill():
        return srv.prefill_rows([[1] * lb] * rows, [lb] * rows,
                                zeros["temps"], zeros["topks"], gen)

    pool = srv.insert_rows(srv.make_pool_cache(rows), prefill()[0],
                           list(range(rows)))
    tok = np.ones((rows, 1), np.int64)
    temp, topk = np.zeros(rows, np.float32), np.zeros(rows, np.int64)

    def decode():
        return srv.decode_segment(pool, tok, gen, temp, topk, seg)

    # The paged programs at the same width: each row owns 64 pages of 16
    # (its whole 1024-token table); a 64-token chunk at positions
    # 960..1023, and a 16-step segment from position 1000.
    page_tokens, width = 16, lb // 16
    ppool = srv.make_paged_pool(rows * width + 1, page_tokens)
    bt = np.arange(1, rows * width + 1, dtype=np.int64).reshape(rows, width)
    ones, zeros_i = np.ones(rows, np.int64), np.zeros(rows, np.int64)

    def paged_chunk():
        return srv.paged_prefill_chunk(
            ppool, np.ones((rows, 64), np.int64), bt, 960 * ones,
            63 * ones, gen, temp, zeros_i)

    def paged_decode():
        return srv.paged_decode_segment(ppool, bt, tok, 1000 * ones, gen,
                                        temp, topk, seg)

    # The speculative segment over the same rows: each row's budget is
    # the segment; the verify block writes up to position 1019.
    srv.enable_draft(SPEC_DRAFT_LAYERS, k=SPEC_K)

    def paged_spec():
        return srv.paged_spec_segment(ppool, bt, tok, 1000 * ones,
                                      seg * ones, seg)

    decode()
    paged_chunk()
    paged_decode()
    paged_spec()
    torch.cuda.synchronize()
    res = {"phase": "profile", "rows": rows, "prompt_tokens": lb,
           "segment": seg, "paged": {"page_tokens": page_tokens,
                                     "table_width": width,
                                     "chunk_positions": [960, 1023],
                                     "decode_from": 1000},
           "spec": {"draft_layers": SPEC_DRAFT_LAYERS, "k": SPEC_K}}
    for name, fn in (("prefill", prefill), ("decode_segment", decode),
                     ("paged_prefill_chunk", paged_chunk),
                     ("paged_decode_segment", paged_decode),
                     ("paged_spec_segment", paged_spec)):
        res[name] = _profiled(srv, fn)
    spec, plain = res["paged_spec_segment"], res["paged_decode_segment"]
    rounds = spec["verify_rounds"]
    want = rounds * (SPEC_K * SPEC_DRAFT_LAYERS + srv.config.num_layers)
    if not 0 < rounds <= seg or spec["paged_attn_launches"] != want:
        raise AssertionError(
            f"profile: spec segment ran {rounds} rounds and "
            f"{spec['paged_attn_launches']} B2 launches, want {want}")
    # one read a round (the loop test after it) and the entry test
    if spec["host_reads"] != rounds + 1:
        raise AssertionError(
            f"profile: {spec['host_reads']} host reads in the spec segment "
            f"of {rounds} rounds, want {rounds + 1}")
    # every row's budget is the segment: the slowest row's own tokens a
    # round, above 1 only where it accepted drafts
    spec["row_tokens_per_round"] = seg / rounds
    spec["wall_vs_plain"] = spec["wall_ms"] / plain["wall_ms"]
    spec["busy_vs_plain"] = spec["device_busy_ms"] / plain["device_busy_ms"]
    res["ok"] = True
    del srv, pool, ppool
    torch.cuda.empty_cache()
    return res


def _post(port: int, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        status = resp.status
    return status, raw, time.perf_counter() - t0


def _get(port: int, path: str) -> tuple[int, str]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.read().decode()


def _metric_sum(text: str, family: str) -> float:
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(family + "{") or ln.startswith(family + " "):
            total += float(ln.rsplit(" ", 1)[1])
    return total


SERVE_PROMPT_LENS = (40, 300, 620, 900, 150)
SERVE_PROMPTS = tuple(("the quick brown fox jumps over the lazy dog " * 30)[:n]
                      for n in SERVE_PROMPT_LENS)
SERVE_MAX_TOKENS = 48


def _serve_traffic(port: int, what: str):
    """SERVE_PROMPTS at once, SERVE_MAX_TOKENS each: the first streamed,
    the others with ``"logprobs": 1``, the last sent 0.3 s after the
    others (a late join while they decode). Returns (completion tokens,
    TTFTs, decode tokens/s of each, wall s)."""
    results = [None] * len(SERVE_PROMPTS)

    def one(i):
        body = {"prompt": SERVE_PROMPTS[i], "max_tokens": SERVE_MAX_TOKENS,
                "logprobs": 1}
        if i == 0:
            body = {"prompt": SERVE_PROMPTS[i],
                    "max_tokens": SERVE_MAX_TOKENS, "stream": True}
        if i == len(SERVE_PROMPTS) - 1:
            time.sleep(0.3)  # a late join while the others decode
        results[i] = _post(port, body)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(SERVE_PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    ttfts, rates, completions = [], [], []
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"{what}: request {i} failed: {res}")
        status, raw, e2e = res
        if i == 0:
            frames = [ln[6:] for ln in raw.decode().splitlines()
                      if ln.startswith("data: ")]
            if not frames or frames[-1] != "[DONE]":
                raise AssertionError(f"{what}: stream lacks [DONE]")
            doc = json.loads(frames[-2])
        else:
            doc = json.loads(raw)
            lps = doc["choices"][0]["logprobs"]["token_logprobs"]
            if not lps or not all(v <= 0.0 and v == v for v in lps):
                raise AssertionError(f"{what}: bad logprobs {lps[:4]}")
        n_out = doc["usage"]["completion_tokens"]
        if n_out < 1:
            raise AssertionError(f"{what}: request {i} decoded nothing")
        completions.append(n_out)
        ttfts.append(doc["ttft_seconds"])
        rates.append((n_out - 1) / max(e2e - doc["ttft_seconds"], 1e-9))
    return completions, ttfts, rates, wall


def phase_serve(counters) -> dict:
    """The daemon in-process: concurrent completions through the
    entry point a user runs, with the kernels' counts over the traffic."""
    with _daemon(["--kv-cache", "rows", "--max-batch", "4"], "serve") as (
            httpd, batcher, startup_s):
        port = httpd.server_address[1]
        _, before = _get(port, "/metrics")
        prefills0 = _metric_sum(before, "tpu_serve_prefill_bucket_total")
        for c in counters:
            c.launches = 0
        completions, ttfts, rates, wall = _serve_traffic(port, "serve")
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")
        prefills = _metric_sum(after, "tpu_serve_prefill_bucket_total") \
            - prefills0
        code, health = _get(port, "/healthz")
        if code != 200 or json.loads(health).get("status") != "ok":
            raise AssertionError(f"serve: /healthz {code} {health}")
        for fam in ("tpu_serve_ttft_seconds", "tpu_serve_requests_total",
                    "tpu_serve_decode_step_seconds",
                    "tpu_serve_prefill_bucket_total",
                    "tpu_serve_jit_compiles_total",
                    "tpu_serve_phase_seconds"):
            if fam not in after:
                raise AssertionError(f"serve: /metrics lacks {fam}")
        n_layers = batcher.server.config.num_layers
        flash = launches["flash_fwd"]
        if prefills < 1 or flash < n_layers * prefills:
            raise AssertionError(
                f"serve: flash_fwd launched {flash} times for "
                f"{prefills} admission prefills of {n_layers} layers")
        # the yardstick of serve_static's bf16 agreement
        tokens = _inproc_tokens(batcher, SERVE_PROMPTS, logprobs=True)
    return {
        "phase": "serve", "ok": True, "startup_s": startup_s,
        "prompt_lens": list(SERVE_PROMPT_LENS),
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts, "decode_tokens_per_s": rates,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "admission_prefills": prefills, "launches": launches,
        "drained": True, "tokens": tokens,
    }


def _metric_labeled(text: str, family: str, label: str) -> float:
    """Sum of ``family``'s samples whose labels carry ``label`` (such as
    ``fn="paged_prefill"``)."""
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(family + "{") and label in ln.split("}")[0]:
            total += float(ln.rsplit(" ", 1)[1])
    return total


# The paged daemon's traffic: five prompts of mixed lengths; the last
# shares the first's page-aligned 320-byte prefix (20 pages of 16) and is
# sent once the first has its first token, so its prefix is published.
PAGED_PREFIX = ("the quick brown fox jumps over the lazy dog " * 8)[:320]
PAGED_PROMPTS = (
    PAGED_PREFIX + "and then it sat down in the sun",
    ("pack my box with five dozen liquor jugs " * 30)[:700],
    "hello there",
    ("sphinx of black quartz judge my vow " * 30)[:1000],
    PAGED_PREFIX + "but the dog did not wake up at all",
)


@contextlib.contextmanager
def _daemon(argv, what: str):
    """The llm-serve daemon (models/serve_http.main) in-process on a free
    port, warmed up: yields (httpd, batcher, startup seconds), then shuts
    it down and fails unless it drained clean."""
    from k8s_device_plugin_tpu_torch.models import serve_http

    ready = threading.Event()
    handle = {}

    def on_ready(httpd, batcher):
        handle["httpd"], handle["batcher"] = httpd, batcher
        ready.set()

    rc = {}
    daemon = threading.Thread(
        target=lambda: rc.setdefault("rc", serve_http.main(
            ["--port", "0", *argv], on_ready=on_ready)),
        name=f"llm-serve-{what}", daemon=True,
    )
    t_start = time.perf_counter()
    daemon.start()
    if not ready.wait(600):
        raise AssertionError(f"{what}: daemon not ready in 600 s")
    try:
        yield (handle["httpd"], handle["batcher"],
               time.perf_counter() - t_start)
    finally:
        handle["httpd"].shutdown()
        daemon.join(timeout=120)
    if daemon.is_alive() or rc.get("rc") != 0:
        raise AssertionError(f"{what}: drain not clean (rc {rc})")


def _paged_traffic(port: int, what: str, logprobs: bool):
    """PAGED_PROMPTS at once, SERVE_MAX_TOKENS each: the first streamed,
    the last sent once the first has its first token (its prefix is then
    published); the others with ``"logprobs": 1`` when ``logprobs``.
    Returns (the final JSON of each, completion tokens, TTFTs, wall s)."""
    results = [None] * len(PAGED_PROMPTS)
    published = threading.Event()

    def one(i):
        body = {"prompt": PAGED_PROMPTS[i],
                "max_tokens": SERVE_MAX_TOKENS}
        if i == 0:
            body["stream"] = True
        elif logprobs:
            body["logprobs"] = 1
        if i == len(PAGED_PROMPTS) - 1:
            published.wait(300)
        try:
            if i == 0:
                results[i] = _stream_until_first(port, body, published)
            else:
                results[i] = _post(port, body)
        finally:
            if i == 0:
                published.set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(PAGED_PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    docs, completions, ttfts = [], [], []
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"{what}: request {i} failed: {res}")
        doc = res[1] if i == 0 else json.loads(res[1])
        if i and logprobs:
            lps = doc["choices"][0]["logprobs"]["token_logprobs"]
            if not lps or not all(v <= 0.0 and v == v for v in lps):
                raise AssertionError(f"{what}: bad logprobs {lps[:4]}")
        if doc["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"{what}: request {i} decoded nothing")
        docs.append(doc)
        completions.append(doc["usage"]["completion_tokens"])
        ttfts.append(doc["ttft_seconds"])
    return docs, completions, ttfts, wall


def _deltas(before: str, after: str):
    """``delta(family, label=None)``: a /metrics family's growth between
    two scrapes (its samples carrying ``label`` when given)."""
    def delta(family, label=None):
        if label is not None:
            return (_metric_labeled(after, family, label)
                    - _metric_labeled(before, family, label))
        return _metric_sum(after, family) - _metric_sum(before, family)

    return delta


def phase_serve_paged(counters) -> dict:
    """The daemon in-process at its default (paged KV, full-width config,
    bf16, --max-batch 4), warmed up: concurrent completions, a prefix
    hit, copy-on-extend of shared tail pages, and B2 launched exactly
    layers x (prefill chunks + decode steps) over this traffic, B1
    never."""
    with _daemon(["--max-batch", "4"], "serve_paged") as (
            httpd, batcher, startup_s):
        port = httpd.server_address[1]
        if batcher.kv_mode != "paged":
            raise AssertionError(f"serve_paged: default KV layout is "
                                 f"{batcher.kv_mode}")
        _, before = _get(port, "/metrics")
        for c in counters:
            c.launches = 0
        _, completions, ttfts, wall = _paged_traffic(port, "serve_paged",
                                                     logprobs=True)
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")
        delta = _deltas(before, after)
        hits = delta("tpu_serve_kv_prefix_lookups_total", 'outcome="hit"')
        copies = delta("tpu_serve_kv_page_copies_total")
        reused = delta("tpu_serve_kv_prefix_tokens_reused_total")
        chunks = delta("tpu_serve_phase_seconds_count", 'fn="paged_prefill"')
        segments = delta("tpu_serve_phase_seconds_count",
                         'fn="paged_segment"')
        code, health = _get(port, "/healthz")
        if code != 200 or json.loads(health).get("status") != "ok":
            raise AssertionError(f"serve_paged: /healthz {code} {health}")
        for fam in ("tpu_serve_kv_pages_in_use_count",
                    "tpu_serve_kv_prefix_lookups_total",
                    "tpu_serve_kv_page_copies_total",
                    "tpu_serve_jit_compiles_total",
                    "tpu_serve_ttft_seconds", "tpu_serve_requests_total"):
            if fam not in after:
                raise AssertionError(f"serve_paged: /metrics lacks {fam}")
        layers = batcher.server.config.num_layers
        want = layers * (chunks + segments * batcher.segment)
        if hits < 1 or reused < len(PAGED_PREFIX) or copies < 1:
            raise AssertionError(f"serve_paged: prefix hits {hits}, tokens "
                                 f"reused {reused}, page copies {copies}")
        if launches["paged_attn"] != want or launches["flash_fwd"] != 0:
            raise AssertionError(
                f"serve_paged: launches {launches}; want paged_attn = "
                f"{layers} layers x ({chunks} chunks + {segments} segments "
                f"x {batcher.segment} steps) = {want}, flash_fwd = 0")
        # B2's combine runs after each launch whose plan splits the keys:
        # at least the long rows' decode steps, never more than B2 itself.
        if not 0 < launches["paged_attn_combine"] <= want:
            raise AssertionError(f"serve_paged: combine launches "
                                 f"{launches['paged_attn_combine']}, want "
                                 f"1 .. {want}")
        # the yardstick of serve_handoff's bf16 agreement
        tokens = _inproc_tokens(batcher, logprobs=True)
    return {
        "phase": "serve_paged", "ok": True, "startup_s": startup_s,
        "prompt_lens": [len(p) for p in PAGED_PROMPTS],
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "prefix_hits": hits, "prefix_tokens_reused": reused,
        "page_copies": copies, "prefill_chunks": chunks,
        "decode_segments": segments, "segment_tokens": batcher.segment,
        "page_tokens": batcher.kv_config.page_tokens,
        "pool_pages": batcher.kv_config.pool_pages,
        "launches": launches, "drained": True, "tokens": tokens,
    }


def _inproc_tokens(batcher, prompts=PAGED_PROMPTS, **kw):
    """The continuation token ids of ``prompts`` submitted at once to
    ``batcher`` in-process, SERVE_MAX_TOKENS each."""
    ids = [batcher.server.encode_prompt(p) for p in prompts]
    reqs = [batcher.submit_async(t, SERVE_MAX_TOKENS, **kw) for t in ids]
    return [batcher.wait(r, timeout=600)[0][len(t):]
            for r, t in zip(reqs, ids)]


def _agreement(got, want) -> dict:
    """The share of ``want``'s tokens that ``got`` has at the same
    position, and where each job first differs."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(len(w) for w in want)
    return {"share": same / total, "tokens": total,
            "first_divergence": _first_diff(got, want)}


# Speculative decoding: a 2-layer self-draft proposing 4 tokens a verify
# round (--draft-layers 2 --speculative-k 4). Its fp32 exactness runs on
# random prompts of SPEC_PROMPT_LENS tokens with mixed budgets.
SPEC_DRAFT_LAYERS = 2
SPEC_K = 4
SPEC_PROMPT_LENS = (100, 300, 700, 900)
SPEC_BUDGETS = (33, 17, 40, 9)


def _batcher_tokens(srv, jobs, kv_mode: str):
    """Token lists of ``jobs`` submitted at once to a fresh
    ContinuousBatcher over ``srv`` (4 rows, 16-token segments)."""
    from k8s_device_plugin_tpu_torch.models.serve_batch import (
        ContinuousBatcher,
    )

    eng = ContinuousBatcher(srv, max_batch=4, segment_tokens=16,
                            kv_mode=kv_mode)
    try:
        reqs = [eng.submit_async(p, n) for p, n in jobs]
        return [eng.wait(r, timeout=600)[0] for r in reqs]
    finally:
        eng.close()


def _first_diff(got, want) -> list:
    """Per job, the first position where two token lists differ (None
    where they are equal)."""
    out = []
    for g, w in zip(got, want):
        d = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 None if len(g) == len(w) else min(len(g), len(w)))
        out.append(d)
    return out


def _spec_exactness() -> dict:
    """float32 at full width (default_config, seed-0 weights): plain
    against speculative tokens through complete_batch_spec and the paged
    and rows ContinuousBatchers, then with a perfect draft (draft =
    target), which must accept more than one token a round."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        LMServer,
        default_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    srv = LMServer(config=dataclasses.replace(default_config(),
                                              dtype=torch.float32),
                   device="cuda")
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 32000, (n,), generator=rng).tolist()
               for n in SPEC_PROMPT_LENS]
    budgets = list(SPEC_BUDGETS)
    jobs = list(zip(prompts, budgets))
    plain = {"static": srv.complete_batch(prompts, budgets)[0],
             "paged": _batcher_tokens(srv, jobs, "paged"),
             "rows": _batcher_tokens(srv, jobs, "rows")}
    runs = {
        "static": lambda: srv.complete_batch_spec(prompts, budgets)[0],
        "paged": lambda: _batcher_tokens(srv, jobs, "paged"),
        "rows": lambda: _batcher_tokens(srv, jobs, "rows"),
    }
    out = {}

    def spec(name, base):
        srv.reset_spec_stats()
        got = runs[base]()
        st = srv.spec_stats_snapshot()
        if got != plain[base]:
            raise AssertionError(
                f"serve_spec fp32 {name}: speculative tokens differ from "
                f"plain at {_first_diff(got, plain[base])}")
        if st["verify_rounds"] < 1:
            raise AssertionError(f"serve_spec fp32 {name}: no verify round")
        out[name] = {**st, "tokens_per_round":
                     st["tokens"] / st["verify_rounds"], "identical": True}

    srv.enable_draft(SPEC_DRAFT_LAYERS, k=SPEC_K)
    for name in ("static", "paged", "rows"):
        spec(name, name)
    # The perfect draft of the reference's tests: every proposal matches,
    # so rounds accept k tokens and overshoot each budget.
    srv.draft_model, srv.draft_config = srv.model, srv.config
    srv._spec_cache.clear()
    for base in ("static", "paged"):
        spec(f"perfect_{base}", base)
    # Tokens a round sum over the rows in flight, so they pass 1 even
    # when no draft is accepted. Multi-token acceptance shows in the
    # rounds: the static rows run in lockstep, so without it the longest
    # row alone needs a round a token; the paged rows are staggered by
    # chunked prefill, so the random draft's rounds on the same jobs are
    # the yardstick.
    longest = max(SPEC_BUDGETS) - 1
    for name, bar in (("perfect_static", longest),
                      ("perfect_paged", out["paged"]["verify_rounds"])):
        if out[name]["tokens_per_round"] <= 1 \
                or out[name]["verify_rounds"] >= bar:
            raise AssertionError(f"serve_spec fp32 {name}: {out[name]}, "
                                 f"want fewer than {bar} rounds")
    out["paged_equals_static_plain"] = plain["paged"] == plain["static"]
    del srv
    torch.cuda.empty_cache()
    return out


def phase_serve_spec(counters) -> dict:
    """Speculative decoding on the card: fp32 exactness at full width
    (_spec_exactness), then the daemon at its default (paged KV, bf16,
    --max-batch 4) with --draft-layers 2 --speculative-k 4 over the
    serve_paged prompts, all greedy without logprobs: /healthz's
    speculative block, the three tpu_serve_speculative_* families, B2
    launched exactly layers x (chunks + plain decode steps) + verify
    rounds x (k x draft layers + layers), B1 never; then the share of
    its bf16 tokens that the plain paged path (the same requests with
    logprobs, which never speculate) agrees with."""
    fp32 = _spec_exactness()
    argv = ["--max-batch", "4", "--draft-layers", str(SPEC_DRAFT_LAYERS),
            "--speculative-k", str(SPEC_K)]
    with _daemon(argv, "serve_spec") as (httpd, batcher, startup_s):
        port = httpd.server_address[1]
        srv = batcher.server
        if batcher.kv_mode != "paged" or srv.spec_k != SPEC_K:
            raise AssertionError(f"serve_spec: {batcher.kv_mode} KV, "
                                 f"k {srv.spec_k}")
        _, before = _get(port, "/metrics")
        for c in counters:
            c.launches = 0
        _, completions, ttfts, wall = _paged_traffic(port, "serve_spec",
                                                     logprobs=False)
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")
        delta = _deltas(before, after)
        chunks = delta("tpu_serve_phase_seconds_count", 'fn="paged_prefill"')
        plain_segments = delta("tpu_serve_phase_seconds_count",
                               'fn="paged_segment"')
        spec_segments = delta("tpu_serve_phase_seconds_count",
                              'fn="paged_spec_loop"')
        rounds = delta("tpu_serve_speculative_verify_rounds_total")
        spec_tokens = delta("tpu_serve_speculative_tokens_total")
        code, health = _get(port, "/healthz")
        block = json.loads(health).get("speculative")
        if code != 200 or not block or block["verify_rounds"] != rounds \
                or block["tokens"] != spec_tokens:
            raise AssertionError(f"serve_spec: /healthz {code} {health}, "
                                 f"{rounds} rounds in /metrics")
        for fam in ("tpu_serve_speculative_tokens_total",
                    "tpu_serve_speculative_verify_rounds_total",
                    "tpu_serve_speculative_accept_ratio"):
            if f"# TYPE {fam} " not in after:
                raise AssertionError(f"serve_spec: /metrics lacks {fam}")
        layers = srv.config.num_layers
        want = (layers * (chunks + plain_segments * batcher.segment)
                + rounds * (SPEC_K * SPEC_DRAFT_LAYERS + layers))
        if rounds < 1 or launches["paged_attn"] != want \
                or launches["flash_fwd"] != 0:
            raise AssertionError(
                f"serve_spec: launches {launches}; want paged_attn = "
                f"{layers} x ({chunks} chunks + {plain_segments} plain "
                f"segments x {batcher.segment}) + {rounds} rounds x "
                f"({SPEC_K} x {SPEC_DRAFT_LAYERS} + {layers}) = {want}, "
                f"flash_fwd = 0")
        # bf16 agreement: the same prompts again, all at once, greedy
        # (speculative) and then with logprobs (the plain segment).
        agreement = _agreement(_inproc_tokens(batcher),
                               _inproc_tokens(batcher, logprobs=True))
    return {
        "phase": "serve_spec", "ok": True, "fp32": fp32,
        "startup_s": startup_s, "draft_layers": SPEC_DRAFT_LAYERS,
        "k": SPEC_K, "prompt_lens": [len(p) for p in PAGED_PROMPTS],
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "healthz_speculative": block, "verify_rounds": rounds,
        "spec_tokens": spec_tokens, "tokens_per_verify_round":
        spec_tokens / rounds, "spec_segments": spec_segments,
        "plain_segments": plain_segments, "prefill_chunks": chunks,
        "segment_tokens": batcher.segment, "launches": launches,
        "bf16_agreement": agreement, "drained": True,
    }


# The handoff phase's fp32 exactness: single requests one after another,
# the last sharing the first's first 256 tokens (16 pages of 16).
HANDOFF_PROMPT_LENS = (700, 100, 300)
HANDOFF_BUDGET = 24
HANDOFF_LP_TOL = 1e-4


def _handoff_exactness() -> dict:
    """float32 at full width (default_config, seed-0 weights): a
    prefill/decode pair of paged ContinuousBatchers over the in-process
    transport against the single paged engine, requests one at a time,
    greedy with logprobs: tokens identical, logprobs within
    HANDOFF_LP_TOL, every request handed off."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
    from k8s_device_plugin_tpu_torch.models.serve_batch import (
        ContinuousBatcher,
    )
    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        LMServer,
        default_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    srv = LMServer(config=dataclasses.replace(default_config(),
                                              dtype=torch.float32),
                   device="cuda")
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 32000, (n,), generator=rng).tolist()
               for n in HANDOFF_PROMPT_LENS]
    prompts.append(prompts[0][:256] + prompts[1])

    def engine(**kw):
        return ContinuousBatcher(srv, max_batch=4, segment_tokens=16,
                                 kv_mode="paged", **kw)

    def serve(eng):
        out = []
        for p in prompts:
            req = eng.submit_async(p, HANDOFF_BUDGET, logprobs=True)
            eng.wait(req, timeout=600)
            out.append((req.slot["tokens"], req.slot["logprobs"]))
        return out

    single = engine()
    try:
        want = serve(single)
    finally:
        single.close()
    prefill = engine(role="prefill")
    client = kv_handoff.HandoffClient(kv_handoff.InProcTransport(prefill),
                                      peer="inproc")
    decode = engine(role="decode", handoff_client=client)
    try:
        got = serve(decode)
        hops = len(client.latencies_s)
        leased = _leases_left(prefill)
    finally:
        decode.close()
        prefill.close()
    toks = [t for t, _ in got]
    if toks != [t for t, _ in want]:
        raise AssertionError(
            f"serve_handoff fp32: pair tokens differ from the single "
            f"engine's at {_first_diff(toks, [t for t, _ in want])}")
    lp_err = max(abs(a - b) for (_, g), (_, w) in zip(got, want)
                 for a, b in zip(g, w))
    if lp_err > HANDOFF_LP_TOL or hops != len(prompts) or leased:
        raise AssertionError(f"serve_handoff fp32: logprob error {lp_err} "
                             f"(tolerance {HANDOFF_LP_TOL}), {hops} hops "
                             f"for {len(prompts)} requests, {leased} "
                             f"leases left")
    del srv
    torch.cuda.empty_cache()
    return {"prompt_lens": [len(p) for p in prompts],
            "budget": HANDOFF_BUDGET, "identical_tokens": True,
            "max_logprob_err": lp_err, "lp_tol": HANDOFF_LP_TOL,
            "hops": hops}


def _leases_left(prefill, timeout: float = 10.0) -> int:
    """The prefill replica's pending leases once its engine has reaped
    the acked ones (it does so on its next tick)."""
    deadline = time.monotonic() + timeout
    while prefill.leases.pending() and time.monotonic() < deadline:
        time.sleep(0.05)
    return prefill.leases.pending()


def _charge_by_replica(servers: dict, counter):
    """Wrap each replica's ``_dispatch``: the ``counter`` launches made
    inside a replica's dispatches are charged to it, and its dispatches
    are counted by program family. The two replicas share one process
    and one card, so their dispatches take turns under one lock."""
    lock = threading.Lock()
    counts = {name: collections.Counter() for name in servers}
    for name, srv in servers.items():
        def dispatch(fn, cache, key, build, *args, _inner=srv._dispatch,
                     _count=counts[name]):
            with lock:
                before = counter.launches
                out = _inner(fn, cache, key, build, *args)
                _count["launches"] += counter.launches - before
                _count[fn] += 1
            return out

        srv._dispatch = dispatch
    return counts


def _bf16_round_trip(srv) -> dict:
    """One bf16 page block on the card through ``export_pages``, bundle
    bytes and ``import_pages`` into another pool at other page ids:
    every layer's K and V pages bit-equal."""
    import torch

    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff

    pages, page_tokens = 24, 16
    src = srv.make_paged_pool(pages, page_tokens)
    gen = torch.Generator(device=srv.device).manual_seed(4)
    with torch.inference_mode():
        for p in src.k_pages + src.v_pages:
            p.copy_(torch.randn(p.shape, generator=gen, device=srv.device))
    ids, dst_ids = list(range(3, 14)), list(range(23, 12, -1))
    t0 = time.perf_counter()
    wire = kv_handoff.PageBlockBundle.from_pool_payload(
        srv.export_pages(src, ids), lease_id="round-trip", lease_s=30.0,
        window=list(range(len(ids) * page_tokens)), first_token=0,
        first_lp=0.0, budget=1, temp=0.0, topk=0, want_lp=False,
        slo="standard", page_tokens=page_tokens).to_bytes()
    dst = srv.import_pages(
        srv.make_paged_pool(pages, page_tokens), dst_ids,
        kv_handoff.PageBlockBundle.from_bytes(wire).to_pool_payload())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(src.k_pages + src.v_pages, dst.k_pages + dst.v_pages):
        if b.dtype != torch.bfloat16 or not torch.equal(
                a[ids].view(torch.int16), b[dst_ids].view(torch.int16)):
            raise AssertionError("serve_handoff: the bf16 page block "
                                 "changed across export/bytes/import")
    return {"pages": len(ids), "bundle_bytes": len(wire),
            "export_bytes_import_ms": ms, "bit_equal": True}


@contextlib.contextmanager
def _without_ml_dtypes():
    """``import ml_dtypes`` fails inside: the bundle wire must not need
    it (the port's stated packages do not include it)."""
    saved = sys.modules.pop("ml_dtypes", None)
    sys.modules["ml_dtypes"] = None
    try:
        yield
    finally:
        del sys.modules["ml_dtypes"]
        if saved is not None:
            sys.modules["ml_dtypes"] = saved


def phase_serve_handoff(counters, paged_tokens) -> dict:
    """The disaggregated roles on the card: fp32 exactness of a pair
    against the single engine (_handoff_exactness), then a ``--role
    prefill`` and a ``--role decode --handoff-peer`` daemon at their
    default (paged KV, bf16, --max-batch 4) carrying the serve_paged
    traffic over HTTP, all with ml_dtypes unimportable: every request
    exported and imported once, no fallback, no orphan, no lease left;
    B2 launched exactly layers x chunks in the prefill replica and layers
    x decode steps in the decode replica, B1 never; tokens/s, the share
    of its bf16 tokens that serve_paged's (``paged_tokens``) agree
    with, the hop's latency and bundle size, and one bf16 page block
    bit-equal through export, bytes and import."""
    import torch

    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff

    fp32 = _handoff_exactness()
    argv = ["--max-batch", "4"]
    with _without_ml_dtypes(), \
            _daemon(argv + ["--role", "prefill"], "serve_handoff_prefill") \
            as (pre_httpd, prefill, pre_startup_s):
        pre_port = pre_httpd.server_address[1]
        with _daemon(argv + ["--role", "decode", "--handoff-peer",
                             f"http://127.0.0.1:{pre_port}"],
                     "serve_handoff_decode") as (httpd, decode, startup_s):
            port = httpd.server_address[1]
            try:
                code = _post(pre_port, {"prompt": "hi", "max_tokens": 2})[0]
            except urllib.error.HTTPError as e:
                code = e.code
                e.close()
            if code != 503:
                raise AssertionError(f"serve_handoff: a completion on the "
                                     f"prefill replica gave {code}")
            client = decode.handoff_client
            charged = _charge_by_replica(
                {"prefill": prefill.server, "decode": decode.server},
                next(c for c in counters if c.name == "paged_attn"))
            _, before = _get(port, "/metrics")
            for c in counters:
                c.launches = 0
            hops0 = len(client.latencies_s)
            docs, completions, ttfts, wall = _paged_traffic(
                port, "serve_handoff", logprobs=True)
            launches = {c.name: c.launches for c in counters}
            by_replica = {k: dict(v) for k, v in charged.items()}
            hop_s = list(client.latencies_s)[hops0:]
            leased = _leases_left(prefill)
            _, after = _get(port, "/metrics")
            delta = _deltas(before, after)
            outcomes = {
                f"{role}_{outcome}": delta(
                    "tpu_serve_handoff_total",
                    f'role="{role}",outcome="{outcome}"')
                for role, outcome in (
                    ("prefill", "export"), ("decode", "ok"),
                    ("decode", "imported"), ("decode", "fallback"),
                    ("decode", "error"), ("decode", "import_error"))}
            orphans = delta("tpu_serve_handoff_orphans_total")
            n = len(PAGED_PROMPTS)
            if (outcomes["prefill_export"] != n
                    or outcomes["decode_imported"] != n
                    or outcomes["decode_ok"] != n
                    or outcomes["decode_fallback"] != 0
                    or orphans != 0 or leased != 0 or len(hop_s) != n):
                raise AssertionError(
                    f"serve_handoff: outcomes {outcomes}, orphans "
                    f"{orphans}, leases left {leased}, {len(hop_s)} hops "
                    f"for {n} requests")
            layers = decode.server.config.num_layers
            pre, dec = by_replica["prefill"], by_replica["decode"]
            chunks = pre.get("paged_prefill", 0)
            segments = dec.get("paged_segment", 0)
            want = {"prefill": layers * chunks,
                    "decode": layers * segments * decode.segment}
            if (pre.get("launches", 0) != want["prefill"]
                    or dec.get("launches", 0) != want["decode"]
                    or pre.get("paged_segment", 0)
                    or dec.get("paged_prefill", 0)
                    or launches["paged_attn"] != sum(want.values())
                    or launches["flash_fwd"] != 0 or not chunks
                    or not segments):
                raise AssertionError(
                    f"serve_handoff: launches {launches}, by replica "
                    f"{by_replica}; want paged_attn = {layers} x {chunks} "
                    f"chunks in the prefill replica + {layers} x "
                    f"{segments} segments x {decode.segment} steps in the "
                    f"decode replica, flash_fwd = 0")
            # one more hop, alone: its latency and the bundle's size
            ids = decode.server.encode_prompt(PAGED_PROMPTS[3])
            t0 = time.perf_counter()
            bundle = client.fetch({"tokens": ids,
                                   "max_new_tokens": SERVE_MAX_TOKENS})
            alone_ms = (time.perf_counter() - t0) * 1e3
            client.ack(bundle.lease_id)
            leaf = kv_handoff.to_tensor(bundle.arrays["layer0"]["k"])
            if bundle.num_layers != layers or leaf.dtype != torch.bfloat16 \
                    or not torch.isfinite(leaf).all():
                raise AssertionError(f"serve_handoff: bundle of "
                                     f"{bundle.num_layers} layers, "
                                     f"{leaf.dtype}")
            agreement = _agreement(_inproc_tokens(decode, logprobs=True),
                                   paged_tokens)
            round_trip = _bf16_round_trip(decode.server)
    return {
        "phase": "serve_handoff", "ok": True, "fp32": fp32,
        "startup_s": {"prefill": pre_startup_s, "decode": startup_s},
        "prompt_lens": [len(p) for p in PAGED_PROMPTS],
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "handoffs": outcomes, "orphans": orphans, "leases_left": leased,
        "hop_s": hop_s, "hop_alone_ms": alone_ms,
        "bundle": {"prompt_tokens": len(ids), "pages": bundle.num_pages,
                   "bytes": len(bundle.to_bytes()),
                   "page_bytes": _page_bytes(bundle), "dtype": "bfloat16"},
        "texts": [list(d["choices"][0]["text"]) for d in docs[1:]],
        "prefill_chunks": chunks, "decode_segments": segments,
        "segment_tokens": decode.segment, "launches": launches,
        "launches_by_replica": by_replica,
        "bf16_agreement_with_serve_paged": agreement,
        "bf16_round_trip": round_trip, "ml_dtypes": "unimportable",
        "drained": True,
    }


# The static batcher's daemon: --batching static, the reference's
# defaults for the window, a warmup at the traffic's 48 tokens.
STATIC_ARGV = ["--batching", "static", "--max-batch", "4",
               "--batch-window-ms", "8", "--warmup-tokens",
               str(SERVE_MAX_TOKENS)]
STATIC_LP_TOL = 1e-4


def _static_warmup_prefills(srv, max_batch: int, decode_tokens: int) -> int:
    """Prefill calls of LMServer.warmup (the reference's count): row
    buckets x length buckets, plus a greedy and a sampled complete_batch
    a row bucket when the budget is >= 1 (and complete_batch_spec with a
    draft)."""
    rows, row_buckets = 1, 1
    while rows < max_batch:
        rows *= 2
        row_buckets += 1
    lens, lb = [], srv._prefill_bucket(1)
    while lb not in lens:
        lens.append(lb)
        lb = srv._bucket(lb + 1, 128, srv.config.max_seq_len)
    batches = 0
    if min(decode_tokens, srv.config.max_seq_len - 1) >= 1:
        batches = 2 + (srv.spec_k is not None)
    return row_buckets * (len(lens) + batches)


def _static_tokens(srv, jobs, logprobs=False):
    """(tokens, logprobs) of ``jobs`` submitted at once to a fresh static
    Batcher over ``srv`` (4 rows, the daemon's 8 ms window), and the
    sizes of the batches it ran, in order (its flight records)."""
    from k8s_device_plugin_tpu_torch.models.serve_batch import Batcher

    b = Batcher(srv, max_batch=4, window_ms=8.0)
    try:
        reqs = [b.submit_async(p, n, logprobs=logprobs) for p, n in jobs]
        out = [(b.wait(r, timeout=600)[0], r.slot["logprobs"])
               for r in reqs]
    finally:
        b.close()
    return out, [r["rows"] for r in b.flight.snapshot()
                 if r["kind"] == "static_batch"]


# the float32 check's depth: the serving default's 8 layers cut to 4 for
# time (PERF.md has the 8-layer run); the daemon serves the default itself
STATIC_LAYERS = 4


def _static_exactness() -> dict:
    """float32 at full width (default_config, STATIC_LAYERS layers,
    seed-0 weights): the static
    Batcher's tokens for SERVE_PROMPTS equal complete_batch's over the
    same batches and the rows ContinuousBatcher's; logprobs within
    STATIC_LP_TOL of complete_batch's."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        LMServer,
        default_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    srv = LMServer(config=dataclasses.replace(
        default_config(), dtype=torch.float32, num_layers=STATIC_LAYERS),
        device="cuda")
    jobs = [(srv.encode_prompt(p), SERVE_MAX_TOKENS) for p in SERVE_PROMPTS]
    got, calls = _static_tokens(srv, jobs, logprobs=True)
    want_toks, want_lps, start = [], [], 0
    for n in calls:
        group = jobs[start:start + n]
        toks, lps, _ = srv.complete_batch(
            [p for p, _ in group], [b for _, b in group],
            return_logprobs=True)
        want_toks += toks
        want_lps += lps
        start += n
    rows = _batcher_tokens(srv, jobs, "rows")
    toks = [t for t, _ in got]
    if toks != want_toks or toks != rows:
        raise AssertionError(
            f"serve_static fp32: Batcher tokens differ from complete_batch "
            f"at {_first_diff(toks, want_toks)}, from the rows batcher at "
            f"{_first_diff(toks, rows)}")
    err = max(abs(a - b) for (_, g), w in zip(got, want_lps)
              for a, b in zip(g, w))
    if err > STATIC_LP_TOL or [len(g) for _, g in got] != [
            len(t) - len(p) for t, (p, _) in zip(toks, jobs)]:
        raise AssertionError(f"serve_static fp32: logprobs differ by {err}")
    del srv
    torch.cuda.empty_cache()
    return {"prompt_lens": list(SERVE_PROMPT_LENS),
            "budget": SERVE_MAX_TOKENS, "batches": calls,
            "identical_tokens": True, "rows_batcher_identical": True,
            "max_logprob_err": err, "lp_tol": STATIC_LP_TOL}


def _static_daemon(argv, what, counters, traffic, prompts):
    """A --batching static daemon: B1's launches during its warmup
    (by the reference's formula) and during ``traffic(port)`` (one
    prefill a group: layers x groups), B2 never, and no program built
    for the first time during the traffic; then the in-process tokens of
    ``prompts`` (with logprobs). Returns what ``traffic`` returns and
    those counts."""
    for c in counters:
        c.launches = 0
    with _daemon(argv, what) as (httpd, batcher, startup_s):
        port = httpd.server_address[1]
        srv = batcher.server
        warm = {c.name: c.launches for c in counters}
        layers = srv.config.num_layers
        prefills = _static_warmup_prefills(srv, batcher.max_batch,
                                           SERVE_MAX_TOKENS)
        if warm["flash_fwd"] != layers * prefills or warm["paged_attn"]:
            raise AssertionError(
                f"{what}: warmup launches {warm}; want flash_fwd = "
                f"{layers} layers x {prefills} prefills")
        _, before = _get(port, "/metrics")
        for c in counters:
            c.launches = 0
        out = traffic(port)
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")
        delta = _deltas(before, after)
        groups = delta("tpu_serve_ttft_seconds_count", 'path="static"')
        compiles = delta("tpu_serve_jit_compiles_total")
        code, health = _get(port, "/healthz")
        if code != 200 or json.loads(health).get("status") != "ok":
            raise AssertionError(f"{what}: /healthz {code} {health}")
        if groups < 1 or launches["flash_fwd"] != layers * groups \
                or launches["paged_attn"]:
            raise AssertionError(
                f"{what}: launches {launches} for {groups} static groups; "
                f"want flash_fwd = {layers} x {groups}, paged_attn = 0")
        if compiles != 0:
            raise AssertionError(f"{what}: {compiles} programs built during "
                                 f"the traffic (warmup missed them)")
        tokens = _inproc_tokens(batcher, prompts, logprobs=True)
        # where a group's time goes: the traffic's first four prompts in
        # one complete_batch (one prefill, one 47-step decode loop)
        ids = [srv.encode_prompt(p) for p in prompts[:4]]
        group = _profiled(srv, lambda: srv.complete_batch(
            ids, [SERVE_MAX_TOKENS] * len(ids)))
    return {**out, "startup_s": startup_s,
            "aggregate_tokens_per_s": sum(out["completion_tokens"])
            / out["wall_s"],
            "warmup_prefills": prefills, "launches_warmup": warm,
            "static_groups": groups, "new_programs_in_traffic": compiles,
            "launches": launches, "profile_group": group,
            "drained": True}, tokens


def phase_serve_static(counters, serve_tokens) -> dict:
    """The static batcher on the card: fp32 exactness at full width
    (_static_exactness), then the daemon at the full-width default
    config, bf16, with STATIC_ARGV over the serve phase's traffic:
    startup (warmup included), TTFTs, aggregate tokens/s, the static
    groups, B1 launched layers x prefills during warmup and layers x
    groups during the traffic, no new program during the traffic, and
    the share of its bf16 tokens the serve phase's agree with."""
    fp32 = _static_exactness()

    def traffic(port):
        completions, ttfts, rates, wall = _serve_traffic(port,
                                                         "serve_static")
        return {"completion_tokens": completions, "ttft_s": ttfts,
                "decode_tokens_per_s": rates, "wall_s": wall}

    run, tokens = _static_daemon(STATIC_ARGV, "serve_static", counters,
                                 traffic, SERVE_PROMPTS)
    return {"phase": "serve_static", "ok": True, "fp32": fp32,
            "argv": STATIC_ARGV, "prompt_lens": list(SERVE_PROMPT_LENS),
            "max_tokens": SERVE_MAX_TOKENS, **run,
            "bf16_agreement_with_serve": _agreement(tokens, serve_tokens)}


# TinyLlama-1.1B-Chat-v1.0's published shape (its HF config.json as
# tools/convert_hf.py's llama_to_lm maps it): the configuration the
# repo's example converts (example/llm-serve/convert-job.yaml), its width
# whole, its depth cut from 22 layers to TINYLLAMA_LAYERS for time (the
# 22-layer run's numbers are in PERF.md). Random weights from seed
# 0; the byte tokenizer (no files).
TINYLLAMA_LAYERS = 4
# serve_checkpoint's depth, cut further for the script's time: its gated
# checks compare the loaded server with the in-memory one (the same
# arithmetic), and its daemons' launches count per layer.
CHECKPOINT_LAYERS = 2


def tinyllama_config(layers: int = TINYLLAMA_LAYERS):
    import torch

    from k8s_device_plugin_tpu_torch.models.transformer import LMConfig

    return LMConfig(
        vocab_size=32000, num_layers=layers, num_heads=32,
        num_kv_heads=4,
        embed_dim=2048, mlp_dim=5632, max_seq_len=2048, norm="rms",
        norm_eps=1e-5, position="rope", rope_theta=10000.0,
        mlp_act="swiglu", tie_embeddings=False, use_bias=False,
        eos_token_id=2, bos_token_id=1, dtype=torch.bfloat16)


def _importable(name: str) -> bool:
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def _checkpoint_exactness(ckpt: str, state) -> dict:
    """float32 at TinyLlama's full width: the server loaded from the
    directory decodes the in-memory server's (same weights) greedy
    tokens for PAGED_PROMPTS, logprobs bit-equal."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tinyllama_config(CHECKPOINT_LAYERS),
                              dtype=torch.float32)
    loaded = LMServer(config=cfg, checkpoint=ckpt, device="cuda")
    prompts = [loaded.encode_prompt(p) for p in PAGED_PROMPTS]
    budgets = [SERVE_MAX_TOKENS] * len(prompts)
    got = loaded.complete_batch(prompts, budgets, return_logprobs=True)
    del loaded
    memory = LMServer(config=cfg, params=state, device="cuda")
    want = memory.complete_batch(prompts, budgets, return_logprobs=True)
    del memory
    torch.cuda.empty_cache()
    err = max(abs(a - b) for g, w in zip(got[1], want[1])
              for a, b in zip(g, w))
    if got[0] != want[0] or got[1] != want[1]:
        raise AssertionError(
            f"serve_checkpoint fp32: loaded differs from in-memory at "
            f"{_first_diff(got[0], want[0])}, logprobs by {err}")
    return {"prompt_lens": [len(p) for p in prompts],
            "budget": SERVE_MAX_TOKENS,
            "completion_tokens": [len(t) - len(p)
                                  for t, p in zip(got[0], prompts)],
            "identical_tokens": True, "logprobs_bit_equal": True,
            "max_logprob_err": err}


def _paged_profile(srv) -> dict:
    """One 64-token paged prefill chunk and one 16-step paged decode
    segment over 4 rows at ~1000 tokens (pages of 16), as the profile
    phase runs them at the default width, on ``srv``."""
    import numpy as np

    rows, seg, page_tokens, width = 4, 16, 16, 64
    pool = srv.make_paged_pool(rows * width + 1, page_tokens)
    bt = np.arange(1, rows * width + 1, dtype=np.int64).reshape(rows, width)
    ones, zeros = np.ones(rows, np.int64), np.zeros(rows, np.int64)
    temp, gen = np.zeros(rows, np.float32), srv.generator(0)
    tok = np.ones((rows, 1), np.int64)

    def chunk():
        return srv.paged_prefill_chunk(pool, np.ones((rows, 64), np.int64),
                                       bt, 960 * ones, 63 * ones, gen, temp,
                                       zeros)

    def decode():
        return srv.paged_decode_segment(pool, bt, tok, 1000 * ones, gen,
                                        temp, zeros, seg)

    chunk()
    decode()
    out = {"rows": rows, "segment": seg,
           "paged_prefill_chunk": _profiled(srv, chunk),
           "paged_decode_segment": _profiled(srv, decode)}
    del pool
    return out


def phase_serve_checkpoint(counters) -> dict:
    """Serving from a checkpoint directory at TinyLlama's full width:
    random weights from seed 0 written by save_checkpoint (float32), the
    write's and LMServer(checkpoint=)'s seconds, the loaded server equal
    to the in-memory one in float32 (_checkpoint_exactness); then two
    daemons from the one directory over serve_paged's traffic: the
    default (paged KV: B2 launched layers x (chunks + decode steps), B1
    never) and --batching static (B1 layers x groups, B2 never); tokens/s,
    TTFTs and the bf16 agreement between the two. The directory is
    removed afterwards."""
    import shutil
    import tempfile

    import torch

    from k8s_device_plugin_tpu_torch.models import params as tparams
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer

    cfg = tinyllama_config(CHECKPOINT_LAYERS)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(HERE, "build"))
    try:
        with torch.device("cuda"):
            model = transformer.DecoderLM(cfg, param_dtype=torch.float32)
        state = transformer.init_params(model, seed=0).state_dict()
        n_params = sum(v.numel() for v in state.values())
        t0 = time.perf_counter()
        path = tparams.save_checkpoint(ckpt, cfg, state)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        srv = LMServer(checkpoint=ckpt, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if srv.config != cfg or srv.eos_id != 2:
            raise AssertionError(f"serve_checkpoint: loaded config "
                                 f"{srv.config}, eos {srv.eos_id}")
        profile = _paged_profile(srv)
        del srv, model
        fp32 = _checkpoint_exactness(ckpt, state)
        del state
        torch.cuda.empty_cache()
        layers = cfg.num_layers
        for c in counters:
            c.launches = 0
        with _daemon(["--checkpoint", ckpt, "--max-batch", "4"],
                     "serve_checkpoint") as (httpd, batcher, startup_s):
            port = httpd.server_address[1]
            if batcher.kv_mode != "paged" or batcher.server.config != cfg:
                raise AssertionError("serve_checkpoint: the default daemon "
                                     "is not paged at the checkpoint's "
                                     "config")
            _, before = _get(port, "/metrics")
            for c in counters:
                c.launches = 0
            _, completions, ttfts, wall = _paged_traffic(
                port, "serve_checkpoint", logprobs=True)
            launches = {c.name: c.launches for c in counters}
            _, after = _get(port, "/metrics")
            delta = _deltas(before, after)
            chunks = delta("tpu_serve_phase_seconds_count",
                           'fn="paged_prefill"')
            segments = delta("tpu_serve_phase_seconds_count",
                             'fn="paged_segment"')
            steps = segments * batcher.segment
            want = layers * (chunks + steps)
            if launches["paged_attn"] != want or launches["flash_fwd"]:
                raise AssertionError(
                    f"serve_checkpoint paged: launches {launches}; want "
                    f"paged_attn = {layers} x ({chunks} chunks + {steps} "
                    f"decode steps) = {want}, flash_fwd = 0")
            paged_tokens = _inproc_tokens(batcher, logprobs=True)
            paged = {"startup_s": startup_s,
                     "completion_tokens": completions, "ttft_s": ttfts,
                     "wall_s": wall,
                     "aggregate_tokens_per_s": sum(completions) / wall,
                     "prefill_chunks": chunks, "decode_segments": segments,
                     "decode_steps": steps, "launches": launches,
                     "drained": True}
        def traffic(port):
            _, completions, ttfts, wall = _paged_traffic(
                port, "serve_checkpoint static", logprobs=True)
            return {"completion_tokens": completions, "ttft_s": ttfts,
                    "wall_s": wall}

        static, static_tokens = _static_daemon(
            ["--checkpoint", ckpt, *STATIC_ARGV], "serve_checkpoint static",
            counters, traffic, PAGED_PROMPTS)
        agreement = _agreement(static_tokens, paged_tokens)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {
        "phase": "serve_checkpoint", "ok": True,
        "config": cfg.to_json_dict(), "params": n_params,
        "checkpoint_bytes": nbytes, "write_s": write_s, "load_s": load_s,
        "regex_importable": _importable("regex"),
        "tokenizers_importable": _importable("tokenizers"),
        "fp32": fp32, "paged": paged, "static": static,
        "bf16_agreement_static_vs_paged": agreement, "profile": profile,
        "removed": not os.path.exists(ckpt),
    }


# ---------------------------------------------------------------------------
# compile_cache: the persistent kernel cache across daemon restarts
# ---------------------------------------------------------------------------

# Single requests one after another (the batch composition is then the
# same in every run, so bf16 tokens can be compared exactly): three of
# serve_paged's prompts, 24 tokens each, with logprobs.
CACHE_PROMPTS = PAGED_PROMPTS[:3]
CACHE_MAX_TOKENS = 24


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _process_daemon(cache_dir: str, what: str, env_extra=None):
    """``python -m k8s_device_plugin_tpu_torch.models.serve`` in a process
    of its own at its default (paged KV, bf16, --max-batch 4) with
    ``--compile-cache-dir cache_dir``; serves CACHE_PROMPTS one after
    another, reads /metrics, then SIGTERMs it and fails unless it exits
    0. Returns (seconds from spawn to /healthz 200, each request's
    (text, token strings, token logprobs), TTFTs, /metrics)."""
    import signal

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=HERE, **(env_extra or {}))
    log_path = os.path.join(HERE, "build", f"compile_cache_{what}.log")
    with open(log_path, "w") as log_f:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.serve",
             "--port", str(port), "--max-batch", "4",
             "--compile-cache-dir", cache_dir],
            cwd=HERE, env=env, stdout=log_f, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"compile_cache {what}: daemon "
                                         f"exited {proc.returncode}")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"compile_cache {what}: not ready "
                                         f"in 300 s")
                try:
                    if _get(port, "/healthz")[0] == 200:
                        break
                except (urllib.error.URLError, ConnectionError, OSError):
                    time.sleep(0.2)
            startup_s = time.perf_counter() - t0
            answers, ttfts = [], []
            for prompt in CACHE_PROMPTS:
                status, raw, _ = _post(port, {
                    "prompt": prompt, "max_tokens": CACHE_MAX_TOKENS,
                    "logprobs": 1})
                doc = json.loads(raw)
                choice = doc["choices"][0]
                answers.append((choice["text"],
                                choice["logprobs"]["tokens"],
                                choice["logprobs"]["token_logprobs"]))
                ttfts.append(doc["ttft_seconds"])
            metrics = _get(port, "/metrics")[1]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        except BaseException:
            proc.kill()
            proc.wait(timeout=60)
            with open(log_path) as f:
                tail = f.read()[-3000:]
            print(f"compile_cache {what} log tail:\n{tail}", file=sys.stderr)
            raise
    if rc != 0:
        raise AssertionError(f"compile_cache {what}: daemon exited {rc} "
                             f"after SIGTERM (log {log_path})")
    return startup_s, answers, ttfts, metrics


def _cache_counts(metrics: str) -> dict:
    """The persistent cache's families, the nvcc runs and the load-phase
    dispatches of one daemon's /metrics."""
    out = {name: _metric_sum(metrics, f"tpu_serve_compile_cache_{name}_total")
           for name in ("hits", "misses", "writes", "evictions", "corrupt")}
    out["nvcc_runs"] = _metric_sum(metrics, "tpu_serve_kernel_builds_total")
    out["load_dispatches"] = _metric_labeled(
        metrics, "tpu_serve_phase_seconds_count", 'phase="load"')
    out["compile_dispatches"] = _metric_labeled(
        metrics, "tpu_serve_phase_seconds_count", 'phase="compile"')
    return out


def phase_compile_cache() -> dict:
    """The persistent kernel cache (--compile-cache-dir) across four
    daemon processes on one fresh directory: a cold start (nvcc builds
    every library it launches and writes it back: misses = writes = nvcc
    runs), a warm restart (no nvcc, every library opened from the cache,
    phase="load" dispatches, tokens identical to the cold run), a
    restart after truncating one entry (quarantined, counted corrupt,
    rebuilt once, tokens identical) and a restart with
    compile_cache.read=error armed (every read fails over to nvcc,
    tokens identical, no crash). Startup seconds and first TTFTs of
    each."""
    import glob
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="kcache_",
                                 dir=os.path.join(HERE, "build"))
    runs = {}
    try:
        def run(what, env_extra=None):
            startup_s, answers, ttfts, metrics = _process_daemon(
                cache_dir, what, env_extra)
            runs[what] = {"startup_s": startup_s, "first_ttft_s": ttfts[0],
                          "ttft_s": ttfts, **_cache_counts(metrics)}
            return answers

        def entries():
            return sorted(glob.glob(os.path.join(cache_dir, "*.culib")))

        cold = run("cold")
        c = runs["cold"]
        libs = entries()
        if not (c["nvcc_runs"] >= 1 and c["misses"] == c["writes"]
                == c["nvcc_runs"] == len(libs) and c["hits"] == 0):
            raise AssertionError(f"compile_cache cold: {c}, entries {libs}")
        if c["load_dispatches"] != 0:
            raise AssertionError(f"compile_cache cold: load dispatches {c}")
        warm = run("warm")
        w = runs["warm"]
        if not (w["nvcc_runs"] == 0 and w["hits"] == len(libs)
                and w["misses"] == 0 and w["writes"] == 0
                and w["load_dispatches"] >= 1):
            raise AssertionError(f"compile_cache warm: {w}")
        if warm != cold:
            raise AssertionError("compile_cache warm: tokens differ from "
                                 "the cold run")
        # a torn entry: quarantined, rebuilt once, served the same
        with open(libs[0], "rb") as f:
            head = f.read(4096)
        with open(libs[0], "wb") as f:
            f.write(head)
        corrupt = run("corrupt")
        k = runs["corrupt"]
        quarantined = glob.glob(os.path.join(cache_dir, "*.corrupt-*"))
        if not (k["corrupt"] == 1 and k["nvcc_runs"] == 1
                and k["writes"] == 1 and len(quarantined) == 1
                and k["hits"] == len(libs) - 1):
            raise AssertionError(f"compile_cache corrupt: {k}, "
                                 f"quarantined {quarantined}")
        if corrupt != cold:
            raise AssertionError("compile_cache corrupt: tokens differ")
        faulted = run("read_fault",
                      {"TPU_FAULT_PLAN": "compile_cache.read=error"})
        r = runs["read_fault"]
        if not (r["hits"] == 0 and r["nvcc_runs"] == len(libs)
                and r["misses"] == len(libs)):
            raise AssertionError(f"compile_cache read_fault: {r}")
        if faulted != cold:
            raise AssertionError("compile_cache read_fault: tokens differ")
        sizes = {os.path.basename(p): os.path.getsize(p) for p in entries()}
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    return {"phase": "compile_cache", "ok": True,
            "prompts": len(CACHE_PROMPTS), "max_tokens": CACHE_MAX_TOKENS,
            "entries": sizes, "runs": runs,
            "tokens_identical": True, "quarantined": 1}


# ---------------------------------------------------------------------------
# serve_moe: switch-MoE layers (--experts 8) on the card
# ---------------------------------------------------------------------------

MOE_EXPERTS = 8
MOE_TRAIN_STEPS = 3
MOE_TRAIN_BATCH = 8
# bf16 losses of the kernel and plain-attention steps from the same
# weights and tokens: relative difference (the kernels keep P and dS in
# bf16 where the plain backward keeps fp32, and steps 2-3 follow updates
# that differ by that rounding).
MOE_LOSS_RTOL = 2e-2


def _moe_exactness() -> dict:
    """float32 at the width --experts 8 selects (LMConfig(num_experts=8)):
    greedy tokens of the rows and paged ContinuousBatchers with the
    kernels (B1 prefills / B2 reads) equal those with plain attention."""
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import LMServer
    from k8s_device_plugin_tpu_torch.models.transformer import LMConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LMConfig(num_experts=MOE_EXPERTS),
                              dtype=torch.float32)
    srv = LMServer(config=cfg, device="cuda")
    rng = torch.Generator().manual_seed(4)
    jobs = [(torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist(),
             b) for n, b in zip(SPEC_PROMPT_LENS, SPEC_BUDGETS)]
    out = {}
    for kv in ("rows", "paged"):
        got = _batcher_tokens(srv, jobs, kv)
        with plain_attention():
            want = _batcher_tokens(srv, jobs, kv)
        if got != want:
            raise AssertionError(f"serve_moe fp32 {kv}: kernel and plain "
                                 f"tokens differ at {_first_diff(got, want)}")
        out[kv] = {"identical": True, "jobs": len(jobs)}
    del srv
    torch.cuda.empty_cache()
    return out


def _moe_train(counters) -> dict:
    """MOE_TRAIN_STEPS AdamW steps at the flagship width with
    num_experts=8 from seed-0 weights and seeded tokens, with the kernels
    and then with plain attention from the same start: finite losses
    within MOE_LOSS_RTOL, B1, B3 and B4 each launched once per layer per
    step on the kernel side. The batch halves only if the card runs out
    of memory (recorded)."""
    import dataclasses
    import math

    import torch

    from k8s_device_plugin_tpu_torch.models import transformer

    cfg = dataclasses.replace(transformer.flagship_config(),
                              num_experts=MOE_EXPERTS)
    batch = MOE_TRAIN_BATCH
    while True:
        try:
            step, init = transformer.make_train_step(cfg, "cuda")
            gen = torch.Generator().manual_seed(5)
            toks = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                                 generator=gen).cuda()

            def steps(plain):
                """Losses and each step's seconds (host clock to the
                loss's read, which waits for the step)."""
                model, opt = init(0)
                losses, secs = [], []
                with contextlib.ExitStack() as stack:
                    if plain:
                        stack.enter_context(plain_attention())
                    torch.cuda.synchronize()
                    for _ in range(MOE_TRAIN_STEPS):
                        t0 = time.perf_counter()
                        losses.append(step(model, opt, toks).item())
                        secs.append(time.perf_counter() - t0)
                peak = torch.cuda.max_memory_allocated() / 2**30
                del model, opt
                torch.cuda.empty_cache()
                return losses, secs, peak

            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            got, step_s, peak = steps(False)
            launches = _launches_per_step(counters, MOE_TRAIN_STEPS,
                                          cfg.num_layers, "moe steps")
            want, plain_step_s, _ = steps(True)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if batch == 1:
                raise
            batch //= 2
    flops = transformer.train_flops_per_step(cfg, batch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not all(math.isfinite(x) for x in got + want) or rel > MOE_LOSS_RTOL:
        raise AssertionError(f"serve_moe train: losses {got} vs plain "
                             f"{want} (rel {rel:.3g}, tol {MOE_LOSS_RTOL})")
    return {"config": f"flagship_config(), num_experts={MOE_EXPERTS}",
            "batch": batch, "steps": MOE_TRAIN_STEPS, "losses": got,
            "plain_losses": want, "max_rel_diff": rel, "rtol": MOE_LOSS_RTOL,
            "step_s": step_s, "plain_step_s": plain_step_s,
            "mfu_last_step": (flops / step_s[-1]
                              / transformer.H100_BF16_PEAK_FLOPS),
            "peak_gib": peak, "launches": launches, "flops_per_step": flops}


def phase_serve_moe(counters) -> dict:
    """Switch-MoE layers on one card. float32 exactness at LMConfig(
    num_experts=8)'s width (_moe_exactness); then the daemon with
    --experts 8 at its default (paged KV, bf16, --max-batch 4) over
    serve_paged's traffic: B2 launched exactly layers x (prefill chunks
    + decode steps), B1 never, aggregate tokens/s, and the share of its
    bf16 tokens the plain-attention path agrees with; then
    MOE_TRAIN_STEPS training steps at the flagship width with 8 experts
    (_moe_train)."""
    fp32 = _moe_exactness()
    argv = ["--experts", str(MOE_EXPERTS), "--max-batch", "4"]
    with _daemon(argv, "serve_moe") as (httpd, batcher, startup_s):
        port = httpd.server_address[1]
        cfg = batcher.server.config
        if batcher.kv_mode != "paged" or cfg.num_experts != MOE_EXPERTS:
            raise AssertionError(f"serve_moe: {batcher.kv_mode} KV, "
                                 f"{cfg.num_experts} experts")
        _, before = _get(port, "/metrics")
        for c in counters:
            c.launches = 0
        _, completions, ttfts, wall = _paged_traffic(port, "serve_moe",
                                                     logprobs=True)
        launches = {c.name: c.launches for c in counters}
        _, after = _get(port, "/metrics")
        delta = _deltas(before, after)
        chunks = delta("tpu_serve_phase_seconds_count", 'fn="paged_prefill"')
        segments = delta("tpu_serve_phase_seconds_count",
                         'fn="paged_segment"')
        code, health = _get(port, "/healthz")
        if code != 200 or json.loads(health).get("status") != "ok":
            raise AssertionError(f"serve_moe: /healthz {code} {health}")
        want = cfg.num_layers * (chunks + segments * batcher.segment)
        if launches["paged_attn"] != want or launches["flash_fwd"] != 0:
            raise AssertionError(
                f"serve_moe: launches {launches}; want paged_attn = "
                f"{cfg.num_layers} layers x ({chunks} chunks + {segments} "
                f"segments x {batcher.segment} steps) = {want}, "
                f"flash_fwd = 0")
        kernel_tokens = _inproc_tokens(batcher, logprobs=True)
        with plain_attention():
            plain_tokens = _inproc_tokens(batcher, logprobs=True)
        agreement = _agreement(kernel_tokens, plain_tokens)
    train = _moe_train(_train_counters())
    return {
        "phase": "serve_moe", "ok": True, "fp32": fp32,
        "config": f"LMConfig(num_experts={MOE_EXPERTS})",
        "layers": cfg.num_layers, "embed_dim": cfg.embed_dim,
        "mlp_dim": cfg.mlp_dim, "experts": cfg.num_experts,
        "startup_s": startup_s,
        "prompt_lens": [len(p) for p in PAGED_PROMPTS],
        "max_tokens": SERVE_MAX_TOKENS, "completion_tokens": completions,
        "wall_s": wall, "ttft_s": ttfts,
        "aggregate_tokens_per_s": sum(completions) / wall,
        "prefill_chunks": chunks, "decode_segments": segments,
        "segment_tokens": batcher.segment, "launches": launches,
        "bf16_agreement_with_plain": agreement, "drained": True,
        "train": train,
    }


def _stream_until_first(port: int, body: dict, first: threading.Event):
    """POST a streamed completion; sets ``first`` at its first data frame
    (its prompt's pages are then in the prefix index) and returns
    (status, the final JSON frame)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    frames = []
    with urllib.request.urlopen(req, timeout=300) as resp:
        for raw in resp:
            ln = raw.decode().strip()
            if ln.startswith("data: "):
                frames.append(ln[6:])
                first.set()
        status = resp.status
    if len(frames) < 2 or frames[-1] != "[DONE]":
        raise AssertionError("serve_paged: stream lacks [DONE]")
    return status, json.loads(frames[-2])


class _Records(logging.Handler):
    """Collects the messages of the log records it is handed."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _train_counters():
    from k8s_device_plugin_tpu_torch.ops import attention

    return (attention.FLASH_FWD, attention.FLASH_BWD_DQ,
            attention.FLASH_BWD_DKV)


def _launches_per_step(counters, steps, layers, what):
    """Each kernel's launches since its count was zeroed; fails unless
    each ran exactly once per layer per step."""
    launches = {c.name: c.launches for c in counters}
    if any(n != steps * layers for n in launches.values()):
        raise AssertionError(f"train: {what}: launches {launches}, want "
                             f"{layers} per step for {steps} steps")
    return launches


def phase_train() -> dict:
    """The trainer with a resume, the flagship benchmark, and float32
    gradients of a flagship-width step, kernels vs plain attention."""
    import dataclasses
    import math
    import re
    import shutil

    import torch

    from k8s_device_plugin_tpu_torch.models import train as trainer
    from k8s_device_plugin_tpu_torch.models import transformer

    counters = _train_counters()
    res = {"phase": "train"}

    # 1. models/train.main at the LMConfig() default: 6 steps with a
    #    checkpoint every 3, then a rerun to 8 that resumes after step 5.
    ckpt = os.path.join(HERE, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    handler = _Records()
    records = handler.lines
    logger = logging.getLogger("tpu-train")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    layers = transformer.LMConfig().num_layers
    runs = []
    try:
        for steps, ran in ((6, 6), (8, 2)):
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            rc = trainer.main(["--steps", str(steps), "--batch-size", "8",
                               "--checkpoint-dir", ckpt,
                               "--checkpoint-every", "3"])
            if rc != 0:
                raise AssertionError(f"train: trainer exited {rc}")
            runs.append({"steps": steps, "ran": ran,
                         "wall_s": time.perf_counter() - t0,
                         "launches": _launches_per_step(
                             counters, ran, layers, f"trainer to {steps}")})
    finally:
        logger.removeHandler(handler)
    if "resumed from checkpoint step 5" not in records:
        raise AssertionError(f"train: no resume line in {records}")
    losses = [float(m) for line in records
              for m in re.findall(r"(?:^step \d+ loss|final loss) (\S+)",
                                  line)]
    if len(losses) < 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    res["trainer"] = {"config": "LMConfig()", "batch": 8, "runs": runs,
                      "resumed_from": 5, "losses": losses,
                      "log": [m for m in records if "step" in m]}

    # 2. benchmark_train() at the flagship config.
    for c in counters:
        c.launches = 0
    bench = transformer.benchmark_train(steps=10, warmup=3)
    flagship = transformer.flagship_config()
    bench["launches"] = _launches_per_step(
        counters, 13, flagship.num_layers, "benchmark_train")
    bench["step_ms"] = 1e3 * bench["seconds"] / bench["steps"]
    bench["flops_per_step"] = transformer.train_flops_per_step(flagship, 8)
    if not bench["final_loss"] < bench["first_loss"]:
        raise AssertionError(f"train: loss did not fall: {bench}")
    res["benchmark"] = bench
    torch.cuda.empty_cache()

    # 3. float32 gradients of one flagship-width step (2 layers, batch 2),
    #    the kernels against plain attention.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(flagship, num_layers=2, dtype=torch.float32)
    model = transformer.DecoderLM(cfg, param_dtype=torch.float32).cuda()
    transformer.init_params(model, seed=0)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len),
                         generator=gen).cuda()

    def grads():
        model.zero_grad(set_to_none=True)
        loss = transformer.loss_fn(model, toks)
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    loss_k, got = grads()
    with plain_attention():
        loss_p, want = grads()
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(got, want))
    if rel > TRAIN_GRAD_TOL or abs(loss_k - loss_p) > 1e-4:
        raise AssertionError(f"train: fp32 grads kernel vs plain {rel:.3g} "
                             f"(tol {TRAIN_GRAD_TOL}), loss {loss_k} vs "
                             f"{loss_p}")
    res["fp32_grads"] = {"layers": 2, "batch": 2, "loss_kernel": loss_k,
                         "loss_plain": loss_p, "max_rel_err": rel,
                         "tol": TRAIN_GRAD_TOL}
    del model, got, want
    torch.cuda.empty_cache()
    res["ok"] = True
    return res


def phase_train_profile() -> dict:
    """torch.profiler over one flagship training step (bf16, batch 8):
    device busy time, idle share, the largest kernels, B1/B3/B4's
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.models import transformer

    cfg = transformer.flagship_config()
    step, init = transformer.make_train_step(cfg, "cuda")
    model, opt = init(0)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len),
                         generator=gen).cuda()
    step(model, opt, toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt, toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = sum(ms for _, ms, _ in events)
    share = {}
    for key, label in (("flash_fwd", "B1"), ("bwd_dq", "B3"),
                       ("bwd_dkv", "B4")):
        ms = sum(t for k, t, _ in events if key in k)
        share[label] = {"ms": ms, "calls": sum(n for k, _, n in events
                                               if key in k),
                        "share_of_busy": ms / busy if busy else None}
    del model, opt
    torch.cuda.empty_cache()
    return {
        "phase": "train_profile", "ok": True, "config": "flagship",
        "batch": 8, "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "kernels": len(events), "launches": sum(n for _, _, n in events),
        "attention": share,
        "top": [[k[:80], ms, n] for k, ms, n in events[:10]],
    }


# ---------------------------------------------------------------------------
# train_parallel: 4 ranks sharing the card over gloo
# ---------------------------------------------------------------------------

PARALLEL_WORLD = 4
# (name, [b, s, h, d]): the flagship training attention and the trainer
# default's head dim
PARALLEL_ATTN_SIZES = (("flagship", (2, 2048, 8, 128)),
                       ("trainer_d64", (2, 2048, 8, 64)))
PARALLEL_ATTN_KINDS = (("ring", True), ("ring", False), ("ulysses", True))
# Sharded attention against the one-device FlashAttention and the plain
# version, max |err| / max |ref| of out, lse, dq, dk, dv. float32: the
# ring's float32 merge and block sums against one pass. bfloat16: the
# kernels' own bf16 bars (TOL, BWD_TOL) cover the plain version; against
# the one-device kernels the ring rounds O once after its float32 merge
# and sums bf16 block gradients, a few bf16 ulps.
RING_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (name, axes, shape, sp_impl, experts): the step layouts
PARALLEL_STEPS = (
    ("sp4_ring", ("sp",), (4,), "ring", 0),
    ("sp4_ulysses", ("sp",), (4,), "ulysses", 0),
    ("dp2_tp2", ("dp", "tp"), (2, 2), "ring", 0),
    ("sp2_tp2_ring", ("sp", "tp"), (2, 2), "ring", 0),
    ("dp2_ep2_moe", ("dp", "ep"), (2, 2), "ring", 4),
)
PARALLEL_STEP_BATCH = 2
# The trainer's bf16 losses (logged to 4 decimals) against the one-device
# trainer's, absolute: a small share of one step's fall in the loss, so
# that a 4-rank run that never stepped its optimizer, or a resume that
# restored nothing, lies outside it (the controls of _trainer_controls).
TRAINER_BF16_TOL = 1e-3


def expected_launches(impl: str, causal: bool, sp_rank: int,
                      sp: int) -> int:
    """B1 (and each of B3, B4) launches of one attention call on the rank
    at ``sp_rank`` of an sp ring of ``sp``: r + 1 on a causal ring, sp on
    a non-causal one, one for Ulysses or without sp."""
    if impl == "ulysses" or sp == 1:
        return 1
    return sp_rank + 1 if causal else sp


def _check_rank_launches(what, ranks, want_fn):
    for rank, res in enumerate(ranks):
        want = want_fn(res)
        if any(n != want for n in res["launches"].values()):
            raise AssertionError(f"train_parallel: {what}: rank {rank} "
                                 f"launched {res['launches']}, want {want}")


def _launches_by_rank(ranks) -> dict:
    """{kernel: [its launches on rank 0, 1, ...]} from each kernel's own
    counter."""
    return {name: [r["launches"][name] for r in ranks]
            for name in ranks[0]["launches"]}


def _parallel_attention(launch, workers) -> dict:
    cases = []
    for size_name, size in PARALLEL_ATTN_SIZES:
        for dtype in ("bfloat16", "float32"):
            for impl, causal in PARALLEL_ATTN_KINDS:
                cases.append(dict(
                    name=f"{size_name}_{dtype}_{impl}_"
                         f"{'causal' if causal else 'full'}",
                    impl=impl, causal=causal, axes=("sp",),
                    shape=(PARALLEL_WORLD,), dtype=dtype, size=size,
                    seed=len(cases)))
    # workers.attention(cases, "cuda", compare=True) on every rank
    ranks = launch.spawn(workers.attention, PARALLEL_WORLD, cases, "cuda",
                         True, device="cuda", timeout=600)
    out = {}
    for case in cases:
        per_rank = [r[case["name"]] for r in ranks]
        _check_rank_launches(case["name"], per_rank, lambda r: expected_launches(
            case["impl"], case["causal"], r["sp_rank"], PARALLEL_WORLD))
        errors = per_rank[0]["errors"]
        tol = RING_TOL[case["dtype"]]
        worst = max(e["rel_err"] for against in errors.values()
                    for e in against.values())
        if not worst <= tol:
            raise AssertionError(f"train_parallel: {case['name']}: {errors} "
                                 f"(tol {tol})")
        out[case["name"]] = {
            "size": list(case["size"]), "tol": tol, "max_rel_err": worst,
            "errors": {a: {n: e["rel_err"] for n, e in v.items()}
                       for a, v in errors.items()},
            "launches_by_rank": _launches_by_rank(per_rank),
            "staged_bytes_by_rank": [r["staged_bytes"] for r in per_rank]}
    return {"cases": out,
            "ranks": [{"backend": r[cases[0]["name"]]["backend"],
                       "device": r[cases[0]["name"]]["device"]}
                      for r in ranks]}


def _parallel_steps(launch, workers) -> dict:
    import dataclasses

    from k8s_device_plugin_tpu_torch.models import transformer

    base = dataclasses.asdict(transformer.flagship_config())
    base.update(num_layers=2, dtype="float32")
    cases = [dict(name=name, axes=axes, shape=shape, sp_impl=impl,
                  config=dict(base, num_experts=experts), seed=5,
                  batch=PARALLEL_STEP_BATCH)
             for name, axes, shape, impl, experts in PARALLEL_STEPS]
    ranks = launch.spawn(workers.train_step, PARALLEL_WORLD, cases, "cuda",
                         True, device="cuda", timeout=600)
    out = {}
    for case, (_, axes, shape, impl, _) in zip(cases, PARALLEL_STEPS):
        per_rank = [r[case["name"]] for r in ranks]
        sp = dict(zip(axes, shape)).get("sp", 1)
        _check_rank_launches(case["name"], per_rank, lambda r: 2 * (
            expected_launches(impl, True, r["sp_rank"], sp)))
        one = per_rank[0]["one_device"]
        if not (one["grad_max_rel_err"] <= TRAIN_GRAD_TOL
                and one["loss_abs_err"] <= 1e-4):
            raise AssertionError(f"train_parallel: {case['name']}: {one} "
                                 f"(grad tol {TRAIN_GRAD_TOL}, loss 1e-4)")
        if len({r["loss"] for r in per_rank}) != 1:
            raise AssertionError(f"train_parallel: {case['name']}: ranks "
                                 f"logged different losses "
                                 f"{[r['loss'] for r in per_rank]}")
        out[case["name"]] = {
            "loss": per_rank[0]["loss"], "one_device_loss": one["loss"],
            "loss_abs_err": one["loss_abs_err"],
            "grad_max_rel_err": one["grad_max_rel_err"],
            "grad_worst": one["grad_worst"], "grad_tol": TRAIN_GRAD_TOL,
            "sharded_step_s": per_rank[0]["step_s"],
            "one_device_step_s": one["step_s"],
            "launches_by_rank": _launches_by_rank(per_rank),
            "staged_bytes_by_rank": [r["staged_bytes"] for r in per_rank]}
    return out


def _trainer_losses(text: str) -> dict:
    out = {int(s): float(v)
           for s, v in re.findall(r"step (\d+) loss (\S+)", text)}
    final = re.findall(r"final loss (\S+)", text)
    if final:
        out["final"] = float(final[-1])
    return out


def _trainer_in_process(argv: list) -> list:
    """models/train.main(argv) in this process; its log lines."""
    from k8s_device_plugin_tpu_torch.models import train as trainer

    handler = _Records()
    logger = logging.getLogger("tpu-train")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        if trainer.main(argv) != 0:
            raise AssertionError(f"train_parallel: trainer {argv} failed")
    finally:
        logger.removeHandler(handler)
    return handler.lines


def _parallel_trainer() -> dict:
    """The trainer's command at 4 ranks (torchrun), then one rank (this
    process) that resumes from its directory, against the one-device
    trainer."""
    import shutil

    ckpt = os.path.join(HERE, "build", "train_parallel_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": HERE, "OMP_NUM_THREADS": "1"}
    flags = ["--mesh-axes", "dp,sp,tp", "--checkpoint-dir", ckpt,
             "--checkpoint-every", "3"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(PARALLEL_WORLD), "-m",
         "k8s_device_plugin_tpu_torch.models.train", *flags, "--steps", "3"],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
    text = proc.stdout + proc.stderr
    with open(os.path.join(HERE, "build", "train_parallel_world4.log"),
              "w") as f:
        f.write(text)
    if proc.returncode != 0:
        raise AssertionError(f"train_parallel: the 4-rank trainer exited "
                             f"{proc.returncode}:\n{text[-4000:]}")
    world4 = {"wall_s": time.perf_counter() - t0,
              "losses": _trainer_losses(text),
              "log": [ln.split(" ", 3)[-1] for ln in text.splitlines()
                      if "tpu-train" in ln or "tpu-parallel" in ln]}
    t0 = time.perf_counter()
    lines = _trainer_in_process(flags + ["--steps", "5"])
    resume = {"wall_s": time.perf_counter() - t0,
              "losses": _trainer_losses("\n".join(lines)), "log": lines}
    if "resumed from checkpoint step 2" not in lines:
        raise AssertionError(f"train_parallel: no resume: {lines}")
    want3, want5 = (_trainer_losses("\n".join(_trainer_in_process(
        ["--steps", str(n)]))) for n in (3, 5))
    pairs = [("world4 step 0", world4["losses"].get(0), want3[0]),
             ("world4 final", world4["losses"].get("final"),
              want3["final"]),
             ("resumed final", resume["losses"].get("final"),
              want5["final"])]
    for what, got, want in pairs:
        if got is None or not abs(got - want) <= TRAINER_BF16_TOL:
            raise AssertionError(f"train_parallel: trainer {what} loss {got} "
                                 f"vs one device {want} (abs tol "
                                 f"{TRAINER_BF16_TOL})")
    controls = _trainer_controls(want3["final"], want5["final"])
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"config": "LMConfig()",
            "runs": {"world4": world4, "world1_resume": resume},
            "one_device": {"steps3": want3, "steps5": want5},
            "tol": TRAINER_BF16_TOL,
            "compared": [[w, g, x] for w, g, x in pairs],
            "controls": controls}


def _trainer_controls(final3: float, final5: float) -> dict:
    """The losses the trainer check would read at two faults, from the
    one-device trainer's init and batches: the step-2 loss at the
    initial weights (a 4-rank run whose optimizer never stepped) and
    the step-4 loss after steps 3 and 4 from the initial weights (a
    resume that restored nothing). Each must differ from the one-device
    trainer's by more than TRAINER_BF16_TOL, or the check could not see
    that fault."""
    import torch

    from k8s_device_plugin_tpu_torch.models import train as trainer
    from k8s_device_plugin_tpu_torch.models import transformer

    cfg = transformer.LMConfig()
    batch = trainer.build_arg_parser().parse_args([]).batch_size
    step, init = transformer.make_train_step(cfg, "cuda")
    model, opt = init(0)

    def tokens(s):
        return trainer.step_tokens(s, batch, cfg.max_seq_len,
                                   cfg.vocab_size).to("cuda")

    with torch.no_grad():
        no_step = float(transformer.loss_fn(model, tokens(2)))
    for s in (3, 4):
        fresh = float(step(model, opt, tokens(s)))
    out = {"no_optimizer_step": {"loss": no_step, "want": final3,
                                 "abs_diff": abs(no_step - final3)},
           "resume_restored_nothing": {"loss": fresh, "want": final5,
                                       "abs_diff": abs(fresh - final5)}}
    del model, opt
    torch.cuda.empty_cache()
    for what, c in out.items():
        if not c["abs_diff"] > TRAINER_BF16_TOL:
            raise AssertionError(f"train_parallel: the trainer tolerance "
                                 f"{TRAINER_BF16_TOL} cannot see {what}: "
                                 f"{c}")
    return out


def phase_train_parallel() -> dict:
    """Sharded training over 4 ranks sharing the card (gloo): ring and
    Ulysses attention, the sharded step in five layouts, the trainer's
    4-rank command and a one-rank resume."""
    from k8s_device_plugin_tpu_torch.ops import _build
    from k8s_device_plugin_tpu_torch.parallel import launch, workers

    t0 = time.perf_counter()
    for lib in ("flash_fwd", "flash_bwd"):
        _build.load(lib)  # built here, so the ranks only open them
    line = {"phase": "train_parallel", "ok": True, "world": PARALLEL_WORLD,
            "note": "gloo over one shared card: speeds are not results"}
    line["attention"] = _parallel_attention(launch, workers)
    line["steps"] = _parallel_steps(launch, workers)
    line["trainer"] = _parallel_trainer()
    line["seconds"] = time.perf_counter() - t0
    return line


# ---------------------------------------------------------------------------
# serve_tp: tensor-parallel serving over dp x tp ranks sharing the card
# ---------------------------------------------------------------------------

# (case, world, config, kv layout, dtype, prompts, together): the
# default serving model (serve_engine.default_config) and TinyLlama-1.1B's
# width, seed-0 weights. Exactness is gated in float32; the bf16 case
# records its agreement with one device. TinyLlama's case takes the first
# two prompts only: its 44 all-reduces a step through host memory cost
# ~0.1 s a token over gloo. ``together``: every job queued at once
# (workers.drive), so several rows decode in one call, which is gated; the
# last job still decodes alone. At 4 ranks only these run: one row's
# 240 steps there took 17-49 s a layout (gloo over 4 ranks on 8 cores).
SERVE_TP_CASES = (
    ("default_paged", 2, "default", "paged", "float32", 5, False),
    ("default_rows", 2, "default", "rows", "float32", 5, False),
    ("default_paged_together", 2, "default", "paged", "float32", 5, True),
    ("tinyllama_paged", 2, "tinyllama", "paged", "float32", 2, False),
    ("default_paged_bf16", 2, "default", "paged", "bfloat16", 5, False),
    ("default_paged_together", 4, "default", "paged", "float32", 5, True),
    ("default_rows_together", 4, "default", "rows", "float32", 5, True),
)
# The serving default's width with its 8 layers cut to SERVE_TP_LAYERS for
# time (PERF.md has the 8-layer numbers): the in-process cases, and the
# daemons from a checkpoint of that depth (_default_checkpoint).
SERVE_TP_LAYERS = 2
# (what, ranks, extra daemon flags): the daemon under torch.distributed.run;
# the warmup through gloo takes ~20 s a daemon, so only the first warms
# up (its startup is the one compared with serve_paged's)
SERVE_TP_DAEMONS = (("tp2_paged", 2, []),
                    ("tp2_rows", 2, ["--kv-cache", "rows", "--no-warmup"]),
                    ("dp2_tp2_paged", 4, ["--no-warmup"]))
SERVE_TP_GATED = ("flash_fwd", "paged_attn")


def _serve_tp_case(name, config, layout, dtype, n_prompts,
                   together) -> dict:
    import dataclasses

    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        default_config,
    )
    from k8s_device_plugin_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = (dataclasses.replace(default_config(), num_layers=SERVE_TP_LAYERS)
           if config == "default" else tinyllama_config())
    cfg = dataclasses.replace(cfg, dtype=getattr(__import__("torch"), dtype))
    prompts = (PAGED_PROMPTS if layout == "paged"
               else SERVE_PROMPTS)[:n_prompts]
    tok = ByteTokenizer()
    drive = dict(kind="batcher", kv_mode=layout, max_batch=4,
                 segment_tokens=16, together=together,
                 jobs=[(tok.encode(p), SERVE_MAX_TOKENS) for p in prompts])
    if layout == "paged":
        drive.update(page_tokens=16, prefill_chunk=64)
    return dict(name=name, config=cfg.to_json_dict(), drive=drive)


def _serve_tp_exactness(launch, workers) -> dict:
    """Each SERVE_TP_CASES case through ``workers.serve`` on the card:
    every rank's per-call results against rank 0's (the same bits), the
    tokens and each rank's B1/B2 launches against the one-device engine
    driven with the same jobs (the layout's kernel launched; a
    ``together`` case's several rows decoded in one call). Every case is
    checked before any failure raises, with every case's line in its
    message."""
    out, problems = {}, []
    # one spawn for every case: a case on fewer ranks leaves the rest
    # idle (workers.serve's build_submesh); dp x tp as mesh_from_env
    # factors the case's world
    spawned = max(c[1] for c in SERVE_TP_CASES)
    cases = [dict(_serve_tp_case(n, cfg, lay, dt, k, tog),
                  name=f"{n}_world{w}", shape=(w // 2, 2))
             for n, w, cfg, lay, dt, k, tog in SERVE_TP_CASES]
    t0 = time.perf_counter()
    ranks = launch.spawn(workers.serve, spawned, cases, "cuda", True,
                         device="cuda", timeout=600)
    out[f"spawn_s_world{spawned}"] = time.perf_counter() - t0
    for (name, world, cfg, lay, dt, _, tog), case in zip(
            SERVE_TP_CASES, cases):
        per_rank = [r[case["name"]] for r in ranks[:world]]
        r0, one = per_rank[0], per_rank[0]["one_device"]
        what = f"{name} at world {world}"
        if not r0["agreed"]:
            problems.append(f"{what}: the ranks were not in step")
        problems += [f"{what}: rank {r}'s per-call results differ from "
                     f"rank 0's" for r, res in enumerate(per_rank)
                     if res["results"] != r0["results"]]
        share = _agreement([t[len(p):] for t, (p, _) in
                            zip(r0["tokens"], case["drive"]["jobs"])],
                           [t[len(p):] for t, (p, _) in
                            zip(one["tokens"], case["drive"]["jobs"])])
        kernel = "paged_attn" if lay == "paged" else "flash_fwd"
        if dt == "float32":
            if r0["tokens"] != one["tokens"]:
                problems.append(f"{what}: tokens differ from one "
                                f"device's: {share}")
            if not one["launches"][kernel]:
                problems.append(f"{what}: {kernel} never launched")
            if tog and r0["rows_at_once"] < 2:
                problems.append(f"{what}: no call decoded several "
                                f"rows ({r0['rows_at_once']})")
            problems += [
                f"{what}: rank {r} launched {k} {res['launches'][k]} "
                f"times, one device {one['launches'][k]}"
                for r, res in enumerate(per_rank)
                for k in SERVE_TP_GATED
                if res["launches"][k] != one["launches"][k]]
        out[f"{name}_world{world}"] = {
            "mesh": r0["mesh"], "config": cfg, "kv_cache": lay,
            "dtype": dt, "calls": r0["calls"], "together": tog,
            "rows_at_once": r0["rows_at_once"],
            "tokens_equal_one_device": r0["tokens"] == one["tokens"],
            "agreement": share, "gated": dt == "float32",
            "launches_by_rank": [res["launches"] for res in per_rank],
            "launches_one_device": one["launches"],
            "drive_launches_rank0": r0["drive_launches"],
            "drive_s_rank0": r0["seconds"],
            "drive_s_one_device": one["seconds"],
            "reduced_bytes_by_rank": [res["reduced_bytes"]
                                      for res in per_rank]}
    if problems:
        raise AssertionError(f"serve_tp: {problems}\n{json.dumps(out)}")
    return out


def _tp_daemon(what: str, nproc: int, argv: list) -> dict:
    """The daemon under ``python -m torch.distributed.run --standalone
    --nproc-per-node nproc`` (bf16, --max-batch 4): serve_paged's traffic
    through rank 0's port, /healthz and /metrics from it, one listening
    rank, then SIGTERM to rank 0: every rank must exit 0. Startup (spawn
    to /healthz 200), TTFTs, aggregate tokens/s, and the bytes each rank
    all-reduced (its log)."""
    port = _free_port()
    t0 = time.perf_counter()
    proc, log_path = _launched_daemon(f"serve_tp_{what}", nproc, argv, port)
    try:
        startup_s = _await_ready(proc, port, f"serve_tp {what}", t0)
        _, completions, ttfts, wall = _paged_traffic(port, what, False)
        code, metrics = _get(port, "/metrics")
        if code != 200 or "tpu_serve_ttft_seconds" not in metrics:
            raise AssertionError(f"serve_tp {what}: /metrics {code}")
        by_rank = _stop_launched(proc, log_path, f"serve_tp {what}", nproc,
                                 port)
    except BaseException:
        _kill_launched(proc, log_path)
        raise
    return {"ranks": nproc, "argv": argv, "startup_s": startup_s,
            "ttft_s": ttfts, "completion_tokens": completions,
            "wall_s": wall,
            "aggregate_tokens_per_s": sum(completions) / wall,
            "reduced_bytes_by_rank": [by_rank[r]["reduced_bytes"]
                                      for r in range(nproc)],
            "exit_code": 0}


def _default_checkpoint(layers: int) -> str:
    """A checkpoint directory under build/ of the serving default's
    width at ``layers`` layers (bf16 serving, seed-0 float32 weights):
    how the daemon serves that depth."""
    import dataclasses
    import tempfile

    import torch

    from k8s_device_plugin_tpu_torch.models import params as tparams
    from k8s_device_plugin_tpu_torch.models import transformer
    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        default_config,
    )

    cfg = dataclasses.replace(default_config(), num_layers=layers)
    ckpt = tempfile.mkdtemp(prefix="ckpt_tp_",
                            dir=os.path.join(HERE, "build"))
    with torch.device("cuda"):
        model = transformer.DecoderLM(cfg, param_dtype=torch.float32)
    tparams.save_checkpoint(ckpt, cfg, transformer.init_params(
        model, seed=0).state_dict())
    del model
    torch.cuda.empty_cache()
    return ckpt


def phase_serve_tp(serve_paged: dict) -> dict:
    """Tensor-parallel serving over ranks that share the card (gloo): the
    engine in both KV layouts at tp2 and dp2 x tp2 and TinyLlama's width
    at tp2, exact in float32 against one device, then the daemon under
    a launcher at 2 and 4 ranks, beside serve_paged's one-device
    figures."""
    from k8s_device_plugin_tpu_torch.ops import _build
    from k8s_device_plugin_tpu_torch.parallel import launch, workers

    t0 = time.perf_counter()
    for lib in ("flash_fwd", "paged_attn"):
        _build.load(lib)  # built here, so the ranks only open them
    line = {"phase": "serve_tp", "ok": True,
            "note": "ranks share one card over gloo (all-reduces through "
                    "host memory): speeds are not results"}
    line["exactness"] = _serve_tp_exactness(launch, workers)
    ckpt = _default_checkpoint(SERVE_TP_LAYERS)
    try:
        # The daemons run at once, for the script's time: their startups
        # and traffic share the host's cores and the card, so their
        # seconds and tokens/s are each other's too.
        with concurrent.futures.ThreadPoolExecutor(
                len(SERVE_TP_DAEMONS)) as pool:
            runs = [pool.submit(_tp_daemon, what, n,
                                ["--checkpoint", ckpt, *argv])
                    for what, n, argv in SERVE_TP_DAEMONS]
            line["daemons"] = {what: run.result() for (what, _, _), run
                               in zip(SERVE_TP_DAEMONS, runs)}
    finally:
        import shutil

        shutil.rmtree(ckpt, ignore_errors=True)
    line["one_device_serve_paged"] = {
        k: serve_paged[k] for k in ("startup_s", "ttft_s",
                                    "aggregate_tokens_per_s")
        if k in serve_paged}
    line["seconds"] = time.perf_counter() - t0
    return line


# ---------------------------------------------------------------------------
# serve_handoff_tp: the prefill/decode roles over dp x tp ranks
# ---------------------------------------------------------------------------

# (case, world, config, prefill mesh, decode mesh, prompts): float32,
# seed-0 weights, PAGED_PROMPTS one at a time, SERVE_MAX_TOKENS each. The
# three pairings at the serving default's width (HANDOFF_TP_LAYERS
# layers, and the first three prompts, for time); GQA at TinyLlama's width
# (TINYLLAMA_LAYERS layers; 4 kv heads over 2 ranks: split) and at the
# serving default with 2 kv heads at tp4 (16 q over 2 kv heads: each
# rank's 4 q heads read one kv head, shared with the next rank).
HANDOFF_TP_CASES = (
    ("tp2_to_tp2", 2, "default", (1, 2), (1, 2), 3),
    ("tp2_to_one", 2, "default", (1, 2), (1, 1), 3),
    ("tinyllama_tp2_to_tp2", 2, "tinyllama", (1, 2), (1, 2), 2),
    ("one_to_dp2_tp2", 4, "default", (1, 1), (2, 2), 3),
    ("kv2_tp4_to_tp4", 4, "default_kv2", (1, 4), (1, 4), 2),
)
# Not SERVE_TP_LAYERS: at 2 layers the one-device float32 logits of
# kv2_tp4_to_tp4's first prompt tie within 4.8e-7 at its second token,
# so a tp sum's rounding picks the other token (PERF.md §6 PR 21).
HANDOFF_TP_LAYERS = 4


def _handoff_tp_case(name, config, prefill, decode, n_prompts) -> dict:
    import dataclasses

    import torch

    from k8s_device_plugin_tpu_torch.models.serve_engine import (
        default_config,
    )
    from k8s_device_plugin_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = tinyllama_config() if config == "tinyllama" else \
        dataclasses.replace(default_config(), num_layers=HANDOFF_TP_LAYERS)
    if config == "default_kv2":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    tok = ByteTokenizer()
    drive = dict(jobs=[(tok.encode(p), SERVE_MAX_TOKENS)
                       for p in PAGED_PROMPTS[:n_prompts]],
                 max_batch=4, segment_tokens=16, page_tokens=16,
                 prefill_chunk=64, warmup=False)
    return dict(name=name, config=cfg.to_json_dict(), prefill=prefill,
                decode=decode, drive=drive)


def _handoff_tp_exactness(launch, workers) -> dict:
    """Each HANDOFF_TP_CASES pair through ``workers.handoff`` on the card:
    the decode side's tokens against the one-device single engine's and a
    one-device pair's, every request handed off, every rank in step, a
    seeded page block through each replica's import and export bit for
    bit, the pair's bundles as many page bytes as one device's (pages
    within workers.BUNDLE_TOL), and each rank's B2 launches equal to the
    one-device pair's launches of the replicas it serves."""
    out, problems = {}, []
    # one spawn for every case: a case on fewer ranks leaves the rest
    # idle (workers.handoff's build_submesh)
    spawned = max(c[1] for c in HANDOFF_TP_CASES)
    cases = [_handoff_tp_case(n, cfg, p, d, k)
             for n, _, cfg, p, d, k in HANDOFF_TP_CASES]
    t0 = time.perf_counter()
    ranks = launch.spawn(workers.handoff, spawned, cases, "cuda", True,
                         device="cuda", timeout=600)
    out[f"spawn_s_world{spawned}"] = time.perf_counter() - t0
    for (name, world, cfg, pre, dec, k), case in zip(HANDOFF_TP_CASES,
                                                    cases):
        per_rank = [r[name] for r in ranks[:world]]
        r0 = per_rank[0]
        one = r0["one_device"]
        what = f"{name} at world {world}"
        n = len(case["drive"]["jobs"])
        if r0["tokens"] != one["tokens"] or \
                one["pair_tokens"] != one["tokens"]:
            diff = _first_diff(r0["tokens"], one["tokens"])
            problems.append(f"{what}: tokens differ from one device's "
                            f"at {diff}")
        if r0["hops"] != n or r0["leases_left"]:
            problems.append(f"{what}: {r0['hops']} hops for {n} "
                            f"requests, {r0['leases_left']} leases left")
        if not all(r["agreed"] for r in per_rank):
            problems.append(f"{what}: the ranks were not in step")
        if r0["round_trip"] != {"prefill": True, "decode": True}:
            problems.append(f"{what}: page round trip {r0['round_trip']}")
        if r0["page_bytes"] != one["page_bytes"] or \
                r0["bundle_ratio"] > 1.0:
            problems.append(f"{what}: bundle page bytes "
                            f"{r0['page_bytes']} vs {one['page_bytes']}, "
                            f"max page error {r0['bundle_max_err']}")
        want = [sum(one["launches_by_replica"][role]
                    for role in ("prefill", "decode")
                    if r == 0 or role in res["calls"])
                for r, res in enumerate(per_rank)]
        got = [res["launches"] for res in per_rank]
        if got != want or not min(want):
            problems.append(f"{what}: B2 launches by rank {got}, one "
                            f"device's replicas give {want}")
        out[name] = {
            "world": world, "meshes": r0["meshes"], "config": cfg,
            "prompts": n, "tokens_equal_one_device": True,
            "hops": r0["hops"], "calls": r0["calls"],
            "kv_layout_by_rank": [res["kv_layout"] for res in per_rank],
            "bundle_bytes": r0["bundle_bytes"],
            "page_bytes": r0["page_bytes"],
            "one_device_bundle_bytes": one["bundle_bytes"],
            "bundle_max_err": r0["bundle_max_err"],
            "launches_by_rank": got, "launches_want": want,
            "launches_by_replica_rank0": r0["launches_by_replica"],
            "launches_by_replica_one_device": one["launches_by_replica"],
            "seconds_rank0": r0["seconds"]}
    if problems:
        raise AssertionError(f"serve_handoff_tp: {problems}\n"
                             f"{json.dumps(out)}")
    return out


def _page_bytes(bundle) -> int:
    """The bytes of a bundle's K/V pages (its header aside)."""
    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff

    pages = [kv_handoff.to_tensor(a)
             for layer in bundle.to_pool_payload().values()
             for a in layer["attn"].values()]
    return sum(t.numel() * t.element_size() for t in pages)


def _launched_daemon(what, nproc, argv, port):
    """The daemon under ``torch.distributed.run`` on ``port``, its log
    in build/<what>.log: (process, log path)."""
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1")
    log_path = os.path.join(HERE, "build", f"{what}.log")
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), "-m",
             "k8s_device_plugin_tpu_torch.models.serve", "--port",
             str(port), "--max-batch", "4", *argv],
            cwd=HERE, env=env, stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True)
    return proc, log_path


def _await_ready(proc, port, what, t0, timeout=300.0) -> float:
    """Seconds from ``t0`` to the daemon's /healthz 200."""
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"{what}: daemon exited {proc.returncode}")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not ready in {timeout} s")
        try:
            if _get(port, "/healthz")[0] == 200:
                return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.2)


def _stop_launched(proc, log_path, what, nproc, port) -> dict:
    """SIGTERM to rank 0; every rank must exit 0 in step, rank 0 the only
    one listening (on ``port``). Returns ``{rank: {"reduced_bytes",
    "launches"}}`` from the stop lines of the log."""
    import signal

    with open(log_path) as f:
        text = f.read()
    pid = int(re.search(r"serves \(pid (\d+)\)", text).group(1))
    os.kill(pid, signal.SIGTERM)
    rc = proc.wait(timeout=180)
    with open(log_path) as f:
        text = f.read()
    listening = re.findall(r"llm-serve listening on :(\d+)", text)
    stops = [("0", *m) for m in re.findall(
        r"every one in step \(rank 0: (\d+) bytes all-reduced in \d+ "
        r"all-reduces\); kernel launches (\{.*?\})", text)]
    stops += re.findall(r"rank (\d+) stopped after \d+ calls \((\d+) "
                        r"bytes all-reduced in \d+ all-reduces\); kernel "
                        r"launches (\{.*?\})", text)
    by_rank = {int(r): {"reduced_bytes": int(b), "launches": json.loads(js)}
               for r, b, js in stops}
    if rc != 0 or listening != [str(port)] or \
            sorted(by_rank) != list(range(nproc)):
        raise AssertionError(f"{what}: rc {rc}, listening {listening}, "
                             f"ranks stopped in step {sorted(by_rank)} "
                             f"(log {log_path})")
    return by_rank


def _kill_launched(proc, log_path) -> None:
    """Kill a launched daemon's process group and show its log's tail."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    with open(log_path) as f:
        print(f"{log_path} tail:\n{f.read()[-4000:]}", file=sys.stderr)


def _handoff_tp_daemons(one_rank: dict) -> dict:
    """A ``--role prefill`` daemon at 2 ranks and a ``--role decode``
    daemon at 2 ranks fetching from it, both bf16 at the serving default
    under ``torch.distributed.run``, without warmup (for time): serve_paged's
    traffic through the decode daemon, every request handed off; one
    more hop alone from this process (its seconds, its bundle's page
    bytes, which must equal the one-rank pair's in serve_handoff); B2's
    launches by replica and rank (the ranks of a replica equal); the
    share of the decode daemon's texts the one-rank pair's agree with
    (reported)."""
    from k8s_device_plugin_tpu_torch.models import handoff as kv_handoff
    from k8s_device_plugin_tpu_torch.models.tokenizer import ByteTokenizer

    pre_port, dec_port = _free_port(), _free_port()
    peer = f"http://127.0.0.1:{pre_port}"
    t0 = time.perf_counter()
    procs = {
        "prefill": _launched_daemon("serve_handoff_tp_prefill", 2,
                                    ["--role", "prefill", "--no-warmup"],
                                    pre_port),
        "decode": _launched_daemon("serve_handoff_tp_decode", 2,
                                   ["--role", "decode", "--handoff-peer",
                                    peer, "--no-warmup"], dec_port)}
    try:
        startup = {"prefill": _await_ready(procs["prefill"][0], pre_port,
                                           "serve_handoff_tp prefill", t0),
                   "decode": _await_ready(procs["decode"][0], dec_port,
                                          "serve_handoff_tp decode", t0)}
        _, before = _get(dec_port, "/metrics")
        docs, completions, ttfts, wall = _paged_traffic(
            dec_port, "serve_handoff_tp", logprobs=True)
        _, after = _get(dec_port, "/metrics")
        delta = _deltas(before, after)
        imported = delta("tpu_serve_handoff_total",
                         'role="decode",outcome="imported"')
        fallback = delta("tpu_serve_handoff_total",
                         'role="decode",outcome="fallback"')
        client = kv_handoff.HandoffClient(kv_handoff.HTTPTransport(peer),
                                          peer=peer)
        ids = ByteTokenizer().encode(PAGED_PROMPTS[3])
        t1 = time.perf_counter()
        bundle = client.fetch({"tokens": ids,
                               "max_new_tokens": SERVE_MAX_TOKENS})
        hop_ms = (time.perf_counter() - t1) * 1e3
        client.ack(bundle.lease_id)
        page_bytes = _page_bytes(bundle)
        ports = {"prefill": pre_port, "decode": dec_port}
        launches = {role: {r: v["launches"] for r, v in _stop_launched(
            proc, log, f"serve_handoff_tp {role}", 2, ports[role]).items()}
            for role, (proc, log) in procs.items()}
    except BaseException:
        for proc, log in procs.values():
            _kill_launched(proc, log)
        raise
    n = len(PAGED_PROMPTS)
    b2 = {role: [v["paged_attn"] for v in by_rank.values()]
          for role, by_rank in launches.items()}
    if imported != n or fallback or page_bytes != one_rank["page_bytes"] \
            or any(len(set(v)) != 1 for v in b2.values()):
        raise AssertionError(
            f"serve_handoff_tp daemons: {imported} imported, {fallback} "
            f"fallbacks for {n} requests; bundle page bytes {page_bytes} "
            f"vs one rank's {one_rank['page_bytes']}; B2 by replica and "
            f"rank {b2}")
    texts = [list(d["choices"][0]["text"]) for d in docs[1:]]
    return {"ranks": {"prefill": 2, "decode": 2}, "startup_s": startup,
            "completion_tokens": completions, "ttft_s": ttfts,
            "wall_s": wall,
            "aggregate_tokens_per_s": sum(completions) / wall,
            "handed_off": imported, "hop_alone_ms": hop_ms,
            "bundle": {"prompt_tokens": len(ids), "pages": bundle.num_pages,
                       "bytes": len(bundle.to_bytes()),
                       "page_bytes": page_bytes,
                       "one_rank_page_bytes": one_rank["page_bytes"],
                       "one_rank_bytes": one_rank["bytes"]},
            "launches_by_replica_and_rank": launches,
            "text_agreement_with_one_rank_pair": _agreement(
                texts, one_rank["texts"]),
            "exit_codes": [0, 0]}


def phase_serve_handoff_tp(one_rank: dict) -> dict:
    """The prefill/decode roles over dp x tp ranks sharing the card
    (gloo): the pairings in float32 in process, then a bf16 daemon pair
    at 2 ranks each beside serve_handoff's one-rank pair (``one_rank``:
    its bundle and texts)."""
    from k8s_device_plugin_tpu_torch.ops import _build
    from k8s_device_plugin_tpu_torch.parallel import launch, workers

    t0 = time.perf_counter()
    for lib in ("flash_fwd", "paged_attn"):
        _build.load(lib)  # built here, so the ranks only open them
    line = {"phase": "serve_handoff_tp", "ok": True,
            "note": "ranks share one card over gloo: speeds are not results"}
    line["exactness"] = _handoff_tp_exactness(launch, workers)
    line["daemons"] = _handoff_tp_daemons(one_rank)
    line["seconds"] = time.perf_counter() - t0
    return line


# ---------------------------------------------------------------------------
# train_pp: pipeline-parallel LM training (the lm-train-pp and
# lm-train-pp-tp pods)
# ---------------------------------------------------------------------------

# lm-train-pp's width (transformer_pp.main: embed 1024, 8 heads, mlp
# 4096, seq 2048, vocab 32000) cut to 4 layers; lm-train-pp-tp's has 16
# heads. float32, batch 4, seed-0 weights and batch.
TRAIN_PP_LAYERS = 4
TRAIN_PP_BATCH = 4
# (layout, trainer, axes, shape, microbatches, chunks, fused): M = 4, or 2
# under dp (a microbatch of one row does not split over dp2)
TRAIN_PP_LAYOUTS = (
    ("pp4", "pp", ("pp",), (4,), 4, 1, False),
    ("pp2_chunks2", "pp", ("pp",), (2,), 4, 2, False),
    ("dp2_pp2", "pp", ("dp", "pp"), (2, 2), 2, 1, False),
    ("pp2_tp2", "tp", ("pp", "tp"), (2, 2), 4, 1, False),
    ("dp2_pp2_tp2_fused", "tp", ("dp", "pp", "tp"), (2, 2, 2), 2, 1, True),
)
# |fused - unfused| of the parameters after one step (the same gradients
# and AdamW update, applied in the drain or after it)
TRAIN_PP_FUSED_TOL = 1e-6
TRAIN_PP_PODS = (
    ("lm-train-pp", "transformer_pp", 4,
     ["--steps", "3", "--batch", "8", "--microbatches", "4"]),
    ("lm-train-pp-tp", "transformer_tp", 8,
     ["--steps", "3", "--batch", "8", "--microbatches", "4", "--dp", "2",
      "--tp", "2", "--chunks", "2", "--fuse-update"]),
)


def _train_pp_case(name, trainer, axes, shape, m, chunks, fused) -> dict:
    import torch

    from k8s_device_plugin_tpu_torch.models.transformer import LMConfig

    cfg = LMConfig(num_layers=TRAIN_PP_LAYERS, embed_dim=1024, mlp_dim=4096,
                   num_heads=16 if trainer == "tp" else 8,
                   max_seq_len=2048, dtype=torch.float32)
    return dict(name=name, trainer=trainer, axes=axes, shape=shape,
                config=cfg.to_json_dict(), microbatches=m, chunks=chunks,
                fused=fused, batch=TRAIN_PP_BATCH, seed=0)


def _train_pp_exactness(launch, workers) -> dict:
    """Each TRAIN_PP_LAYOUTS step through ``workers.pp_train`` on the
    card, every rank against one device's autograd of the whole model
    (transformer_pp.reference_loss): loss within workers.PP_LOSS_TOL and
    every gradient within workers.PP_GRAD_TOL (allclose), each rank's
    B1 launched 2·M·L/S times and B3, B4 M·L/S times; the fused layout's
    step equal to the unfused one's."""
    out, problems = {}, []
    # one spawn for every layout: a layout on fewer ranks leaves the rest
    # idle (workers.pp_train's build_submesh)
    world = max(int(math.prod(c[3])) for c in TRAIN_PP_LAYOUTS)
    cases = [_train_pp_case(*c) for c in TRAIN_PP_LAYOUTS]
    t0 = time.perf_counter()
    ranks = launch.spawn(workers.pp_train, world, cases, "cuda", True,
                         device="cuda", timeout=600)
    out[f"spawn_s_world{world}"] = time.perf_counter() - t0
    for (name, trainer, axes, shape, m, chunks, fused) in \
            TRAIN_PP_LAYOUTS:
        per_rank = [r[name] for r in ranks[:int(math.prod(shape))]]
        stages = dict(zip(axes, shape))["pp"]
        per_layer = TRAIN_PP_LAYERS // stages
        want = {"flash_fwd": 2 * m * per_layer,
                "flash_bwd_dq": m * per_layer,
                "flash_bwd_dkv": m * per_layer}
        for r, res in enumerate(per_rank):
            e = res["errors"]
            if e["loss_ratio"] > 1 or max(e["embed"], e["head"],
                                          e["blocks"]) > 1:
                problems.append(f"{name} rank {r}: {e}")
            if res["launches"] != want:
                problems.append(f"{name} rank {r}: launches "
                                f"{res['launches']}, want {want}")
            if fused and not res["fused_minus_unfused"] <= \
                    TRAIN_PP_FUSED_TOL:
                problems.append(f"{name} rank {r}: fused step differs "
                                f"by {res['fused_minus_unfused']}")
        out[name] = {
            "trainer": trainer, "mesh": dict(zip(axes, shape)),
            "microbatches": m, "chunks": chunks, "fused": fused,
            "loss": per_rank[0]["loss"],
            "one_device_loss": per_rank[0]["errors"]["loss"],
            "loss_abs_err": max(r["errors"]["loss_abs_err"]
                                for r in per_rank),
            "grad_allclose_ratio": max(
                max(r["errors"][k] for k in ("embed", "head", "blocks"))
                for r in per_rank),
            "fused_minus_unfused": [r.get("fused_minus_unfused")
                                    for r in per_rank] if fused else None,
            "launches_by_rank": [r["launches"] for r in per_rank],
            "launches_want": want,
            "step_s_by_rank": [r["seconds"] for r in per_rank]}
    if problems:
        raise AssertionError(f"train_pp: {problems}\n{json.dumps(out)}")
    return out


def _train_pp_pod(prog: str, module: str, nproc: int, argv: list) -> dict:
    """A pod's command under ``python -m torch.distributed.run`` at
    ``nproc`` ranks on the card (bf16, full width): the reference's
    lines on rank 0, a finite final loss below the first step's, and
    every rank holding the same embedding and head."""
    env = {**os.environ, "PYTHONPATH": HERE, "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m",
         f"k8s_device_plugin_tpu_torch.models.{module}", *argv],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    text = proc.stdout
    with open(os.path.join(HERE, "build", f"train_pp_{module}.log"),
              "w") as f:
        f.write(text + proc.stderr)
    mesh = re.search(rf"{prog}: mesh (\{{.*?\}}) config", text)
    first = re.search(rf"{prog}: first step loss=(\S+)", text)
    final = re.search(rf"{prog}: (\d+) steps wall=([\d.]+)s tokens/s=(\d+) "
                      rf"loss=([-\w.]+)", text)
    digests = re.findall(rf"{prog}: rank (\d+) embed\+head sha256="
                         rf"([0-9a-f]{{64}})", text)
    ok = (proc.returncode == 0 and mesh and first and final
          and math.isfinite(float(final.group(4)))
          and float(final.group(4)) < float(first.group(1))
          and len(digests) == nproc and len({d for _, d in digests}) == 1)
    if not ok:
        raise AssertionError(f"train_pp {prog}: rc {proc.returncode}:\n"
                             f"{text[-3000:]}\n{proc.stderr[-3000:]}")
    return {"argv": argv, "ranks": nproc, "mesh": mesh.group(1),
            "line": final.group(0), "steps": int(final.group(1)),
            "wall_s": float(final.group(2)),
            "tokens_per_s": int(final.group(3)),
            "first_loss": float(first.group(1)),
            "final_loss": float(final.group(4)),
            "replicated_digest": digests[0][1],
            "process_wall_s": wall}


def phase_train_pp() -> dict:
    """Pipeline-parallel LM training over ranks sharing the card (gloo):
    float32 exactness of the five layouts against one device, then the
    lm-train-pp and lm-train-pp-tp pods' commands at full width."""
    from k8s_device_plugin_tpu_torch.ops import _build
    from k8s_device_plugin_tpu_torch.parallel import launch, workers

    t0 = time.perf_counter()
    for lib in ("flash_fwd", "flash_bwd"):
        _build.load(lib)  # built here, so the ranks only open them
    line = {"phase": "train_pp", "ok": True,
            "note": "ranks share one card over gloo: speeds are not results"}
    line["exactness"] = _train_pp_exactness(launch, workers)
    # The two pods run at once, for the script's time (their walls and
    # tokens/s share the host and the card).
    with concurrent.futures.ThreadPoolExecutor(len(TRAIN_PP_PODS)) as pool:
        runs = [pool.submit(_train_pp_pod, *pod) for pod in TRAIN_PP_PODS]
        line["pods"] = {pod[0]: run.result()
                        for pod, run in zip(TRAIN_PP_PODS, runs)}
    line["seconds"] = time.perf_counter() - t0
    return line


# ---------------------------------------------------------------------------
# convnets: AlexNet, ResNet-50, MobileNetV2, InceptionV3
# ---------------------------------------------------------------------------

# (model, image size, batch) of the float32 card = CPU train step
CONV_EXACT = (("alexnet", 224, 4), ("resnet50", 224, 2),
              ("mobilenetv2", 224, 4), ("inceptionv3", 299, 2))
CONV_EXACT_TOL = 1e-4
# A tensor whose largest magnitude is below this compares against it: a
# BatchNorm bias whose gradient is zero in exact arithmetic (MobileNetV2's
# projection BatchNorm before a block without a residual feeds only the
# next BatchNorm's mean) holds rounding alone after a step (~2e-8).
CONV_EXACT_FLOOR = 1e-3
CONV_POD_ARGV = ["--steps", "100", "--batch-size", "128", "--json"]
CONV_POD_KEYS = ["backend", "batch_size", "steps", "seconds",
                 "images_per_second", "final_loss"]
# The published shapes timed through benchmark(): (model, batch, steps,
# where the shape is published).
# (model, batch, steps, source of the shape): the published batches; the
# steps cut from their sources' 60 / 50 to 20 for the script's time.
CONV_SHAPES = (
    ("alexnet", 1024, 20, "k8s_device_plugin_tpu/bench/hw.py:54-55"),
    ("resnet50", 256, 20, "example/pod/resnet-tpu.yaml:16-17"),
    ("resnet50", 32, 20, "example/pod/convnet-benchmarks-tpu.yaml:19-24"),
    ("mobilenetv2", 32, 20, "example/pod/convnet-benchmarks-tpu.yaml:19-24"),
    ("inceptionv3", 32, 20, "example/pod/convnet-benchmarks-tpu.yaml:19-24"),
)
CONV_FORWARD_BATCH = 16            # __graft_entry__.py:33
CONV_PROFILES = (("alexnet", 128), ("resnet50", 256))
# (label, batch, taps, stride, padding) of the stems timed both ways
CONV_STEMS = (("alexnet_11x11_s4", 128, 11, 4, 2),
              ("resnet_7x7_s2", 256, 7, 2, 3))


def _conv_model(name: str, dtype):
    """(a fresh seeded model on the CPU, its optimizer factory, its image
    size) as each benchmark() builds them."""
    from k8s_device_plugin_tpu_torch.models import (
        alexnet,
        inception,
        mobilenet,
        resnet,
    )

    if name == "alexnet":
        return (alexnet.init_params(0, dtype=dtype), alexnet.momentum_sgd,
                alexnet.IMAGE_SIZE)
    if name == "resnet50":
        model = resnet.init_variables(resnet.ResNet(dtype=dtype))
    elif name == "mobilenetv2":
        model = mobilenet.init_variables(mobilenet.MobileNetV2(dtype=dtype))
    else:
        return (inception.init_variables(inception.InceptionV3(dtype=dtype)),
                resnet.nesterov_sgd, inception.IMAGE_SIZE)
    return model, resnet.nesterov_sgd, resnet.IMAGE_SIZE


def _rel_err(got, want, floor: float = 0.0) -> float:
    """max |got - want| over max |want| (at least ``floor``; 0 where both
    are all zero)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(float(want.abs().max()), floor)
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions and matmuls in float32: cuDNN and cuBLAS use
    TF32 by default, which would compare TF32 with the CPU's float32."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _conv_exactness() -> dict:
    """One train step of each model at full width from one seeded init
    and batch, on the card against the CPU path in float64 (the code the
    CPU tests hold to the reference): in float64 on the card, the step's
    loss and train-mode logits and every parameter and running statistic
    after it within CONV_EXACT_TOL of the tensor's largest magnitude
    (floored at CONV_EXACT_FLOOR); in float32 on the card (TF32 off), the
    loss and logits within CONV_EXACT_TOL and each tensor's error
    recorded, beside the CPU's own float32 step. A float32 step cannot be
    held to 1e-4 tensor by tensor: at a fresh init these gradients are
    ill-conditioned (in float64 on the CPU, scaling InceptionV3's input
    by 1 + 1e-7 noise moves its first conv's gradient by 1.9%), so the
    CPU's own float32 step leaves 253 of InceptionV3's 472 tensors, 97
    of MobileNetV2's 262 and ResNet-50's stem kernel (2.7e-4) further
    than 1e-4 from the float64 one, while loss and logits stay within
    4e-5."""
    import copy

    import torch

    from k8s_device_plugin_tpu_torch.models import alexnet

    def step(model, optimizer, x, y):
        logits = []
        hook = model.register_forward_hook(
            lambda m, i, o: logits.append(o.detach()))
        try:
            loss = alexnet.make_train_step(
                model, optimizer(model.parameters()))(x, y)
        finally:
            hook.remove()
        return loss, logits[0], model.state_dict()

    def errors(got, want):
        tensors = {k: _rel_err(got[2][k], v, CONV_EXACT_FLOOR)
                   for k, v in want[2].items()}
        worst = max(tensors, key=tensors.get)
        return {"loss": _rel_err(got[0], want[0]),
                "logits": _rel_err(got[1], want[1]),
                "state_max": tensors[worst], "state_worst": worst,
                "tensors_over_tol": sum(e > CONV_EXACT_TOL
                                        for e in tensors.values())}

    out = {}
    with _no_tf32():
        for name, size, batch in CONV_EXACT:
            narrow, optimizer, _ = _conv_model(name, torch.float32)
            wide, _, _ = _conv_model(name, torch.float64)
            wide.to(torch.float64)
            x, y = alexnet.synthetic_batch(torch.Generator().manual_seed(0),
                                           batch, size)
            on_card = {
                dtype: step(copy.deepcopy(model).to("cuda", memory_format=fmt),
                            optimizer, x.to("cuda", dtype, memory_format=fmt),
                            y.cuda())
                # float64 in NCHW: cuDNN's double convolutions
                for dtype, model, fmt in (
                    (torch.float64, wide, torch.contiguous_format),
                    (torch.float32, narrow, torch.channels_last))}
            want = step(wide, optimizer, x.double(), y)
            row = {"image_size": size, "batch": batch,
                   "tensors": len(want[2]),
                   "card_fp64": errors(on_card[torch.float64], want),
                   "card_fp32": errors(on_card[torch.float32], want),
                   "cpu_fp32": errors(step(narrow, optimizer, x, y), want)}
            e64, e32 = row["card_fp64"], row["card_fp32"]
            if max(e64["loss"], e64["logits"], e64["state_max"],
                   e32["loss"], e32["logits"]) > CONV_EXACT_TOL \
                    or not math.isfinite(float(on_card[torch.float32][0])):
                raise AssertionError(f"convnets: {name} card != CPU: {row}")
            out[name] = row
            del narrow, wide, on_card, want
            torch.cuda.empty_cache()
    return out


def _conv_pod() -> dict:
    """The example pod's command (example/pod/alexnet-tpu.yaml:16-17) as
    a process: the wall from spawn to exit, the keys and numbers it
    prints, and a final loss below the first step's (the first step's
    loss: benchmark(128, 1 step, no warm-up) in this process, the same
    seeded init and batch). The pod stands for a fresh pod with the card
    to itself, so this process first hands back what its allocator keeps
    cached: with little memory free, cuDNN's autotuner in the pod picks
    other algorithms, and the pod's chaotic trajectory (one fixed batch
    of random labels) can end non-finite (ROADMAP C7)."""
    import gc

    import torch

    from k8s_device_plugin_tpu_torch.models import alexnet

    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.alexnet",
         *CONV_POD_ARGV], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"convnets: the pod command exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if list(result) != CONV_POD_KEYS or result["backend"] != "gpu":
        raise AssertionError(f"convnets: the pod printed {result}")
    first = alexnet.benchmark(128, steps=1, warmup=0)["final_loss"]
    if not (math.isfinite(result["final_loss"])
            and result["final_loss"] < first):
        raise AssertionError(f"convnets: the pod's loss did not fall: "
                             f"first {first}, final {result['final_loss']}")
    return {"argv": CONV_POD_ARGV, "process_wall_s": wall,
            "card_free_bytes_at_spawn": free, "first_loss": first, **result}


def _conv_shapes() -> list:
    """benchmark() at each published shape: img/s, seconds, final loss
    and the peak of torch.cuda.max_memory_allocated."""
    import gc

    import torch

    from k8s_device_plugin_tpu_torch.models import (
        alexnet,
        inception,
        mobilenet,
        resnet,
    )

    run = {"alexnet": alexnet.benchmark,
           "resnet50": lambda b, s: resnet.benchmark(b, s, depth=50),
           "mobilenetv2": mobilenet.benchmark,
           "inceptionv3": inception.benchmark}
    rows = []
    for name, batch, steps, source in CONV_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result = run[name](batch, steps)
        if not math.isfinite(result["final_loss"]):
            raise AssertionError(f"convnets: {name} b{batch}: {result}")
        rows.append({"model": name, "batch": batch, "steps": steps,
                     "source": source,
                     "images_per_second": result["images_per_second"],
                     "seconds": result["seconds"],
                     "final_loss": result["final_loss"],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    return rows


def _conv_forward() -> dict:
    """__graft_entry__'s flagship forward on the card: AlexNet inference
    at batch 16 x 224^2 (bf16, seeded init), timed by CUDA events."""
    import torch

    from k8s_device_plugin_tpu_torch.models import alexnet

    model = alexnet.init_params(0).to("cuda",
                                      memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images, _ = alexnet.synthetic_batch(gen, CONV_FORWARD_BATCH)
    torch.cuda.reset_peak_memory_stats()
    logits = alexnet.forward(model, images)
    if tuple(logits.shape) != (CONV_FORWARD_BATCH, alexnet.NUM_CLASSES) \
            or not bool(logits.isfinite().all()):
        raise AssertionError(f"convnets: forward gave {logits.shape}")
    ms = cuda_ms(lambda: alexnet.forward(model, images), iters=50)
    return {"batch": CONV_FORWARD_BATCH, "ms": ms,
            "images_per_second": CONV_FORWARD_BATCH / ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def conv_forward_flops(model, image_size: int) -> int:
    """FLOP of one image's forward from the layer shapes: 2 x H_out x
    W_out x C_in/groups x k_h x k_w x C_out per conv and 2 x in x out
    per dense. The stem counts as the direct conv it computes (the
    space-to-depth form multiplies padded taps too). A training step is
    3x this (forward, and the two products of the backward)."""
    import torch

    from k8s_device_plugin_tpu_torch.models import layers

    total = 0

    def count(module, _, out):
        nonlocal total
        if isinstance(module, layers.Conv):
            total += 2 * out[0].numel() * module.weight[0].numel()
        else:
            total += 2 * module.weight.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (layers.Conv, layers.Dense))]
    try:
        x = torch.zeros(1, 3, image_size, image_size,
                        device=next(model.parameters()).device)
        with torch.no_grad():
            model(x, train=False)
    finally:
        for h in hooks:
            h.remove()
    stem = getattr(model, "stem_kernel", None)
    if stem is not None:
        taps = stem.shape[-1]
        stride, pad = (4, 2) if taps == 11 else (2, 3)
        side = (image_size + 2 * pad - taps) // stride + 1
        total += 2 * side * side * stem.numel()
    return total


def _conv_profile(name: str, batch: int) -> dict:
    """torch.profiler over one bf16 training step (after three warm-up
    steps): device busy time, idle share, launches, the largest kernels,
    and the step's FLOP (3 x conv_forward_flops x batch) over the wall
    and over the busy time against the bf16 peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.models import alexnet

    model, optimizer, size = _conv_model(name, torch.bfloat16)
    model.to("cuda", memory_format=torch.channels_last)
    step = alexnet.make_train_step(model, optimizer(model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    images, labels = alexnet.synthetic_batch(gen, batch, size)
    torch.backends.cudnn.benchmark = True
    for _ in range(3):
        step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = sum(ms for _, ms, _ in events)
    if not busy:
        raise AssertionError(f"convnets: the {name} profile saw no device "
                             "time")
    flop = 3 * batch * conv_forward_flops(model, size)
    peak = PEAK_OPS_PER_S["torch.bfloat16"]
    return {"batch": batch, "image_size": size, "wall_ms": wall_ms,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "kernels": len(events), "launches": sum(n for _, _, n in events),
            "train_flop": flop,
            "tflops_per_s_wall": flop / wall_ms / 1e9,
            "tflops_per_s_busy": flop / busy / 1e9,
            "peak_share_wall": flop / (wall_ms / 1e3) / peak,
            "top": [[k[:80], ms, n] for k, ms, n in events[:10]]}


def _conv_stems() -> dict:
    """space_to_depth_conv against direct_conv on the card: float32
    outputs (TF32 off) within 1e-5 of each other, and each one's bf16
    time by CUDA events at the stems' published shapes (64 filters)."""
    import torch

    from k8s_device_plugin_tpu_torch.ops.s2d import (
        direct_conv,
        space_to_depth_conv,
    )

    torch.backends.cudnn.benchmark = True
    out = {}
    for label, batch, taps, stride, pad in CONV_STEMS:
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(batch, 3, 224, 224, device="cuda", generator=gen
                        ).contiguous(memory_format=torch.channels_last)
        w = torch.randn(64, 3, taps, taps, device="cuda", generator=gen) \
            * (3 * taps * taps) ** -0.5
        with _no_tf32():
            err = _rel_err(space_to_depth_conv(x, w, stride, pad),
                           direct_conv(x, w, stride, pad))
        if err > 1e-5:
            raise AssertionError(f"convnets: stem {label} s2d != direct: "
                                 f"{err}")
        xb = x.to(torch.bfloat16)
        out[label] = {
            "input": [batch, 224, 224, 3], "taps": taps, "stride": stride,
            "fp32_rel_err": err,
            "direct_ms": cuda_ms(lambda: direct_conv(xb, w, stride, pad)),
            "s2d_ms": cuda_ms(
                lambda: space_to_depth_conv(xb, w, stride, pad))}
    return out


def phase_convnets(counters) -> dict:
    """The conv workloads on the card (models/alexnet.py, resnet.py,
    mobilenet.py, inception.py, ops/s2d.py): float32 card = CPU, the
    example pod's command, the published shapes, the flagship forward,
    two profiles and the two stems. The conv path launches none of the
    port's kernels: every count stays 0."""
    import torch

    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    line = {"phase": "convnets", "ok": True,
            "exactness": _conv_exactness(), "pod": _conv_pod(),
            "shapes": _conv_shapes(), "forward": _conv_forward(),
            "profiles": {f"{name}_b{batch}": _conv_profile(name, batch)
                         for name, batch in CONV_PROFILES},
            "stems": _conv_stems()}
    line["launches"] = {c.name: c.launches for c in counters}
    if any(line["launches"].values()):
        raise AssertionError(f"convnets: a port kernel launched: "
                             f"{line['launches']}")
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    return line


# B1's shape in the allotted child: [batch, heads, seq, head_dim], bf16,
# causal (small: the check is that the allotment lands on the card, not
# B1's speed, which phase_kernel measures).
DP_CHILD_SHAPE = (1, 4, 128, 64)

# The allotted child: runs with exactly the Allocate envs, builds nothing
# (B1's library is already under build/kernels from phase_build), launches
# B1 once against its plain version and reports the card CUDA shows it.
_DP_CHILD = r"""
import json, os, sys, time
t0 = time.perf_counter()
import torch
from k8s_device_plugin_tpu_torch.ops import _build, attention
assert torch.cuda.device_count() == 1, torch.cuda.device_count()
b, h, s, d = %(shape)r
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
           .to(torch.bfloat16) for _ in range(3))
out, lse = attention.flash_forward_cuda(q, k, v, True)
torch.cuda.synchronize()
ref_out, ref_lse = attention.reference_attention_with_lse(q, k, v, True)
print(json.dumps({
    "uuid": str(torch.cuda.get_device_properties(0).uuid),
    "device": torch.cuda.get_device_name(0),
    "finite": bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
    "max_abs_err_out": (out.float() - ref_out.float()).abs().max().item(),
    "max_abs_err_lse": (lse - ref_lse).abs().max().item(),
    "launches": attention.FLASH_FWD.launches,
    "nvcc_runs": _build.stats()["builds"],
    "seconds": time.perf_counter() - t0,
    "visible": {n: os.environ.get(n) for n in
                ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")},
}))
"""


def _smi_gpus() -> list:
    """[(uuid, normalised PCI address or None)] as nvidia-smi lists them
    (its ``00000000:1B:00.0``, or ``[N/A]`` where the host hides it)."""
    from k8s_device_plugin_tpu_torch.native import binding

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,pci.bus_id",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    rows = [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]
    return [(uuid, binding.normalize_pci_address(bus)) for _, uuid, bus in rows]


def _kubelet_stub(kubelet_dir: str):
    """A kubelet's Registration service on ``<dir>/kubelet.sock`` over the
    port's api copies: (server, registrations list, event set on each)."""
    from concurrent import futures

    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api.deviceplugin.v1beta1 import (
        api_grpc, api_pb2)

    registrations, registered = [], threading.Event()

    class Registration(api_grpc.RegistrationServicer):
        def Register(self, request, context):
            registrations.append(request)
            registered.set()
            return api_pb2.Empty()

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    api_grpc.add_RegistrationServicer_to_server(Registration(), server)
    server.add_insecure_port(
        f"unix://{os.path.join(kubelet_dir, constants.KUBELET_SOCKET_NAME)}")
    server.start()
    return server, registrations, registered


def _daemon_under_kubelet(chips: dict, preferred: list, paths: list,
                          envs: dict) -> dict:
    """(d): the daemon's own command under the kubelet stub: Register,
    the first ListAndWatch list, GetPreferredAllocation and Allocate over
    its socket, equal to what the grpc-free core gave; SIGTERM with the
    stream open, exit 0, socket gone."""
    import tempfile

    import grpc

    from k8s_device_plugin_tpu_torch.api.deviceplugin.v1beta1 import (
        api_grpc, api_pb2)
    from k8s_device_plugin_tpu_torch.plugin import allocation

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="device_plugin_", dir=os.path.join(HERE, "build"))
    kdir = os.path.join(work, "kubelet")
    os.makedirs(kdir)
    server, registrations, registered = _kubelet_stub(kdir)
    log_path = os.path.join(work, "daemon.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "k8s_device_plugin_tpu_torch.cmd.device_plugin",
             "--kubelet-dir", kdir, "--checkpoint-dir",
             os.path.join(work, "ckpt"), "--driver-wait-seconds", "30"],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    try:
        if not registered.wait(60):
            raise AssertionError(
                f"device_plugin: no registration in 60 s:\n"
                f"{open(log_path).read()}")
        register_s = time.perf_counter() - t0
        reg = registrations[0]
        if (reg.version, reg.resource_name, reg.endpoint,
                reg.options.get_preferred_allocation_available) != (
                "v1beta1", "nvidia.com/gpu", "nvidia.com_gpu", True):
            raise AssertionError(f"device_plugin: registration {reg}")
        channel = grpc.insecure_channel(f"unix://{os.path.join(kdir, reg.endpoint)}")
        stub = api_grpc.DevicePluginStub(channel)
        stream = stub.ListAndWatch(api_pb2.Empty())
        first = next(stream)
        listed = [(d.ID, d.health, [n.ID for n in d.topology.nodes])
                  for d in first.devices]
        want = [(c.key, "Healthy", [c.numa_node] if c.numa_node >= 0 else [])
                for c in sorted(chips.values(), key=lambda c: c.index)]
        if listed != want:
            raise AssertionError(f"device_plugin: listed {listed}, want {want}")
        pref = stub.GetPreferredAllocation(api_pb2.PreferredAllocationRequest(
            container_requests=[api_pb2.ContainerPreferredAllocationRequest(
                available_deviceIDs=[c.key for c in chips.values()],
                allocation_size=1)]), timeout=30)
        got_pref = list(pref.container_responses[0].deviceIDs)
        resp = stub.Allocate(api_pb2.AllocateRequest(container_requests=[
            api_pb2.ContainerAllocateRequest(devices_ids=got_pref)]), timeout=30)
        car = resp.container_responses[0]
        got_paths = [d.host_path for d in car.devices]
        got_envs = {n: car.envs[n] for n in allocation.VISIBLE_ENVS
                    if n in car.envs}
        if (got_pref, got_paths, got_envs) != (preferred, paths, envs):
            raise AssertionError(
                f"device_plugin: daemon answered {got_pref} {got_paths} "
                f"{got_envs}, the core {preferred} {paths} {envs}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        channel.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        server.stop(grace=0).wait()
    if rc != 0 or os.path.exists(os.path.join(kdir, reg.endpoint)):
        raise AssertionError(
            f"device_plugin: daemon exit {rc}:\n{open(log_path).read()}")
    return {"grpc": True, "register_s": register_s,
            "listed": [list(x) for x in listed], "preferred": got_pref,
            "allocation_id": car.envs.get("TPU_ALLOCATION_ID"),
            "log": os.path.relpath(log_path, HERE),
            "seconds": time.perf_counter() - t0}


def phase_device_plugin() -> dict:
    import importlib.util

    from k8s_device_plugin_tpu_torch.allocator import (
        BestEffortPolicy, devices_from_chips)
    from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod
    from k8s_device_plugin_tpu_torch.discovery import gpu_topology
    from k8s_device_plugin_tpu_torch.native import binding
    from k8s_device_plugin_tpu_torch.plugin import allocation

    t_phase = time.perf_counter()
    line = {"phase": "device_plugin", "ok": True}
    # (a) discovery on the real roots
    t0 = time.perf_counter()
    chips = chips_mod.get_gpu_chips()
    line["discovery_ms"] = (time.perf_counter() - t0) * 1e3
    smi = _smi_gpus()
    found = sorted((c.uuid, c.pci_address or None) for c in chips.values())
    if found != sorted(smi):
        raise AssertionError(f"device_plugin: discovery {found}, nvidia-smi {smi}")
    if not all(chips_mod.dev_functional(c) for c in chips.values()):
        raise AssertionError("device_plugin: a device node does not open")
    walked = chips_mod._discover_procfs("/sys", "/dev", "/proc")
    line["nvml"] = binding.version()
    line["procfs_gpus"] = len(walked)
    if binding.available() and walked:
        def fields(c):
            return (c.index, c.pci_address, c.dev_path, c.uuid, c.model,
                    c.numa_node, c.extra_dev_paths)
        by_index = sorted(chips.values(), key=lambda c: c.index)
        if [fields(c) for c in by_index] != [fields(c) for c in walked]:
            raise AssertionError(
                f"device_plugin: NVML {[fields(c) for c in by_index]} != "
                f"procfs {[fields(c) for c in walked]}")
    line["gpus"] = [{"key": c.key, "minor": c.index, "pci": c.pci_address,
                     "uuid": c.uuid, "model": c.model, "numa": c.numa_node,
                     "generation": c.generation, "nvlinks": len(c.nvlinks),
                     "dev_path": c.dev_path,
                     "extra_dev_paths": list(c.extra_dev_paths)}
                    for c in chips.values()]
    # (b) placement and the allocate core
    t0 = time.perf_counter()
    chip_list = sorted(chips.values(), key=lambda c: c.index)
    devices = devices_from_chips(chip_list)
    policy = BestEffortPolicy()
    policy.init(devices, gpu_topology(chip_list))
    preferred = policy.allocate([d.id for d in devices], [], 1)
    allotted = [c for c in chip_list if c.key in preferred]
    paths, envs = allocation.container_allocation(allotted)
    line["placement_ms"] = (time.perf_counter() - t0) * 1e3
    (gpu,) = allotted
    if paths[0] != gpu.dev_path or not {"nvidiactl", "nvidia-uvm"} \
            <= {os.path.basename(p) for p in paths[1:]}:
        raise AssertionError(f"device_plugin: device specs {paths}")
    if envs != {n: gpu.uuid for n in allocation.VISIBLE_ENVS}:
        raise AssertionError(f"device_plugin: envs {envs}")
    line.update(preferred=preferred, device_specs=paths, envs=envs)
    # (c) a child under exactly those envs runs B1 on the allotted GPU
    env = {k: v for k, v in os.environ.items()
           if k not in allocation.VISIBLE_ENVS}
    env.update(envs)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _DP_CHILD % {"shape": DP_CHILD_SHAPE}],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"device_plugin: child failed:\n{proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    child["wall_s"] = time.perf_counter() - t0
    err = max(child["max_abs_err_out"], child["max_abs_err_lse"])
    if not child["finite"] or err > TOL["bfloat16"]:
        raise AssertionError(f"device_plugin: child's B1 {child}")
    if "GPU-" + child["uuid"] != gpu.uuid:
        raise AssertionError(
            f"device_plugin: child ran on {child['uuid']}, allotted {gpu.uuid}")
    if child["launches"] != 1 or child["nvcc_runs"] != 0:
        raise AssertionError(f"device_plugin: child {child}")
    child["shape"], child["tol"] = list(DP_CHILD_SHAPE), TOL["bfloat16"]
    line["child"] = child
    # (d) the daemon under a kubelet, where grpcio and protobuf import
    if importlib.util.find_spec("grpc") and \
            importlib.util.find_spec("google.protobuf"):
        line["daemon"] = _daemon_under_kubelet(chips, preferred, paths, envs)
        line["grpc"] = True
    else:
        line["grpc"] = False
    line["seconds"] = time.perf_counter() - t_phase
    return line


# ---------------------------------------------------------------------------
# metrics_exporter: the exporter daemon and the plugin's health through it
# ---------------------------------------------------------------------------

# nvidia-smi's view of each GPU, matched by UUID with what NVML answers
# the exporter (its query fields, in this order).
SMI_TELEMETRY = ("uuid", "memory.total", "memory.used", "utilization.gpu",
                 "temperature.gpu", "pcie.link.gen.current",
                 "pcie.link.width.current")
ME_TEMP_TOL_C = 3.0
ME_MIB = 1 << 20
# (b): the child's hold on the card, B1's shape in its load loop (the
# serving default's prefill, so the loop keeps the card busy) and the
# loop's seconds; the rise NVML must see, and how close usage must come
# back after the child exits, and how soon.
ME_HOLD_BYTES = 4 << 30
ME_LOAD_SHAPE = (4, 16, 1024, 64)
ME_LOAD_S = 3.0
ME_POLL_S = 0.2
ME_RISE_MIN = ME_HOLD_BYTES - 256 * ME_MIB
ME_FALL_TOL = 512 * ME_MIB
ME_FALL_WITHIN_S = 10.0
# (d): pulses to demote (the 3-of-5 rule) and to recover; the lifecycle's
# soak before RECOVERING ends (60 s by default) is cut to fit the phase.
ME_DOWN_PULSES = 10
ME_UP_PULSES = 15
ME_SOAK_S = "3"

# The loaded child of (b): holds ME_HOLD_BYTES on the card and launches B1
# from the library phase_build made (no nvcc) for ME_LOAD_S seconds.
_ME_CHILD = r"""
import json, time
t0 = time.perf_counter()
import torch
from k8s_device_plugin_tpu_torch.ops import _build, attention
hold = torch.empty(%(hold)d, dtype=torch.uint8, device="cuda")
b, h, s, d = %(shape)r
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
           .to(torch.bfloat16) for _ in range(3))
torch.cuda.synchronize()
start_s = time.perf_counter() - t0
t1 = time.perf_counter()
while time.perf_counter() - t1 < %(seconds)r:
    for _ in range(20):
        attention.flash_forward_cuda(q, k, v, True)
    torch.cuda.synchronize()
print(json.dumps({
    "held_bytes": hold.numel(), "launches": attention.FLASH_FWD.launches,
    "nvcc_runs": _build.stats()["builds"], "start_s": start_s,
    "load_s": time.perf_counter() - t1,
}))
"""


def _smi_number(text: str):
    """A number nvidia-smi printed; None for ``[N/A]``, ``[Not
    Supported]`` and the like."""
    try:
        return float(text)
    except ValueError:
        return None


def _smi_telemetry() -> dict:
    """{uuid: {field: number or None}} for SMI_TELEMETRY's fields."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(SMI_TELEMETRY)}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    rows = [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]
    return {row[0]: {k: _smi_number(v)
                     for k, v in zip(SMI_TELEMETRY[1:], row[1:])}
            for row in rows}


def _me_expected(chips, smi: dict) -> dict:
    """What /metrics and the in-process readers must show for each GPU,
    by key, from nvidia-smi: memory total (bytes), temperature, link
    rate and width, each None where nvidia-smi prints no number, and
    whether utilisation is there."""
    from k8s_device_plugin_tpu_torch.exporter.telemetry import PCIE_GEN_GTS

    out = {}
    for c in chips:
        s = smi[c.uuid]
        gen = s["pcie.link.gen.current"]
        width = s["pcie.link.width.current"]
        out[c.key] = {
            "minor": c.index,
            "memory_total": None if s["memory.total"] is None
            else s["memory.total"] * ME_MIB,
            "temp_c": s["temperature.gpu"],
            "link_speed_gts": None if gen is None else PCIE_GEN_GTS[int(gen)],
            "link_width": None if width is None else int(width),
            "util": s["utilization.gpu"] is not None,
        }
    return out


def _me_check(what: str, key: str, want: dict, got: dict) -> None:
    """``got`` (memory_total, memory_used, duty, temp_c, link_speed_gts,
    link_width) against ``want``: memory present and its total within
    1 MiB, every other field present exactly where nvidia-smi prints a
    number, temperature within ME_TEMP_TOL_C, the link exact."""
    bad = []
    if got["memory_total"] is None or got["memory_used"] is None:
        bad.append("no memory gauges")
    elif want["memory_total"] is None or \
            abs(got["memory_total"] - want["memory_total"]) > ME_MIB:
        bad.append(f"memory total {got['memory_total']} against "
                   f"{want['memory_total']}")
    if (got["duty"] is not None) != want["util"]:
        bad.append(f"utilisation {got['duty']} where nvidia-smi "
                   f"{'prints' if want['util'] else 'has none'}")
    if (got["temp_c"] is None) != (want["temp_c"] is None) or (
            want["temp_c"] is not None
            and abs(got["temp_c"] - want["temp_c"]) > ME_TEMP_TOL_C):
        bad.append(f"temperature {got['temp_c']} against {want['temp_c']}")
    for field in ("link_speed_gts", "link_width"):
        if got[field] != want[field]:
            bad.append(f"{field} {got[field]} against {want[field]}")
    if bad:
        raise AssertionError(f"metrics_exporter {what}: {key}: {bad}")


def _me_in_process(chips, smi: dict) -> dict:
    """(a): the runtime reader and the telemetry reader in this process
    against nvidia-smi; one read's latency."""
    from k8s_device_plugin_tpu_torch.exporter import runtime, telemetry
    from k8s_device_plugin_tpu_torch.native import binding

    reads_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        got = runtime.read_runtime_metrics("nvml")
        reads_ms.append((time.perf_counter() - t0) * 1e3)
    if got is None:
        raise AssertionError("metrics_exporter (a): NVML answered nothing")
    want = _me_expected(chips, smi)
    nvml = {}
    for c in chips:
        acc = got.accelerators.get(c.key)
        if acc is None:
            raise AssertionError(
                f"metrics_exporter (a): {c.key} not among "
                f"{sorted(got.accelerators)}")
        t = telemetry.read_chip_telemetry(c)
        _me_check("(a)", c.key, want[c.key], {
            "memory_total": acc.hbm_total_bytes,
            "memory_used": acc.hbm_usage_bytes,
            "duty": acc.duty_cycle_pct, "temp_c": t.temp_c,
            "link_speed_gts": t.link_speed_gts, "link_width": t.link_width})
        sample = binding.sample(c.uuid)
        nvml[c.key] = {
            "answered": {k: v for k, v in sample.items()
                         if k != "errors" and v is not None},
            "refused": sample["errors"],
        }
    return {"read_ms_first": reads_ms[0],
            "read_ms_median": sorted(reads_ms)[len(reads_ms) // 2],
            "reads": len(reads_ms), "nvml": nvml, "nvidia_smi": smi,
            "expected": want}


def _me_loaded(chips, smi: dict) -> dict:
    """(b): a child holds ME_HOLD_BYTES and launches B1 for ME_LOAD_S;
    NVML's usage must rise by ME_RISE_MIN, its utilisation read above 0
    (where nvidia-smi shows one), and usage come back within ME_FALL_TOL
    of the reading before, within ME_FALL_WITHIN_S of the child's exit."""
    from k8s_device_plugin_tpu_torch.exporter import runtime

    gpu = chips[0]

    def read():
        acc = runtime.read_runtime_metrics("nvml").accelerators[gpu.key]
        return acc.hbm_usage_bytes, acc.duty_cycle_pct

    before, _ = read()
    polls = []
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", _ME_CHILD % {
            "hold": ME_HOLD_BYTES, "shape": ME_LOAD_SHAPE,
            "seconds": ME_LOAD_S}],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": gpu.uuid})
    try:
        while child.poll() is None:
            used, duty = read()
            polls.append((time.perf_counter() - t0, used, duty))
            time.sleep(ME_POLL_S)
        out, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    exit_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"metrics_exporter (b): child failed:\n{err}")
    report = json.loads(out.strip().splitlines()[-1])
    if report["nvcc_runs"] != 0 or report["launches"] < 1:
        raise AssertionError(f"metrics_exporter (b): child {report}")
    while True:
        after, _ = read()
        fell_s = time.perf_counter() - t0 - exit_s
        if abs(after - before) <= ME_FALL_TOL or fell_s > ME_FALL_WITHIN_S:
            break
        time.sleep(ME_POLL_S)
    rise = max(used for _, used, _ in polls) - before
    duties = [d for _, _, d in polls if d is not None]
    util_shown = smi[gpu.uuid]["utilization.gpu"] is not None
    line = {"gpu": gpu.key, "before_bytes": before, "rise_bytes": rise,
            "rise_min_bytes": ME_RISE_MIN, "after_bytes": after,
            "fell_back_s": fell_s, "polls": len(polls),
            "duty_max": max(duties) if duties else None,
            "duty_nonzero_polls": sum(1 for d in duties if d > 0),
            "utilisation_refused": not util_shown, "child": report,
            "child_wall_s": exit_s}
    if rise < ME_RISE_MIN:
        raise AssertionError(f"metrics_exporter (b): usage rose {rise} B, "
                             f"under {ME_RISE_MIN}: {line}")
    if util_shown and not line["duty_nonzero_polls"]:
        raise AssertionError(f"metrics_exporter (b): utilisation never "
                             f"above 0 under load: {line}")
    if abs(after - before) > ME_FALL_TOL:
        raise AssertionError(
            f"metrics_exporter (b): usage {after} B, {fell_s:.1f} s after "
            f"the child's exit, not within {ME_FALL_TOL} of {before}")
    return line


def _scrape_value(text: str, family: str, labels: str):
    m = re.search(rf"^{family}\{{{re.escape(labels)}\}} (\S+)$", text, re.M)
    return None if m is None else float(m.group(1))


def _me_scraped(text: str, want: dict) -> None:
    """(c): /metrics against ``_me_expected``, per GPU key."""
    for key, w in want.items():
        chip = f'device="{key}",chip="{w["minor"]}"'
        acc = f'accelerator="{key}"'
        if _scrape_value(text, "tpu_chip_health", chip) != 1:
            raise AssertionError(f"metrics_exporter (c): {key} not healthy "
                                 f"on /metrics")
        width = _scrape_value(text, "tpu_chip_pcie_link_width", chip)
        _me_check("(c) /metrics", key, w, {
            "memory_total": _scrape_value(text, "tpu_hbm_total_bytes", acc),
            "memory_used": _scrape_value(text, "tpu_hbm_usage_bytes", acc),
            "duty": _scrape_value(
                text, "tpu_tensorcore_duty_cycle_percent", acc),
            "temp_c": _scrape_value(text, "tpu_chip_temp_celsius", chip),
            "link_speed_gts": _scrape_value(
                text, "tpu_chip_pcie_link_speed_gts", chip),
            "link_width": None if width is None else int(width)})
    count = re.search(r"^tpu_chip_count (\S+)$", text, re.M)
    if count is None or float(count.group(1)) != len(want):
        raise AssertionError(f"metrics_exporter (c): tpu_chip_count "
                             f"{count and count.group(1)}, want {len(want)}")


def _me_dev_root(work: str, dev_root: str) -> str:
    """A scratch dev root of symlinks to every ``nvidia*`` node under
    ``dev_root``: the exporter probes these, and (d) removes one."""
    scratch = os.path.join(work, "dev")
    os.makedirs(scratch)
    for name in sorted(os.listdir(dev_root)):
        if name.startswith("nvidia"):
            os.symlink(os.path.join(dev_root, name),
                       os.path.join(scratch, name))
    return scratch


def _me_daemons(chips, roots: dict, check_metrics=None) -> dict:
    """(c) and (d): the exporter's command on a scratch dev root, then
    the device plugin's command under the kubelet stub with
    ``--health-socket`` at it and ``--pulse 1``: the first list Healthy,
    the first GPU's symlink removed (Unhealthy within ME_DOWN_PULSES
    ListAndWatch updates) and restored (Healthy within ME_UP_PULSES),
    SIGTERM to both, each exiting 0 with its socket gone. ``roots`` are
    the host's sysfs, dev and proc roots; ``check_metrics(text)`` raises
    where /metrics is wrong (None: scrape without comparing)."""
    import tempfile

    import grpc

    from k8s_device_plugin_tpu_torch.api.deviceplugin.v1beta1 import (
        api_grpc, api_pb2)
    from k8s_device_plugin_tpu_torch.api.metricssvc import (
        metricssvc_grpc, metricssvc_pb2)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="metrics_exporter_",
                            dir=os.path.join(HERE, "build"))
    dev = _me_dev_root(work, roots["dev"])
    sock = os.path.join(work, "exporter", "health.sock")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": HERE, "TPU_HEALTH_SOAK_S": ME_SOAK_S}
    host = ["--sysfs-root", roots["sysfs"], "--proc-root", roots["proc"]]
    ex_log = os.path.join(work, "exporter.log")
    dp_log = os.path.join(work, "plugin.log")
    kdir = os.path.join(work, "kubelet")
    os.makedirs(kdir)
    procs, line = [], {"dir": os.path.relpath(work, HERE)}
    server, registrations, registered = _kubelet_stub(kdir)
    t0 = time.perf_counter()
    try:
        with open(ex_log, "w") as log:
            exporter = subprocess.Popen(
                [sys.executable, "-m",
                 "k8s_device_plugin_tpu_torch.cmd.metrics_exporter",
                 "--socket", sock, "--dev-root", dev, *host,
                 "--http-port", str(port), "--http-addr", "127.0.0.1",
                 "--runtime-metrics-addr", "nvml"],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append(exporter)
        while not os.path.exists(sock):
            if exporter.poll() is not None or time.perf_counter() - t0 > 60:
                raise AssertionError(f"metrics_exporter (c): no socket:\n"
                                     f"{open(ex_log).read()}")
            time.sleep(0.05)
        line["exporter_socket_s"] = time.perf_counter() - t0
        # (c) List over the socket, /metrics, /healthz
        keys = [c.key for c in chips]
        with grpc.insecure_channel(f"unix://{sock}") as channel:
            listed = metricssvc_grpc.MetricsServiceStub(channel).List(
                metricssvc_pb2.Empty(), timeout=30)
        states = [(s.id, s.device, s.health) for s in listed.tpu_state]
        if states != [(str(c.index), c.key, "healthy") for c in chips]:
            raise AssertionError(f"metrics_exporter (c): List {states}")
        while True:
            try:
                status, text = _get(port, "/metrics")
                break
            except OSError:
                if time.perf_counter() - t0 > 60:
                    raise
                time.sleep(0.05)
        if status != 200:
            raise AssertionError(f"metrics_exporter (c): /metrics {status}")
        if check_metrics is not None:
            check_metrics(text)
        status, health = _get(port, "/healthz")
        doc = json.loads(health)
        if status != 200 or (doc.get("chips"), doc.get("healthy")) != \
                (len(chips), len(chips)):
            raise AssertionError(f"metrics_exporter (c): /healthz {status} "
                                 f"{health}")
        line.update(listed=[list(s) for s in states], healthz=doc,
                    metrics_lines=len(text.splitlines()))
        # (d) the plugin's health through the exporter
        t1 = time.perf_counter()
        with open(dp_log, "w") as log:
            plugin = subprocess.Popen(
                [sys.executable, "-m",
                 "k8s_device_plugin_tpu_torch.cmd.device_plugin",
                 "--kubelet-dir", kdir, *host,
                 "--checkpoint-dir", os.path.join(work, "ckpt"),
                 "--health-socket", sock, "--pulse", "1",
                 "--driver-wait-seconds", "30"],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append(plugin)
        if not registered.wait(60):
            raise AssertionError(f"metrics_exporter (d): no registration:\n"
                                 f"{open(dp_log).read()}")
        reg = registrations[0]
        channel = grpc.insecure_channel(
            f"unix://{os.path.join(kdir, reg.endpoint)}")
        try:
            stream = api_grpc.DevicePluginStub(channel).ListAndWatch(
                api_pb2.Empty(), timeout=120)
            first = {d.ID: d.health for d in next(stream).devices}
            if first != {k: "Healthy" for k in keys}:
                raise AssertionError(f"metrics_exporter (d): first list "
                                     f"{first}")
            gone = chips[0]
            node = os.path.join(dev, os.path.basename(gone.dev_path))
            target = os.readlink(node)

            def pulses_until(health, limit):
                for n in range(1, limit + 1):
                    devs = {d.ID: d.health for d in next(stream).devices}
                    if devs[gone.key] == health:
                        return n, devs
                raise AssertionError(
                    f"metrics_exporter (d): {gone.key} not {health} within "
                    f"{limit} pulses:\n{open(dp_log).read()[-3000:]}")

            os.remove(node)
            t2 = time.perf_counter()
            line["pulses_to_unhealthy"], devs = pulses_until("Unhealthy",
                                                             ME_DOWN_PULSES)
            line["seconds_to_unhealthy"] = time.perf_counter() - t2
            others = {k: h for k, h in devs.items() if k != gone.key}
            if set(others.values()) - {"Healthy"}:
                raise AssertionError(f"metrics_exporter (d): {devs}")
            os.symlink(target, node)
            t2 = time.perf_counter()
            line["pulses_to_healthy"], devs = pulses_until("Healthy",
                                                           ME_UP_PULSES)
            line["seconds_to_healthy"] = time.perf_counter() - t2
            plugin.send_signal(signal.SIGTERM)
            rc_plugin = plugin.wait(timeout=60)
        finally:
            channel.close()
        exporter.send_signal(signal.SIGTERM)
        rc_exporter = exporter.wait(timeout=60)
        line["plugin_s"] = time.perf_counter() - t1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        server.stop(grace=0).wait()
    if rc_plugin != 0 or os.path.exists(os.path.join(kdir, reg.endpoint)):
        raise AssertionError(f"metrics_exporter (d): plugin exit "
                             f"{rc_plugin}:\n{open(dp_log).read()}")
    if rc_exporter != 0 or os.path.exists(sock):
        raise AssertionError(f"metrics_exporter (d): exporter exit "
                             f"{rc_exporter}:\n{open(ex_log).read()}")
    line.update(soak_s=float(ME_SOAK_S), seconds=time.perf_counter() - t0)
    return line


def phase_metrics_exporter() -> dict:
    import importlib.util

    from k8s_device_plugin_tpu_torch.discovery import chips as chips_mod

    t_phase = time.perf_counter()
    for mod in ("grpc", "google.protobuf"):
        if importlib.util.find_spec(mod) is None:
            raise AssertionError(f"metrics_exporter: {mod} does not import; "
                                 "(c) and (d) need it")
    chips = sorted(chips_mod.get_gpu_chips().values(), key=lambda c: c.index)
    smi = _smi_telemetry()
    if sorted(smi) != sorted(c.uuid for c in chips):
        raise AssertionError(f"metrics_exporter: nvidia-smi {sorted(smi)}, "
                             f"discovery {[c.uuid for c in chips]}")
    line = {"phase": "metrics_exporter", "ok": True}
    line["in_process"] = _me_in_process(chips, smi)
    line["loaded"] = _me_loaded(chips, smi)
    # (c) compares with nvidia-smi read beside the scrape: (b)'s load
    # warms the card by a few degrees
    line["daemons"] = _me_daemons(
        chips, {"sysfs": "/sys", "dev": "/dev", "proc": "/proc"},
        lambda text: _me_scraped(text, _me_expected(chips, _smi_telemetry())))
    line["seconds"] = time.perf_counter() - t_phase
    return line


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # Daemon forensics records go to the build directory, not the
    # committed journal.
    os.environ.setdefault("TPU_CHIP_LOG",
                          os.path.join(HERE, "build", "chip_log.jsonl"))
    from k8s_device_plugin_tpu_torch.ops import attention, paged_attention

    _jline({"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0)})
    _jline(phase_build())
    _jline(phase_device_plugin())
    _jline(phase_metrics_exporter())
    line, summary = phase_kernel()
    _jline(line)
    line, bwd_summaries = phase_kernel_bwd()
    _jline(line)
    line, paged_summary = phase_paged_kernel()
    _jline(line)
    _jline(phase_model())
    _jline(phase_profile())
    serve = phase_serve([attention.FLASH_FWD])
    serve_tokens = serve.pop("tokens")
    _jline(serve)
    summary["launches"] = serve["launches"]["flash_fwd"]
    paged_counters = [attention.FLASH_FWD, paged_attention.PAGED_ATTN,
                      paged_attention.PAGED_ATTN_COMBINE]
    serve_paged = phase_serve_paged(paged_counters)
    paged_tokens = serve_paged.pop("tokens")
    _jline(serve_paged)
    paged_summary["launches"] = serve_paged["launches"]["paged_attn"]
    paged_summary["combine_launches"] = \
        serve_paged["launches"]["paged_attn_combine"]
    serve_spec = phase_serve_spec(paged_counters)
    _jline(serve_spec)
    paged_summary["launches_spec"] = serve_spec["launches"]["paged_attn"]
    paged_summary["combine_launches_spec"] = \
        serve_spec["launches"]["paged_attn_combine"]
    serve_handoff = phase_serve_handoff(paged_counters, paged_tokens)
    handoff_texts = serve_handoff.pop("texts")
    _jline(serve_handoff)
    serve_static = phase_serve_static(paged_counters, serve_tokens)
    _jline(serve_static)
    summary["launches_static"] = serve_static["launches"]["flash_fwd"]
    summary["launches_static_warmup"] = \
        serve_static["launches_warmup"]["flash_fwd"]
    serve_ckpt = phase_serve_checkpoint(paged_counters)
    _jline(serve_ckpt)
    summary["launches_checkpoint"] = \
        serve_ckpt["static"]["launches"]["flash_fwd"]
    paged_summary["launches_checkpoint"] = \
        serve_ckpt["paged"]["launches"]["paged_attn"]
    paged_summary["launches_handoff"] = \
        serve_handoff["launches"]["paged_attn"]
    paged_summary["launches_handoff_by_replica"] = {
        name: n["launches"]
        for name, n in serve_handoff["launches_by_replica"].items()}
    serve_moe = phase_serve_moe(paged_counters)
    _jline(serve_moe)
    paged_summary["launches_moe"] = serve_moe["launches"]["paged_attn"]
    moe_train = serve_moe["train"]["launches"]
    summary["launches_moe_train"] = moe_train["flash_fwd"]
    for s in bwd_summaries:
        s["launches_moe_train"] = moe_train[s["name"]]
    # compile_cache's four daemon processes run beside serve_tp, for the
    # script's time: its gates are counts and token identity, serve_tp's
    # ranks share the card over gloo (no speed of theirs is a result),
    # and the cache runs' startup seconds are then taken under that load.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cache_run = pool.submit(phase_compile_cache)
        serve_tp = phase_serve_tp(serve_paged)
        compile_cache = cache_run.result()
    _jline(compile_cache)
    _jline(serve_tp)
    for s, k in ((summary, "flash_fwd"), (paged_summary, "paged_attn")):
        s["launches_serve_tp_by_rank"] = {
            case: [n[k] for n in c["launches_by_rank"]]
            for case, c in serve_tp["exactness"].items()
            if isinstance(c, dict)}
    handoff_tp = phase_serve_handoff_tp(
        dict(serve_handoff["bundle"], texts=handoff_texts))
    _jline(handoff_tp)
    paged_summary["launches_handoff_tp_by_rank"] = {
        case: c["launches_by_rank"]
        for case, c in handoff_tp["exactness"].items()
        if isinstance(c, dict)}
    paged_summary["launches_handoff_tp_daemons_by_replica_and_rank"] = {
        role: {r: n["paged_attn"] for r, n in by_rank.items()}
        for role, by_rank in
        handoff_tp["daemons"]["launches_by_replica_and_rank"].items()}
    train = phase_train()
    _jline(train)
    launches = train["benchmark"]["launches"]
    summary["launches_train"] = launches["flash_fwd"]
    for s in bwd_summaries:
        s["launches"] = launches[s["name"]]
    _jline(phase_train_profile())
    parallel = phase_train_parallel()
    _jline(parallel)
    for s in (summary, *bwd_summaries):
        s["launches_train_parallel"] = {
            name: step["launches_by_rank"][s["name"]]
            for name, step in parallel["steps"].items()}
    train_pp = phase_train_pp()
    _jline(train_pp)
    for s in (summary, *bwd_summaries):
        s["launches_train_pp_by_rank"] = {
            name: [n[s["name"]] for n in c["launches_by_rank"]]
            for name, c in train_pp["exactness"].items()
            if isinstance(c, dict)}
    _jline(phase_convnets([*_train_counters(), *paged_counters[1:]]))
    print(smi_line(), flush=True)
    _jline({"kernels": [summary, *bwd_summaries, paged_summary]})
    _jline({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
