"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # everything (the check of a change)
    python3 chip_smoke.py --kernels-only   # build, check and time the kernels only

Builds the hand-written kernels from the sources in this checkout, holds each
against its plain PyTorch version at the shapes the served paths give it (and
at ragged shapes), times kernel / plain version / one PyTorch library call
beside the card's bound, then drives the port's paths at full width with
random weights from a seed:

* qwen3-0.6b (28 layers, d_model 1024, bf16): ``LocalServing`` (prefill +
  KV-cached decode) and ``RRTOServedLM`` (record, Operator Sequence Search,
  stateful replay) against a ``device_only`` session;
* zamba2-1.2b (38 Mamba2 layers and one shared attention block, d_model
  2048, bf16): the same, with the conv and SSM states carried beside the KV
  caches;
* zamba2-1.2b stateless: ``RRTOServedLM(stateful=False)``, a full forward of
  the bucket per token, so the gated-scan kernel runs inside the replay;
* KAPAO at full width (640-pixel frames, f32, cuDNN convolutions, TF32 off)
  through all five offloading systems, held bitwise against ``device_only``
  and within 2e-4 of the same run on the CPU, with the paper's RPC counts;
  then every other CNN of the zoo through rrto and ``device_only`` at the
  reference's benchmark sizes;
* multi-tenant serving (phase 7): each kernel's vmap rule at 4 lanes held
  bitwise against the loop of the same kernel and timed at batch 4, then
  ``MultiClientServedLM`` with 4 qwen3-0.6b clients and 2 zamba2-1.2b
  stateless clients, each run vmap-batched and looped (equal tokens), and
  the batched width-4 qwen3 step against 4 solo steps in turns;
* minicpm3-4b (phase 8: 62 layers of MLA attention, d_model 2560, bf16):
  stateful (the absorbed latent decode, the latent cache carried) and
  stateless (flash attention at head dim 96 in every replayed token);
* xlstm-1.3b (phase 9: 42 mLSTM and 6 sLSTM blocks, d_model 2048, bf16):
  stateful (705 MB of recurrent state carried on the server) and stateless
  (the gated scan at a state of 1024 x 1025 in every replayed token);
* the MoE family (phase 16, after phase 9): (a) mixtral-8x7b at full
  width and 8 of its 32 layers (8 experts of d_ff 14336, top-2, 32 query
  heads on 8 KV heads, window 4096, bf16): ``LocalServing``, rrto and
  ``device_only``, stateful and stateless (bucket 64), the static-capacity
  dispatch inside every replayed token, its graph step beside the bytes of
  every expert and of the top-2 ones, the prefill's dropped assignments
  printed; (b) the reduced llama4-maverick (a dense layer, then top-1 of 4
  experts beside a shared expert, f32) on the card against the CPU and
  served rrto vs ``device_only``;
* the encoder-decoder and patch-prefix families (phase 17, after phase
  16): (a) whisper-base at full width (6 + 6 layers, d_model 512, bf16) on
  1,500 frames from the seed: ``LocalServing``, its prefill and decode-step
  logits against the extended forward's, then stateful rrto and
  ``device_only`` from the zero cross cache (the served app sends tokens
  alone, as the reference's does), the cross cache carried off the wire;
  (b) whisper-base trained on one batch of 2 x (1,500 frames, 448 tokens),
  with and without ``remat``, the loss falling at each step, the flash
  backward's calls counted by shape; (c) llava-next-34b at full width and
  8 of its 60 layers (56 query heads on 8 KV heads) with 576 patches:
  ``LocalServing`` decoding at ``s + num_patches``, its logits against the
  extended forward's, then stateful rrto and ``device_only``;
* the int8 KV cache and the MoE family batched (phase 18): (a) in the
  main process after phase 14, qwen3-0.6b at full width with
  ``kv_cache_bits=8`` (int8 K/V and f32 scales per position and head, the
  step attending through the plain ``decode_attention_q8_ref``):
  ``LocalServing``, rrto and ``device_only`` at phase 3's prompt and
  bucket, rrto == ``device_only`` bitwise at 3 RPCs a token, the int8
  cache carried off the wire, its replayed step timed beside phase 3's,
  its tokens against the bf16 cache's on the same weights (printed); (b)
  in the second process right after 16a, on its weights: 2 mixtral-8x7b
  clients stateful, then 2 stateless, through ``MultiClientServedLM``,
  each vmap-batched and looped (equal tokens), ``check_lane_order`` on
  each batched edge;
  phases 8, 9, 16, 18b, 17, 7 and then 19 run in a second process on the
  card, started after phase 2 and joined before phase 15, beside phases
  3-6, 10-14 and 18a (the served paths are host-bound: two processes share
  the card's idle time);
* split replay (phase 10, the model cut between the mobile device and the
  edge; both placements run on the card, a device segment's time is the
  cost model's): (a) phase 3's locked qwen3-0.6b IOS at each
  carried-feasible device prefix, the segment programs held bitwise
  against the whole program's step (outputs and carried state); (b)
  qwen3-0.6b served through ``RRTOServedLM(partition=...)`` with the
  longest prefix installed once the IOS locks, tokens equal to phase 3's
  ``device_only``, RPCs and wire bytes per token, the wall split into
  eager split replay and interception, and the host time of the planner's
  schedule; (c) phase 5's zamba2-1.2b stateless IOS under random plans of
  2-5 cuts, bitwise against the whole program, with rmsnorm, flash
  attention and the scan in device-placed segments; (d) the sensor encoder
  split by the planner (bitwise plain rrto and ``device_only``), the
  planner's sweep over the partition benchmark's bandwidths, a pipelined
  Poisson stream bitwise the sequential split, and the recurrent decoder's
  stateful split;
* fault tolerance (phase 11): (a) qwen3-0.6b decoded through
  ``EdgeFleet(2)`` with the stream held by a ``FleetClient``, clean and then
  migrated r0 -> r1 after the lock, on a lossy link (at-most-once retries,
  some step's response lost and answered from the dedup table) and through
  a crash of r0 (restored on r1 from a checkpoint and the step log), each
  bitwise the clean stream in tokens and final carried state; (b) zamba2-1.2b
  stateless, clean and through one outage window: the request falls back to
  the device (flash attention and the scan launch there too), its token and
  logits bitwise the clean stream's replay of it, and the stream heals; (c)
  the split sensor encoder adopts the all-device plan for the outage and
  re-offloads after it;
* admission and overload (phase 12): (a) four zamba2-1.2b stateless clients
  (gold, silver, bronze, bronze) on an edge guarded by an
  ``AdmissionController`` calibrated as ``benchmarks/load_knee.py`` does,
  and its twin edge without one, under the same open-loop Poisson arrivals
  below and beyond the capacity knee: all admitted below it; typed sheds,
  ``degraded_device`` responses and an admitted p99 at most half the twin's
  beyond it (simulated clock); every returned response bitwise the twin's;
  (b) one ``run_round`` with ``round_capacity = 2``: the EDF/DRR pair batched
  at width 2, the rest solo, bitwise the uncapped round; (c) a qwen3-0.6b
  stateful decode shed twice with its step and carried state untouched,
  then decoded on; (d) the split sensor encoder's tier-1 degrade
  (``degraded_split``) and the planner's restore;
* observability (phase 13, after 12b, on the simulated clock): (a) a
  zamba2-1.2b stateless ``EdgeFleet(2, hedging=True)`` traced and its
  untraced twin on tests/test_obs.py's schedule (the primary stalled, the
  router hedging to r1), every response and counter bitwise the twin's, the
  race loser annotated cancelled and the root metrics snapshot agreeing with
  every counter; (b) the trace of phase 11a's migrated qwen3-0.6b stream,
  which ran traced there, bitwise the clean untraced stream; (c)
  ``plan_explain`` on phase 10a's qwen3 IOS; (d) the trace, decisions and
  gauges of phase 12a's guarded edge, which ran traced there, every response
  bitwise its untraced twin's; (e) the Chrome trace
  of (a) and (b) written to ``traces/phase13_trace.json`` and checked,
  and the host wall of a replayed qwen3 step with a tracer attached against
  detached, in turns.
* the replay soundness verifier (phase 14, after 12d): phase 12a's guarded
  edge and 12c's edge run with ``verify=True``, the fail-fast hooks proving
  every client's locked IOS (12a's twin runs without, and every response is
  bitwise the twin's); then (a) every pass and the aten op census over three
  full-width IOSes locked earlier in the run (12c's qwen3-0.6b stateful with
  phase 10a's plans, phase 5's zamba2-1.2b stateless with 10c's, phase 6's
  KAPAO with the planner's sweep), no ERROR diagnostic, each pass timed on
  the host; (b) three unsound copies of 12c's IOS refused before anything is
  built (a rotated window: RRTO101; a forged carried pair: RRTO204; a plan
  over n + 5 ops: RRTO301, with RRTO305 for its cache key); (c)
  ``python -m repro_torch.analysis --all-registry`` in process on the card,
  its JSON report in ``traces/phase14_analysis.json``.
* training (phase 15, last; phase 2 also holds the three backward kernels
  against their plain versions, two launches bitwise equal, and times them
  beside the library's autograd backward where there is one): (a) one step
  of a reduced qwen3-0.6b, minicpm3-4b, zamba2-1.2b, xlstm-1.3b,
  whisper-base and llava-next-34b in f32 and bf16, every gradient leaf on the card against the CPU, then reduced
  zamba2 through the trainer straight, crashed and resumed (bitwise); (b)
  full-width qwen3-0.6b trained 4 steps at 4 x 512 tokens through
  ``repro_torch.launch.train.main``: straight, crashed after step 2 with
  asynchronous checkpoints every 2 steps, and resumed, the resumed final
  loss equal to the straight one; (c) 6 steps on one fixed batch, the loss
  falling at each, timed with and without ``remat`` against the step's
  bound; (d) the bf16 flash backward held call by call against the
  emulation of its roundings; (e) full-width zamba2-1.2b at 4 x 512 tokens
  through the trainer and on one batch, with and without ``remat``, one
  step profiled; (f) full-width xlstm-1.3b on one batch of 1 x 512 tokens,
  every wide scan backward call of one step held against the plain
  backward; (g) mixtral-8x7b at full width and 2 of its 32 layers, 3 steps
  with ``remat`` on one batch of 4 x 512 tokens, the loss falling at each,
  ms a step against two bounds (the experts top-2 routing needs, the
  static dispatch's E x C rows), the flash and rmsnorm backward launches
  by shape.  15a also holds reduced mixtral-8x7b and llama4-maverick on the
  card against the CPU, trains reduced mixtral through the trainer
  straight, crashed and resumed (bitwise), and launches one of its steps
  twice (bitwise).  Phase 2 holds and times the flash backward at
  mixtral's training shape and the rmsnorm backward at (2048, 4096), and
  times the plain int8 decode attention.  No plain version of the training
  path's kernels may run on a CUDA tensor there.
* the sharding layer (phase 19, in the second process after phase 7, at
  world size 1: the card's one H100 moves no traffic between cards): (a)
  full-width qwen3-0.6b through ``repro_torch.launch.serve.main``, prompt
  8 and 8 new tokens, ``--system local`` and ``--system rrto`` (tokens
  equal, 3 RPCs for the last token, replaying), rmsnorm, decode attention
  and flash attention launched; (b) a one-rank NCCL group over a
  ``FileStore`` and a (1, 1) ("data", "model") mesh: ``compressed_psum``
  of the 151,936 x 1,024 embedding in f32 bitwise ``dequantize(quantize(x))``
  and its error feedback ``x`` minus that, ``_sp_decode_attention`` in bf16
  within 2e-3 of the decode kernel at qwen3's step shape over a
  32,768-key cache with a window, and the shard-local MoE dispatch of one
  full-width mixtral-8x7b layer, its output and the gradients of x and the
  router, within the bf16 tolerance of the global dispatch (bitwise
  printed); (c) ``restore(shardings=)`` of a qwen3-0.6b
  parameter checkpoint onto the mesh, bitwise the saved tree; the group is
  destroyed before the phase ends.
* the dry run held against the card (phase 20): the second process, once
  phase 19 is done, traces with ``repro_torch.launch.dryrun`` on ``cuda``
  (fake tensors: nothing allocated) the steps of 15c with and without
  remat, 15e with and without, 15g, and one qwen3-0.6b ``decode_step`` at
  phase 3's served shape; after phase 15 the main process runs that
  decode step once, and each trace's launches a step must equal the
  card's exactly, and its predicted peak (the step run on fake tensors
  with eager lifetimes, the arguments live throughout, plus what was
  allocated before the step) must lie within 2% of
  ``torch.cuda.max_memory_allocated()``; the largest buffers at the
  predicted peaks of 15e and 15g are printed.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after (every batched call under ``no_vmap_fallback``, so an op
without a batching rule fails the run); each path's replayed step is also
timed as one CUDA graph, and the zamba2 and KAPAO steps' device time is read
by kernel with ``torch.profiler``.  Any failed check exits non-zero.  The last two lines of standard output are
the kernel table and the device, as JSON.
"""
from __future__ import annotations

import dataclasses
import gc
import json
from collections import Counter
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # tests/test_kernels.py
RMSNORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# prefill (flash attention, M=32 products) vs token-by-token decode (decode
# attention, M=1 products) round differently in bf16 through 28 layers; the
# last-position logits must agree to within 5% of their largest magnitude
# (and each bf16 path with the f32 logits of the same weights).  zamba2's 38
# Mamba2 layers drift further in bf16 in the reference itself: its prefill
# rounds the conv output to bf16 where its decode step keeps it in f32, so its
# two paths err in different directions (the port drifts as the reference
# does: tests/test_torch_hybrid.py::test_bf16_drift_matches_the_reference);
# its f32 check is what holds the path
LOGIT_REL_TOL = 0.05
HYBRID_LOGIT_REL_TOL = 0.10
# Depth: the qwen3 prompt feeds seven stateful streams (phases 3, 10b, 11a's
# four, 12c), a replayed step each per prompt token, so it is kept at 16;
# minicpm3 and xlstm take 6 new tokens (3 recorded, 3 replayed when
# stateless).  Every check holds at these depths; the run stays well inside
# its time limit
PROMPT_LEN, NEW_TOKENS, BUCKET = 32, 32, 512       # qwen3-0.6b
Z_PROMPT, Z_NEW, Z_BUCKET, Z_STATELESS_BUCKET = 16, 16, 128, 64   # zamba2-1.2b
M_PROMPT, M_NEW, M_BUCKET = 16, 6, 64           # minicpm3-4b, stateful and stateless
X_PROMPT, X_NEW, X_BUCKET = 8, 6, 64            # xlstm-1.3b stateful (no bucket: recurrent state)
X_STATELESS_PROMPT = 16                         # xlstm-1.3b stateless, bucket 64
# MLA's flash call (minicpm3-4b: 40 heads of nope 64 + rope 32) and the
# mLSTM scan (xlstm-1.3b: 4 heads, N = 1024 keys, P = 1025 values with the
# normalizer column)
MLA_HEADS, MLA_D = 40, 96
MLSTM_HEADS, MLSTM_N = 4, 1024
LONG_KV = 16384     # the long decode row: K/V of 67 MB, more than the 50 MB L2
# mixtral-8x7b (phase 16a): full width, 8 of its 32 layers (the card's 80 GB
# beside the main process, and the run's time limit); 32 query heads on 8 KV
# heads of 128, a sliding window of 4096; prompt 16, 6 new tokens, bucket 64
MIX_LAYERS, MIX_PROMPT, MIX_NEW, MIX_BUCKET = 8, 16, 6, 64
MIX_HEADS, MIX_KV_HEADS, MIX_WINDOW = 32, 8, 4096
# whisper-base (phase 17a-b): full width, 1,500 encoder frames from the seed,
# 8 heads of 64; a 4-token prompt and 8 new tokens, the self cache's bucket
# 64; training on one batch of 2 x (1,500 frames, 448 tokens), 4 steps with
# and without remat
W_PROMPT, W_NEW, W_BUCKET = 4, 8, 64
W_HEADS, W_D, W_FRAMES = 8, 64, 1500
W_TRAIN_BATCH, W_TRAIN_DEC, W_TRAIN_STEPS = 2, 448, 4
# llava-next-34b (phase 17c): full width, 8 of its 60 layers (all 60 are
# 68.8 GB in bf16 by the config's shapes, more than the card holds beside
# the main process), 576 patches, 56 query heads on 8 KV heads of 128
# (n_rep 7); a 16-token prompt and 6 new tokens, the served bucket 64; the
# f32 logit check on its first 2 layers
L_LAYERS, L_PATCHES, L_PROMPT, L_NEW, L_BUCKET = 8, 576, 16, 6, 64
L_HEADS, L_KV_HEADS, L_F32_LAYERS = 56, 8, 2
# mixtral-8x7b trained (phase 15g): full width, 2 of its 32 layers (bf16
# weights and gradients and f32 AdamW moments of 3.17 G params; a 60.6 GB
# peak on the card, so it runs last, alone), one
# fixed batch of 4 x 512 tokens, 3 steps with remat; its flash backward at
# q/dO (4,512,32,128) on K/V (4,512,8,128) and its rmsnorm backward at
# (2048, 4096) are phase 2 rows
MIX_TRAIN_LAYERS, MIX_TRAIN_BATCH, MIX_TRAIN_SEQ, MIX_TRAIN_STEPS = 2, 4, 512, 3
# phase 18: (a) qwen3-0.6b with the int8 KV cache, phase 3's prompt and
# bucket, 8 new tokens; (b) mixtral-8x7b at MIX_LAYERS layers (phase 16's
# weights), 2 clients stateful then 2 stateless, bucket 64
Q8_NEW = 8
MIX_MT_CLIENTS, MIX_MT_PROMPTS, MIX_MT_NEW = 2, (5, 6), 6
KAPAO_SIZE, KAPAO_INFERS = 640, 7
# the other CNNs at the reference's benchmark sizes: Fig. 12's torchvision
# set, VGG16 for Fig. 1, and the sensor models of the partitioning runs
ZOO_SIZES = {
    "resnet50": 224, "convnext_tiny": 224, "fcn_resnet50": 384, "deeplabv3_resnet50": 384,
    "fasterrcnn_resnet50": 384, "retinanet_resnet50": 384, "vgg16": 224,
    "sensor_encoder": 96, "recurrent_sensor_decoder": 96,
}
ZOO_INFERS = 6
# Tab. III, loop column (benchmarks/tab3_rpc_composition.py)
TAB3_LOOP = {"cudaGetDevice": 4735, "cudaGetLastError": 607, "cudaLaunchKernel": 522,
             "cudaMalloc": 0, "cudaStreamSynchronize": 11, "cudaMemcpyHtoD": 3,
             "cudaMemcpyDtoH": 8, "cudaMemcpyDtoD": 9}
# rmsnorm's served shapes (rows, d): qwen3's d_model at decode, its q- and
# k-norm rows, zamba2's d_model and gated-norm width at decode, qwen3's
# 32-token prefill and the stateless bucket's 64 rows of d_inner; then
# minicpm3's d_model, q latent and kv latent at decode, its stateless
# bucket's 64 rows of d_model, and xLSTM's 64 rows of d_model
RMSNORM_SHAPES = [(1, 1024), (16, 128), (8, 128), (1, 2048), (1, 4096), (32, 1024), (64, 4096),
                  (1, 2560), (1, 768), (1, 256), (64, 2560), (64, 2048)]
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:26",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:94",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:111",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:92",
    # the gradients JAX's AD takes through the two kernels' bodies
    "rmsnorm_backward": "src/repro/kernels/rmsnorm/kernel.py:26",
    "flash_attention_backward": "src/repro/kernels/flash_attention/kernel.py:111",
    "ssm_scan_backward": "src/repro/kernels/ssm_scan/kernel.py:92",
}
# the backward kernels' shapes on the training path (rows, d): qwen3-0.6b's
# d_model at batch 4 x 512 tokens, its q- and k-norm rows, a ragged 5 x 13
# rows of 130, minicpm3's d_model, and its q and kv latents, mixtral-8x7b's
# d_model (and zamba2-1.2b's d_inner) at 4 x 512 tokens, zamba2's d_model at
# 4 x 512 and xlstm-1.3b's 4096-wide rows at 1 x 512; the timed ones with
# what they are
RMSNORM_BWD_SHAPES = [(2048, 1024), (32768, 128), (16384, 128), (65, 130), (64, 2560),
                      (2048, 768), (2048, 256), (2048, 4096), (2048, 2048), (512, 4096)]
RMSNORM_BWD_TIMED = {(2048, 1024): "qwen3-0.6b's d_model rows at 4 x 512 tokens",
                     (32768, 128): "qk-norm rows", (16384, 128): "qk-norm rows",
                     (2048, 4096): "mixtral-8x7b's d_model, zamba2-1.2b's d_inner rows at "
                                   "4 x 512 tokens",
                     (2048, 2048): "zamba2-1.2b's d_model rows at 4 x 512 tokens",
                     (512, 4096): "xlstm-1.3b's 4096-wide rows at 1 x 512 tokens"}
# dscale sums every row in another order than the plain version (f32: 2e-4
# beside the rows' 1e-5), and bf16 rounds dx and dscale once (2e-2)
RMSNORM_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# (B, Sq, Sk, Hq, Hkv, D), options: qwen3-0.6b's training shape, MLA's
# d = 96, mixtral-8x7b's training shape (its window wider than the
# sequence), then ragged lengths at n_rep 1 / 2 / 4, a window, a soft-cap
# and a q_offset; tolerance TOL: the kernel sums over key and query tiles in
# another order, and bf16 rounds the products' inputs and the outputs.  The
# first three are timed (causal: SDPA's mask is the same function)
FLASH_BWD_CASES = [
    ((4, 512, 512, 16, 8, 128), dict(causal=True)),
    ((1, 64, 64, 40, 40, 96), dict(causal=True)),
    ((4, 512, 512, 32, 8, 128), dict(causal=True, window=4096)),
    ((2, 77, 77, 8, 8, 64), dict(causal=True)),
    ((1, 100, 130, 8, 4, 128), dict(causal=False)),
    ((2, 45, 77, 8, 2, 64), dict(causal=True, q_offset=32, window=16, logit_cap=30.0)),
    ((1, 70, 70, 4, 4, 32), dict(causal=True, logit_cap=20.0)),
    ((1, 128, 384, 4, 1, 64), dict(causal=True, q_offset=256)),
    ((1, 200, 200, 8, 2, 128), dict(causal=True, window=50)),
]
# the bf16 flash backward within this relative L2 of the plain emulation
# of its roundings (ref.py:attention_backward_bf16_products), gradient by
# gradient: both lie ~2e-3 from the f32 gradients, and apart only by sum
# orders and a few flipped bf16 roundings
BWD_EMULATION_TOL = 1e-3
# phase 15: full-width qwen3-0.6b through the trainer's entry point
TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--batch", "4", "--seq", "512", "--steps", "4",
              "--log-every", "1", "--device", "cuda"]
TRAIN_CKPT = ["--ckpt-every", "2"]
TRAIN_KILL_AT = 2
FIXED_STEPS = 6            # part c: steps on one batch, the loss falling at each
NO_REMAT_STEPS = 3         # part c: steps without remat (the first not timed)
FIXED_LR = 1e-3
TRAIN_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_backward", "flash_attention_backward")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def capture(fn, reps: int) -> "torch.cuda.CUDAGraph":
    """``reps`` calls of ``fn`` captured in one CUDA graph, replayed once."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed and timed with CUDA events (launch overhead of the host is not
    in the number; L2 is warm, as it is for the main path's operands)."""
    g = capture(fn, reps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def eager_ms(fn, reps: int = 20) -> float:
    """Wall time of one call, launched eagerly ``reps`` times after one
    warm call, between two CUDA events (for paths a graph cannot capture,
    such as a collective's)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


MISMATCHES = []    # phase 2 holds every case, then fails if any disagreed


def close(out, ref, tol, floor=0.0) -> float:
    err = (out.float() - ref.float()).abs()
    bad = err > tol + floor + tol * ref.float().abs()
    if bool(bad.any()):
        at = tuple(int(i) for i in torch.nonzero(bad)[0])
        msg = (f"max |d| {err.max().item():.3g} over tolerance {tol}"
               f"{f' + floor {floor:.3g}' if floor else ''}; {int(bad.sum())} of "
               f"{bad.numel()} values, first at {at} of {tuple(out.shape)}")
        print(f"MISMATCH: {msg}", flush=True)
        MISMATCHES.append(msg)
    return err.max().item()


# the scan backward's gradients are held element by element against the
# plain backward within TOL plus this many times the distance that f32
# rounding alone moves the plain backward by (its f32 run against its f64
# run on the same inputs): where terms of ~10^3 cancel to small values, no
# relative tolerance holds either f32 result (PERF.md, PR 25)
ROUNDING_FLOOR = 4.0
SCAN_GRADS = ("dx", "dld", "dgi", "dB", "dC", "dD", "dh0")
# the bf16 kernel against the mirror of its roundings
# (``gated_scan_backward_mma_ref``), ``mirror_distances``: its f32 outputs
# (dld, dgi, dD, dh0) element by element, |d| / (rms(mirror) + |mirror|);
# its bf16 outputs (dx, dB, dC) by relative L2 to the mirror rounded to
# bf16 as the kernel rounds them.  Set from the readings of
# tools/scan_backward_terms.py (PERF.md, PR 26): the kernel reads at most
# MIRROR_TOL / 10 on every case, a variant that drops the second bf16 term
# of every split operand reads above it
MIRROR_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-3}


def mirror_distances(grads, mirror) -> dict:
    """Each gradient's distance to the mirror of the bf16 kernel's
    roundings, in the measure ``MIRROR_TOL`` holds for its dtype."""
    out = {}
    for name, got, ref in zip(SCAN_GRADS, grads, mirror):
        if ref is None:   # the op returns an empty dD or dh0 where D or h0 is None
            continue
        if got.dtype == torch.float32:
            ref = ref.double()
            scale = float(ref.pow(2).mean().sqrt()) + ref.abs()
            out[name] = float(((got.double() - ref).abs() / scale).max())
        else:
            out[name] = rel_l2(got, ref.to(got.dtype))
    return out


def hold_scan_backward(grads, refs, args, tol, mirror=None) -> tuple:
    """The scan backward kernel's ``grads`` against the plain backward's
    ``refs`` on the same ``args``: each gradient within ``tol`` + tol |ref|
    + ``ROUNDING_FLOOR`` x its rounding (``close``), where its rounding is
    max |d| between the plain version in f32 and in f64
    (``gated_scan_backward_witness``); with ``mirror`` (the plain mirror of
    the bf16 kernel's roundings, ``gated_scan_backward_mma_ref``, in f32)
    each gradient is also held within ``MIRROR_TOL`` of it
    (``mirror_distances``).  Returns (max |d| against the plain backward,
    readings): per gradient its rounding, the kernel's max |d| to the f64
    gradient (and its distance to the mirror), and the elements over
    ``tol`` + tol |ref| alone with, at those, the largest distance to the
    f64 gradient of the kernel and of the plain version in f32."""
    from repro_torch.kernels.ssm_scan import gated_scan_backward_witness

    lo, hi = gated_scan_backward_witness(*args)
    to_mirror = mirror_distances(grads, mirror) if mirror is not None else {}
    err, readings = 0.0, []
    for name, got, ref, f32, f64 in zip(SCAN_GRADS, grads, refs, lo, hi):
        if ref is None:
            continue
        rounding = float((f32.double() - f64).abs().max())
        err = max(err, close(got, ref, tol, floor=ROUNDING_FLOOR * rounding))
        if name in to_mirror:
            m_tol = MIRROR_TOL[got.dtype]
            if not to_mirror[name] <= m_tol:
                msg = f"{name} {to_mirror[name]:.3g} from the mirror of its roundings, over {m_tol}"
                print(f"MISMATCH: {msg}", flush=True)
                MISMATCHES.append(msg)
            name = f"{name} (mirror {to_mirror[name]:.3g})"
        over = (got.float() - ref.float()).abs() > tol + tol * ref.float().abs()
        n = int(over.sum())
        k64 = float((got.double() - f64).abs()[over].max()) if n else 0.0
        p64 = float((f32.double() - f64).abs()[over].max()) if n else 0.0
        kernel = float((got.double() - f64).abs().max())
        readings.append(f"{name} {rounding:.3g} / {kernel:.3g}" + (
            f" ({n} over: kernel {k64:.3g}, plain {p64:.3g} from f64)" if n else ""))
    return err, readings


def phase_kernels(dev):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_dense, flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plan, rmsnorm_ref

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rows, extra = {}, []
    # ---- rmsnorm: decode (d_model, qk-norm heads), prefill, ragged, offset;
    # every route: warp (d <= 1024), block (2048, 4096, many rows), scalar
    # (130, a row too long for the block route, and an unaligned view)
    for shape, offset in [((1, 1, 1024), 0.0), ((1, 1, 16, 128), 0.0),
                          ((1, 1, 8, 128), 0.0), ((1, 32, 1024), 0.0),
                          ((3, 7, 96), 0.0), ((2, 64, 512), 1.0), ((1, 1, 2048), 0.0),
                          ((1, 1, 4096), 1.0), ((1, 64, 4096), 0.0), ((1, 64, 2048), 0.0),
                          ((5, 13, 130), 0.0), ((2, 3, 20000), 0.0), ((1, 1, 2560), 0.0),
                          ((1, 1, 768), 0.0), ((1, 1, 256), 0.0), ((1, 64, 2560), 0.0)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*shape, dtype=dtype)
            w = (randn(shape[-1], dtype=torch.float32) * 0.1 + 1.0).to(dtype)
            out = rmsnorm(x, w, eps=1e-6, offset=offset)
            torch.cuda.synchronize()
            err = close(out, rmsnorm_ref(x, w, 1e-6, offset), RMSNORM_TOL[dtype])
            print(f"rmsnorm {shape} {dtype} offset={offset} "
                  f"({rmsnorm_plan(x.numel() // shape[-1], shape[-1], dtype)['route']}): "
                  f"max|d| {err:.3g} (tol {RMSNORM_TOL[dtype]})")
    for dtype in (torch.float32, torch.bfloat16):   # x 2 bytes past 16-byte alignment
        x = randn(2 * 1024 + 8, dtype=dtype)[1:1 + 2 * 1024].view(2, 1024)
        w = randn(1024, dtype=dtype)
        err = close(rmsnorm(x, w), rmsnorm_ref(x, w), RMSNORM_TOL[dtype])
        print(f"rmsnorm unaligned (2, 1024) {dtype} (scalar): max|d| {err:.3g}")
    for shape in RMSNORM_SHAPES:
        row = rmsnorm_row(randn, shape)
        if shape == RMSNORM_SHAPES[0]:
            rows["rmsnorm"] = row
        else:
            extra.append(dict(name="rmsnorm", **row))

    # ---- decode attention: the served step (S=512 bucket), ragged, window
    def dec_case(b, s, hq, hkv, d, lens, window, dtype):
        q = randn(b, hq, d, dtype=dtype)
        k = randn(b, s, hkv, d, dtype=dtype)
        v = randn(b, s, hkv, d, dtype=dtype)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        return q, k, v, kv_len, window

    # the served shapes and the first ragged ones, then split-KV cases: many
    # splits (up to 16), splits wholly masked (past kv_len, before a window),
    # windows across a split edge, kv_len 1 and S, and GQA groups of 4 and 8
    for args in [(1, 512, 16, 8, 128, [63], None), (1, 512, 16, 8, 128, [1], None),
                 (2, 1000, 8, 2, 64, [700, 37], 256), (3, 333, 40, 40, 64, [333, 5, 200], None),
                 (1, 100, 8, 1, 256, [99], None), (1, 77, 4, 4, 32, [77], 8),
                 (1, Z_BUCKET, 32, 32, 64, [Z_PROMPT + Z_NEW - 1], None),
                 (1, 4096, 16, 8, 128, [4000], None), (2, 1000, 32, 4, 64, [900, 1000], 100),
                 (1, 640, 64, 8, 128, [640], 200), (2, 300, 8, 8, 32, [1, 300], None),
                 (1, 2000, 8, 1, 256, [1999], 600), (1, 8192, 8, 2, 64, [8000], None),
                 (1, 1200, 16, 8, 128, [600], 200),
                 # mixtral's decode steps: n_rep 4, window 4096, kv_len 16-21
                 (6, MIX_BUCKET, MIX_HEADS, MIX_KV_HEADS, 128,
                  list(range(MIX_PROMPT, MIX_PROMPT + MIX_NEW)), MIX_WINDOW)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len, window = dec_case(*args, dtype)
            out = decode_attention(q, k, v, kv_len, window=window)
            torch.cuda.synchronize()
            err = close(out, decode_attention_ref(q, k, v, kv_len, window=window), TOL[dtype])
            print(f"decode_attention {args} {dtype}: max|d| {err:.3g} (tol {TOL[dtype]})")
    # the splits merge in a fixed order: two runs agree bit for bit
    q, k, v, kv_len, _ = dec_case(1, 4096, 16, 8, 128, [4000], None, torch.bfloat16)
    check(torch.equal(decode_attention(q, k, v, kv_len), decode_attention(q, k, v, kv_len)),
          "decode_attention: two runs differ")
    q, k, v, kv_len, _ = dec_case(1, 512, 16, 8, 128, [63], None, torch.bfloat16)
    err = close(decode_attention(q, k, v, kv_len), decode_attention_ref(q, k, v, kv_len),
                TOL[torch.bfloat16])
    n = 63
    nbytes = 2 * q.numel() * 2 + 2 * n * 8 * 128 * 2 + 4
    b_ms, b_by = bound_ms(nbytes, 4 * 16 * n * 128, torch.bfloat16)
    kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    rows["decode_attention"] = dict(
        shape="q (1,16,128), K/V (1,512,8,128) bf16, kv_len 63", max_abs_err=err,
        ms=graph_ms(lambda: decode_attention(q, k, v, kv_len)),
        plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, kv_len)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )
    # zamba2's shared-attention decode: 32 query heads on 32 KV heads, d 64
    n = Z_PROMPT + Z_NEW - 1
    q, k, v, kv_len, _ = dec_case(1, Z_BUCKET, 32, 32, 64, [n], None, torch.bfloat16)
    kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * n * 32 * 64 * 2 + 4,
                          4 * 32 * n * 64, torch.bfloat16)
    extra.append(dict(
        name="decode_attention", shape=f"q (1,32,64), K/V (1,{Z_BUCKET},32,64) bf16, kv_len {n}",
        ms=graph_ms(lambda: decode_attention(q, k, v, kv_len)),
        plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, kv_len)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt)),
        bound_ms=b_ms, bound_by=b_by,
    ))
    # a long cache: K/V (67 MB) exceed the 50 MB L2, so even the graph's
    # warm-L2 timing reads them from HBM
    n = LONG_KV - 1
    q, k, v, kv_len, _ = dec_case(1, LONG_KV, 16, 8, 128, [n], None, torch.bfloat16)
    kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * n * 8 * 128 * 2 + 4, 4 * 16 * n * 128,
                          torch.bfloat16)
    extra.append(dict(
        name="decode_attention", shape=f"q (1,16,128), K/V (1,{LONG_KV},8,128) bf16, kv_len {n}",
        ms=graph_ms(lambda: decode_attention(q, k, v, kv_len), reps=10),
        plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, kv_len), reps=10),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True), reps=10),
        bound_ms=b_ms, bound_by=b_by,
    ))
    # mixtral's last decode step: 32 query heads on 8 KV heads, window 4096
    n = MIX_PROMPT + MIX_NEW - 1
    q, k, v, kv_len, _ = dec_case(1, MIX_BUCKET, MIX_HEADS, MIX_KV_HEADS, 128, [n], None,
                                  torch.bfloat16)
    kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * n * MIX_KV_HEADS * 128 * 2 + 4,
                          4 * MIX_HEADS * n * 128, torch.bfloat16)
    extra.append(dict(
        name="decode_attention",
        shape=f"q (1,{MIX_HEADS},128), K/V (1,{MIX_BUCKET},{MIX_KV_HEADS},128) bf16, kv_len {n}, "
              f"window {MIX_WINDOW} (mixtral's step)",
        max_abs_err=close(decode_attention(q, k, v, kv_len, window=MIX_WINDOW),
                          decode_attention_ref(q, k, v, kv_len, window=MIX_WINDOW),
                          TOL[torch.bfloat16]),
        ms=graph_ms(lambda: decode_attention(q, k, v, kv_len, window=MIX_WINDOW)),
        plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, kv_len, window=MIX_WINDOW)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    ))
    del q, k, v, kt, vt
    kv_len_sweep(dec_case)

    # ---- flash attention: the served prefill, ragged/offset/window/cap, D=256
    def fl_case(b, sq, sk, hq, hkv, d, dtype):
        return (randn(b, sq, hq, d, dtype=dtype), randn(b, sk, hkv, d, dtype=dtype),
                randn(b, sk, hkv, d, dtype=dtype))

    for shape, kw in [((1, 32, 32, 16, 8, 128), dict(causal=True)),
                      ((1, 512, 512, 16, 8, 128), dict(causal=True)),
                      ((2, 45, 77, 4, 2, 64), dict(causal=True, q_offset=32, window=16,
                                                   logit_cap=30.0)),
                      ((1, 100, 100, 4, 4, 256), dict(causal=False)),
                      ((1, 128, 384, 4, 1, 64), dict(causal=True, q_offset=256)),
                      ((1, Z_PROMPT, Z_PROMPT, 32, 32, 64), dict(causal=True)),
                      ((1, Z_STATELESS_BUCKET, Z_STATELESS_BUCKET, 32, 32, 64),
                       dict(causal=True)),
                      # packed GQA rows (n_rep 2, 4, 8), ragged last tiles, D 32 and 256
                      ((1, 50, 50, 16, 8, 128), dict(causal=True)),
                      ((2, 45, 45, 16, 4, 64), dict(causal=True, window=20)),
                      ((1, 30, 94, 16, 2, 128), dict(causal=True, q_offset=64)),
                      ((1, 70, 70, 4, 2, 256), dict(causal=True, logit_cap=20.0)),
                      ((1, 33, 40, 8, 1, 32), dict(causal=False)),
                      ((1, 200, 200, 8, 2, 32), dict(causal=True, window=50)),
                      # MLA's head dim 96: the stateless bucket, the prefill,
                      # a ragged sequence and a non-causal one
                      ((1, M_BUCKET, M_BUCKET, MLA_HEADS, MLA_HEADS, MLA_D), dict(causal=True)),
                      ((1, M_PROMPT, M_PROMPT, MLA_HEADS, MLA_HEADS, MLA_D), dict(causal=True)),
                      ((2, 77, 77, 8, 8, MLA_D), dict(causal=True)),
                      ((1, 50, 70, 8, 4, MLA_D), dict(causal=False)),
                      # mixtral's prefill and stateless bucket: n_rep 4, window 4096
                      ((1, MIX_PROMPT, MIX_PROMPT, MIX_HEADS, MIX_KV_HEADS, 128),
                       dict(causal=True, window=MIX_WINDOW)),
                      ((1, MIX_BUCKET, MIX_BUCKET, MIX_HEADS, MIX_KV_HEADS, 128),
                       dict(causal=True, window=MIX_WINDOW))]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = fl_case(*shape, dtype)
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = close(out, attention_dense(q, k, v, **kw), TOL[dtype])
            print(f"flash_attention {shape} {kw} {dtype}: max|d| {err:.3g} (tol {TOL[dtype]})")
    q, k, v = fl_case(1, 32, 32, 16, 8, 128, torch.bfloat16)
    err = close(flash_attention(q, k, v), attention_dense(q, k, v), TOL[torch.bfloat16])
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    pairs = 32 * 33 / 2
    b_ms, b_by = bound_ms(nbytes, 4 * 16 * pairs * 128, torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows["flash_attention"] = dict(
        shape="q (1,32,16,128), K/V (1,32,8,128) bf16, causal", max_abs_err=err,
        ms=graph_ms(lambda: flash_attention(q, k, v)),
        plain_ms=graph_ms(lambda: attention_dense(q, k, v)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )
    # zamba2's prefill and stateless bucket: 32 heads of 64, rep 1
    for sq in (Z_PROMPT, Z_STATELESS_BUCKET):
        q, k, v = fl_case(1, sq, sq, 32, 32, 64, torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        b_ms, b_by = bound_ms(2 * 4 * q.numel(), 4 * 32 * sq * (sq + 1) / 2 * 64,
                              torch.bfloat16)
        extra.append(dict(
            name="flash_attention", shape=f"q/k/v (1,{sq},32,64) bf16, causal",
            ms=graph_ms(lambda: flash_attention(q, k, v)),
            plain_ms=graph_ms(lambda: attention_dense(q, k, v)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            bound_ms=b_ms, bound_by=b_by,
        ))

    # MLA at minicpm3-4b's stateless bucket: 40 heads of 96 (the wgmma route's
    # rows padded to two 64-column atoms), beside SDPA on the same q/k/v
    q, k, v = fl_case(1, M_BUCKET, M_BUCKET, MLA_HEADS, MLA_HEADS, MLA_D, torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b_ms, b_by = bound_ms(2 * 4 * q.numel(), 4 * MLA_HEADS * M_BUCKET * (M_BUCKET + 1) / 2 * MLA_D,
                          torch.bfloat16)
    extra.append(dict(
        name="flash_attention", shape=f"q/k/v (1,{M_BUCKET},{MLA_HEADS},{MLA_D}) bf16, causal",
        max_abs_err=close(flash_attention(q, k, v), attention_dense(q, k, v), TOL[torch.bfloat16]),
        ms=graph_ms(lambda: flash_attention(q, k, v)),
        plain_ms=graph_ms(lambda: attention_dense(q, k, v)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
    ))

    # mixtral's prefill and stateless bucket: 32 query heads on 8 KV heads,
    # window 4096 (wider than the sequence, so SDPA's causal mask is the
    # same function)
    for sq in (MIX_PROMPT, MIX_BUCKET):
        q, k, v = fl_case(1, sq, sq, MIX_HEADS, MIX_KV_HEADS, 128, torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()),
                              4 * MIX_HEADS * sq * (sq + 1) / 2 * 128, torch.bfloat16)
        extra.append(dict(
            name="flash_attention",
            shape=f"q (1,{sq},{MIX_HEADS},128), K/V (1,{sq},{MIX_KV_HEADS},128) bf16, causal, "
                  f"window {MIX_WINDOW} (mixtral's)",
            max_abs_err=close(flash_attention(q, k, v, window=MIX_WINDOW),
                              attention_dense(q, k, v, window=MIX_WINDOW), TOL[torch.bfloat16]),
            ms=graph_ms(lambda: flash_attention(q, k, v, window=MIX_WINDOW)),
            plain_ms=graph_ms(lambda: attention_dense(q, k, v, window=MIX_WINDOW)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by,
        ))

    # a long prefill with qwen3's heads: 16 tiles of 64 packed rows per KV head (128
    # blocks), up to 8 K/V tiles each
    q, k, v = fl_case(1, 512, 512, 16, 8, 128, torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), 4 * 16 * 512 * 513 / 2 * 128,
                          torch.bfloat16)
    extra.append(dict(
        name="flash_attention", shape="q (1,512,16,128), K/V (1,512,8,128) bf16, causal",
        ms=graph_ms(lambda: flash_attention(q, k, v)),
        plain_ms=graph_ms(lambda: attention_dense(q, k, v)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    ))

    profile_attention(dec_case, fl_case)

    rows["ssm_scan"], scan_extra = phase_scan(dev, randn)
    extra += scan_extra
    bwd_rows, bwd_extra = phase_backward_kernels(randn)
    rows.update(bwd_rows)
    extra += bwd_extra
    rows["ssm_scan_backward"], scan_bwd_extra = phase_scan_backward(randn)
    extra += scan_bwd_extra
    extra += phase_encdec_kernels(randn)
    q8_decode_lines(randn)
    for r in [dict(name=n, **r) for n, r in rows.items()] + extra:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"time {r['name']} [{r['shape']}]: kernel {r['ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, "
              f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return rows, extra


def rmsnorm_row(randn, shape) -> dict:
    """rmsnorm at one served shape in bf16: checked, then timed in turns
    with ``F.rms_norm`` (kernel, library, library, kernel: the mean of each
    pair) beside the plain version and the byte bound."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plan, rmsnorm_ref

    n, d = shape
    x = randn(*shape, dtype=torch.bfloat16)
    w = (randn(d, dtype=torch.float32) * 0.1 + 1.0).to(torch.bfloat16)
    err = close(rmsnorm(x, w), rmsnorm_ref(x, w), RMSNORM_TOL[torch.bfloat16])
    turns = [graph_ms(lambda: rmsnorm(x, w)), graph_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
             graph_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)), graph_ms(lambda: rmsnorm(x, w))]
    b_ms, b_by = bound_ms(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), torch.bfloat16)
    plan = rmsnorm_plan(n, d, torch.bfloat16)
    print(f"rmsnorm turns x {shape} bf16 ({plan['route']}, {plan['threads']} threads, grid "
          f"{plan['grid']}): kernel {turns[0] * 1e3:.2f} / {turns[3] * 1e3:.2f} us, "
          f"F.rms_norm {turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us")
    return dict(
        shape=f"x {shape} bf16 ({plan['route']})", max_abs_err=err,
        ms=(turns[0] + turns[3]) / 2, plain_ms=graph_ms(lambda: rmsnorm_ref(x, w)),
        library_ms=(turns[1] + turns[2]) / 2, bound_ms=b_ms, bound_by=b_by,
    )


def autograd_ms(fwd, inputs, cot, reps: int = 20) -> float:
    """Device time of a library call's backward alone: its forward and
    ``torch.autograd.grad`` together, less the forward, each a CUDA graph."""
    return (graph_ms(lambda: torch.autograd.grad(fwd(), inputs, cot), reps)
            - graph_ms(fwd, reps))


def check_flash_backward(randn, shape, kw) -> None:
    """The flash backward kernel at one case against its plain version (f32
    and bf16; bf16 also against the emulation of its roundings), two
    launches bitwise equal; a disagreement joins ``MISMATCHES``."""
    from repro_torch.kernels.flash_attention import (
        attention_chunked_backward,
        backward_plan,
        flash_attention,
        flash_attention_backward_op,
    )
    from repro_torch.kernels.flash_attention.ref import attention_backward_bf16_products

    bf = torch.bfloat16
    b, sq, sk, hq, hkv, d = shape
    args = (kw.get("causal", True), kw.get("window"), kw.get("logit_cap"),
            kw.get("q_offset", 0))
    for dtype in (torch.float32, bf):
        q, do = randn(b, sq, hq, d, dtype=dtype), randn(b, sq, hq, d, dtype=dtype)
        k, v = randn(b, sk, hkv, d, dtype=dtype), randn(b, sk, hkv, d, dtype=dtype)
        out = flash_attention(q, k, v, **kw)
        grads = flash_attention_backward_op(do, q, k, v, out, *args)
        torch.cuda.synchronize()
        refs = attention_chunked_backward(do, q, k, v, **kw)
        err = max(close(g, r, TOL[dtype]) for g, r in zip(grads, refs))
        same = all(torch.equal(a, c) for a, c in
                   zip(grads, flash_attention_backward_op(do, q, k, v, out, *args)))
        if not same:
            MISMATCHES.append(f"flash_attention_backward {(b, sq, sk, hq, hkv, d)} {kw} "
                              f"{dtype}: two launches differ")
        route = backward_plan(b, sq, sk, hq, hkv, d, dtype)["route"]
        note = ""
        if dtype == bf:   # the mma route against the emulation of its roundings
            rel = max(float((g.float() - e.float()).norm() / e.float().norm().clamp_min(1e-30))
                      for g, e in zip(grads, attention_backward_bf16_products(
                          do, q, k, v, out, **kw)))
            if not rel <= BWD_EMULATION_TOL:
                MISMATCHES.append(f"flash_attention_backward {(b, sq, sk, hq, hkv, d)} {kw}: "
                                  f"relative L2 {rel:.3g} from its rounding's emulation")
            note = f"; vs its rounding's emulation rel L2 {rel:.3g} (tol {BWD_EMULATION_TOL})"
        print(f"flash_attention_backward {(b, sq, sk, hq, hkv, d)} {kw} {dtype} ({route}): "
              f"dq/dk/dv max|d| {err:.3g} (tol {TOL[dtype]}); two launches bitwise {same}"
              f"{note}")
        del q, do, k, v, out, grads, refs


def phase_backward_kernels(randn) -> tuple:
    """The two backward kernels of the training path against their plain
    versions on the card (f32 and bf16, every case, each printed with its
    route; two launches bitwise equal), then each timed at its training
    shape beside its plain version, the library's autograd backward of the
    same function and the bound."""
    from repro_torch.kernels.flash_attention import (
        attention_chunked_backward,
        backward_plan,
        flash_attention,
        flash_attention_backward_op,
    )
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_backward_op,
        rmsnorm_backward_plan,
        rmsnorm_backward_ref,
    )

    def rms_route(n, d, dtype) -> str:
        plan = rmsnorm_backward_plan(n, d, dtype)
        return (f"{plan['route']}, {plan['lanes']} lanes x {plan['vecs']} vectors, grid "
                f"{plan['grid']}")

    def rms_turns(fn, lib) -> list:
        # kernel, library, library, kernel
        return [graph_ms(fn), autograd_ms(*lib), autograd_ms(*lib), graph_ms(fn)]

    bf = torch.bfloat16
    for shape in RMSNORM_BWD_SHAPES:
        offset = 1.0 if shape == (65, 130) else 0.0
        for dtype in (torch.float32, bf):
            x, dy = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            w = (randn(shape[-1], dtype=torch.float32) * 0.1 + 1.0).to(dtype)
            dx, dw = rmsnorm_backward_op(dy, x, w, 1e-6, offset)
            torch.cuda.synchronize()
            rx, rw = rmsnorm_backward_ref(dy, x, w, 1e-6, offset)
            tol = RMSNORM_BWD_TOL[dtype]
            err = max(close(dx, rx, tol), close(dw, rw, tol))
            dx2, dw2 = rmsnorm_backward_op(dy, x, w, 1e-6, offset)
            same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
            if not same:
                MISMATCHES.append(f"rmsnorm_backward {shape} {dtype}: two launches differ")
            print(f"rmsnorm_backward {shape} {dtype} offset={offset} "
                  f"({rms_route(*shape, dtype)}): max|d| {err:.3g} (tol {tol}); two launches "
                  f"bitwise {same}")
    for shape, kw in FLASH_BWD_CASES:
        check_flash_backward(randn, shape, kw)

    rows, extra = {}, []
    for i, ((n, d), what) in enumerate(RMSNORM_BWD_TIMED.items()):
        x, dy = randn(n, d, dtype=bf), randn(n, d, dtype=bf)
        w = (randn(d, dtype=torch.float32) * 0.1 + 1.0).to(bf)
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        b_ms, b_by = bound_ms(3 * x.numel() * 2 + 2 * d * 2, 10 * x.numel(), bf)
        turns = rms_turns(lambda: rmsnorm_backward_op(dy, x, w, 1e-6, 0.0),
                          (lambda: F.rms_norm(xg, (d,), wg, 1e-6), (xg, wg), dy))
        print(f"rmsnorm_backward turns ({n},{d}) bf16 ({rms_route(n, d, bf)}): kernel "
              f"{turns[0] * 1e3:.2f} / {turns[3] * 1e3:.2f} us, F.rms_norm backward "
              f"{turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us; bound {b_ms * 1e3:.3f} us")
        row = dict(
            shape=f"dy, x ({n},{d}) bf16 ({what}; {rms_route(n, d, bf)})",
            max_abs_err=max(close(a, r, RMSNORM_BWD_TOL[bf]) for a, r in
                            zip(rmsnorm_backward_op(dy, x, w, 1e-6, 0.0),
                                rmsnorm_backward_ref(dy, x, w, 1e-6, 0.0))),
            ms=(turns[0] + turns[3]) / 2,
            plain_ms=graph_ms(lambda: rmsnorm_backward_ref(dy, x, w, 1e-6, 0.0)),
            library_ms=(turns[1] + turns[2]) / 2, bound_ms=b_ms, bound_by=b_by)
        if i == 0:
            rows["rmsnorm_backward"] = row
        else:
            extra.append(dict(name="rmsnorm_backward", **row))

    for (b, sq, sk, hq, hkv, d), kw in FLASH_BWD_CASES[:3]:
        q, do = randn(b, sq, hq, d, dtype=bf), randn(b, sq, hq, d, dtype=bf)
        k, v = randn(b, sk, hkv, d, dtype=bf), randn(b, sk, hkv, d, dtype=bf)
        out = flash_attention(q, k, v, **kw)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)
        pairs = sq * (sq + 1) / 2
        # the bound: q, k, v, o, dO read and dq, dk, dv written once; 2.5 x
        # the forward's causal flops (the backward recomputes Q K^T)
        b_ms, b_by = bound_ms(2 * (4 * q.numel() + 4 * k.numel()),
                              2.5 * 4 * b * hq * pairs * d, bf)
        route = backward_plan(b, sq, sk, hq, hkv, d, bf)["route"]

        def kern():
            return flash_attention_backward_op(do, q, k, v, out, True, kw.get("window"), None, 0)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        # kernel, SDPA's backward, SDPA's backward, kernel
        turns = [graph_ms(kern, reps=5), autograd_ms(lib, (qt, kt, vt), dot, reps=5),
                 autograd_ms(lib, (qt, kt, vt), dot, reps=5), graph_ms(kern, reps=5)]
        print(f"flash_attention_backward turns ({b},{sq},{hq},{d}) bf16 ({route}): kernel "
              f"{turns[0] * 1e3:.2f} / {turns[3] * 1e3:.2f} us, SDPA backward "
              f"{turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us")
        window = f", window {kw['window']}" if "window" in kw else ""
        row = dict(
            shape=f"q/dO ({b},{sq},{hq},{d}), K/V ({b},{sk},{hkv},{d}) bf16, causal{window} "
                  f"({route})",
            max_abs_err=max(close(g, r, TOL[bf]) for g, r in zip(
                kern(), attention_chunked_backward(do, q, k, v, **kw))),
            ms=(turns[0] + turns[3]) / 2,
            plain_ms=graph_ms(lambda: attention_chunked_backward(do, q, k, v, **kw), reps=5),
            library_ms=(turns[1] + turns[2]) / 2, bound_ms=b_ms, bound_by=b_by)
        if "flash_attention_backward" not in rows:
            rows["flash_attention_backward"] = row
        else:
            extra.append(dict(name="flash_attention_backward", **row))
        del q, do, k, v, out, qt, kt, vt, dot
    return rows, extra


def phase_encdec_kernels(randn) -> list:
    """Phase 2's shapes of the encoder-decoder and patch-prefix paths (phase
    17), each held in f32 and bf16 against its plain version (a
    disagreement joins ``MISMATCHES``): flash attention with no mask over
    whisper's 1,500 frames (a ragged last key tile: 1500 = 23 x 64 + 28)
    and across from the decoder's queries to them; llava's causal prefill
    of 576 patches and 16 tokens, whose 56 query heads on 8 KV heads
    (n_rep 7) put parts of two queries' groups in one 64-row tile; decode
    attention over the 1,500-key cross cache (three splits, the last
    ragged) and at n_rep 7; the flash backward at whisper's training shapes
    (no mask, and across). Then the bf16 rows timed beside the plain
    version, SDPA (its backward for the backward rows) and the bound."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import (
        attention_chunked_backward,
        attention_dense,
        backward_plan,
        flash_attention,
        flash_attention_backward_op,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    w, l_seq = W_FRAMES, L_PATCHES + L_PROMPT
    for (b, sq, sk, hq, hkv, d), kw in [
            ((1, w, w, W_HEADS, W_HEADS, W_D), dict(causal=False)),
            ((1, 7, w, W_HEADS, W_HEADS, W_D), dict(causal=False)),
            ((W_TRAIN_BATCH, W_TRAIN_DEC, w, W_HEADS, W_HEADS, W_D), dict(causal=False)),
            ((1, l_seq, l_seq, L_HEADS, L_KV_HEADS, 128), dict(causal=True)),
            ((2, 45, 45, L_HEADS, L_KV_HEADS, 128), dict(causal=True)),
            ((1, 30, 70, 14, 2, 64), dict(causal=True, q_offset=40, window=25))]:
        for dtype in (torch.float32, bf):
            q, k, v = (randn(b, n, h, d, dtype=dtype) for n, h in ((sq, hq), (sk, hkv), (sk, hkv)))
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = close(out, attention_dense(q, k, v, **kw), TOL[dtype])
            print(f"flash_attention {(b, sq, sk, hq, hkv, d)} {kw} {dtype}: max|d| {err:.3g} "
                  f"(tol {TOL[dtype]})")
    for b, s, hq, hkv, d, lens, window in [
            (1, w, W_HEADS, W_HEADS, W_D, [w], None),
            (2, w, W_HEADS, W_HEADS, W_D, [w, w], None),
            (1, W_BUCKET, W_HEADS, W_HEADS, W_D, [W_PROMPT + W_NEW - 1], None),
            (1, L_BUCKET, L_HEADS, L_KV_HEADS, 128, [L_PROMPT + L_NEW - 1], None),
            (1, l_seq + L_NEW, L_HEADS, L_KV_HEADS, 128, [l_seq + L_NEW - 1], None),
            (3, 700, L_HEADS, L_KV_HEADS, 128, [700, 1, 350], 100)]:
        for dtype in (torch.float32, bf):
            q, k, v = randn(b, hq, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype), \
                randn(b, s, hkv, d, dtype=dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = decode_attention(q, k, v, kv_len, window=window)
            torch.cuda.synchronize()
            err = close(out, decode_attention_ref(q, k, v, kv_len, window=window), TOL[dtype])
            print(f"decode_attention {(b, s, hq, hkv, d, lens, window)} {dtype}: max|d| "
                  f"{err:.3g} (tol {TOL[dtype]})")
    for shape, kw in [((1, w, w, W_HEADS, W_HEADS, W_D), dict(causal=False)),
                      ((1, 7, w, W_HEADS, W_HEADS, W_D), dict(causal=False)),
                      ((W_TRAIN_BATCH, W_TRAIN_DEC, w, W_HEADS, W_HEADS, W_D),
                       dict(causal=False)),
                      ((W_TRAIN_BATCH, W_TRAIN_DEC, W_TRAIN_DEC, W_HEADS, W_HEADS, W_D),
                       dict(causal=True)),
                      ((1, 45, 45, 14, 2, 64), dict(causal=True))]:
        check_flash_backward(randn, shape, kw)

    rows = []
    # flash forward: whisper's encoder (no mask), its 4-token prompt across
    # to the 1,500 frames, llava's prefill (causal, n_rep 7)
    for (b, sq, sk, hq, hkv, d), causal, what in [
            ((1, w, w, W_HEADS, W_HEADS, W_D), False, "whisper's encoder, no mask"),
            ((1, W_PROMPT, w, W_HEADS, W_HEADS, W_D), False,
             "whisper's prompt across to the encoder, no mask"),
            ((1, l_seq, l_seq, L_HEADS, L_KV_HEADS, 128), True,
             "llava's prefill of 576 patches + 16 tokens, causal, n_rep 7")]:
        q, k, v = (randn(b, n, h, d, dtype=bf) for n, h in ((sq, hq), (sk, hkv), (sk, hkv)))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), 4 * b * hq * pairs * d, bf)
        rows.append(dict(
            name="flash_attention",
            shape=f"q ({b},{sq},{hq},{d}), K/V ({b},{sk},{hkv},{d}) bf16 ({what})",
            max_abs_err=close(flash_attention(q, k, v, causal=causal),
                              attention_dense(q, k, v, causal=causal), TOL[bf]),
            ms=graph_ms(lambda: flash_attention(q, k, v, causal=causal)),
            plain_ms=graph_ms(lambda: attention_dense(q, k, v, causal=causal), reps=10),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=hq != hkv)),
            bound_ms=b_ms, bound_by=b_by))
    # decode attention: the cross cache of 1,500 keys; llava's served step
    for s, hq, hkv, d, n, what in [(w, W_HEADS, W_HEADS, W_D, w, "whisper's cross cache"),
                                   (L_BUCKET, L_HEADS, L_KV_HEADS, 128, L_PROMPT + L_NEW - 1,
                                    "llava's step, n_rep 7")]:
        q, k, v = randn(1, hq, d, dtype=bf), randn(1, s, hkv, d, dtype=bf), \
            randn(1, s, hkv, d, dtype=bf)
        kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
        kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
        b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * n * hkv * d * 2 + 4, 4 * hq * n * d, bf)
        rows.append(dict(
            name="decode_attention",
            shape=f"q (1,{hq},{d}), K/V (1,{s},{hkv},{d}) bf16, kv_len {n} ({what})",
            max_abs_err=close(decode_attention(q, k, v, kv_len),
                              decode_attention_ref(q, k, v, kv_len), TOL[bf]),
            ms=graph_ms(lambda: decode_attention(q, k, v, kv_len)),
            plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, kv_len)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, enable_gqa=hq != hkv)),
            bound_ms=b_ms, bound_by=b_by))
    # flash backward at whisper's training shapes: the encoder's self
    # attention and the decoder's queries across to the frames, no mask
    for b, sq, sk in ((W_TRAIN_BATCH, w, w), (W_TRAIN_BATCH, W_TRAIN_DEC, w)):
        h, d = W_HEADS, W_D
        q, do = randn(b, sq, h, d, dtype=bf), randn(b, sq, h, d, dtype=bf)
        k, v = randn(b, sk, h, d, dtype=bf), randn(b, sk, h, d, dtype=bf)
        out = flash_attention(q, k, v, causal=False)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)
        b_ms, b_by = bound_ms(2 * (4 * q.numel() + 4 * k.numel()), 2.5 * 4 * b * h * sq * sk * d,
                              bf)
        route = backward_plan(b, sq, sk, h, h, d, bf)["route"]

        def kern():
            return flash_attention_backward_op(do, q, k, v, out, False, None, None, 0)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt)

        turns = [graph_ms(kern, reps=5), autograd_ms(lib, (qt, kt, vt), dot, reps=5),
                 autograd_ms(lib, (qt, kt, vt), dot, reps=5), graph_ms(kern, reps=5)]
        rows.append(dict(
            name="flash_attention_backward",
            shape=f"q/dO ({b},{sq},{h},{d}), K/V ({b},{sk},{h},{d}) bf16, no mask ({route}; "
                  f"whisper's {'encoder' if sq == sk else 'cross attention'} in training)",
            max_abs_err=max(close(g, r, TOL[bf]) for g, r in zip(
                kern(), attention_chunked_backward(do, q, k, v, causal=False))),
            ms=(turns[0] + turns[3]) / 2,
            plain_ms=graph_ms(lambda: attention_chunked_backward(do, q, k, v, causal=False),
                              reps=5),
            library_ms=(turns[1] + turns[2]) / 2, bound_ms=b_ms, bound_by=b_by))
        del q, do, k, v, out, qt, kt, vt, dot
    return rows


def q8_decode_lines(randn) -> None:
    """The int8 cache's plain ``decode_attention_q8_ref`` (no kernel: the
    reference has none) at qwen3's step and over a 16k cache, held against
    the plain bf16 function on the dequantized cache and timed beside the
    bf16 kernel on the float cache it was quantized from, with its byte
    bound at int8 width (printed, not a kernel row)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_q8_ref,
        decode_attention_ref,
        quantize_kv,
    )

    bf = torch.bfloat16
    for s_len, kv in ((BUCKET, 63), (LONG_KV, LONG_KV - 1)):
        q = randn(1, 16, 128, dtype=bf)
        k, v = randn(1, s_len, 8, 128, dtype=bf), randn(1, s_len, 8, 128, dtype=bf)
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        kv_len = torch.tensor([kv], dtype=torch.int32, device=q.device)
        reps = 10 if s_len == LONG_KV else 50
        err = close(decode_attention_q8_ref(q, kq, vq, ks, vs, kv_len),
                    decode_attention_ref(q, kq.float() * ks[..., None], vq.float() * vs[..., None],
                                         kv_len), TOL[bf])
        plain = [graph_ms(lambda: decode_attention_q8_ref(q, kq, vq, ks, vs, kv_len), reps)]
        kernel = graph_ms(lambda: decode_attention(q, k, v, kv_len), reps)
        plain.append(graph_ms(lambda: decode_attention_q8_ref(q, kq, vq, ks, vs, kv_len), reps))
        # the int8 K/V rows and their f32 scales up to kv_len read once, q
        # read and the output written
        q8_ms, q8_by = bound_ms(2 * kv * 8 * (128 + 4) + 2 * q.numel() * 2 + 4,
                                4 * 16 * kv * 128, bf)
        bf_ms, bf_by = bound_ms(2 * kv * 8 * 128 * 2 + 2 * q.numel() * 2 + 4,
                                4 * 16 * kv * 128, bf)
        print(f"time decode_attention_q8_ref (plain, no kernel) [q (1,16,128) bf16, int8 K/V "
              f"(1,{s_len},8,128) + f32 scales, kv_len {kv}]: plain q8 {plain[0] * 1e3:.2f} / "
              f"{plain[1] * 1e3:.2f} us (turns), bf16 kernel on the float cache "
              f"{kernel * 1e3:.2f} us; bound at int8 width {q8_ms * 1e3:.3f} us ({q8_by}), "
              f"at bf16 {bf_ms * 1e3:.3f} us; vs the plain bf16 function on the dequantized "
              f"cache max|d| {err:.3g} (tol {TOL[bf]})")
        del q, k, v, kq, ks, vq, vs


def scan_backward_cost(b, s, h, p, g, n, chunk, dtype, *, with_d=False, with_h0=False,
                       with_dh=False) -> tuple:
    """(bytes, flops) of one scan backward: x, dy, B, C, ld, gi (and D, h0,
    dh_final) read once and the gradients written once (the f32 states and
    state gradients that the kernel keeps in its workspace are the design's
    cost, not the function's: ``phase_scan_backward`` prints them apart);
    per chunk of Q steps the products C B^T, dy x^T (causal halves), S^T dy,
    G^T C and G B, and the five Q N P products (the two state passes, B dH,
    x dH^T, dy H^T), 2 flops each."""
    el = torch.tensor([], dtype=dtype).element_size()
    xs, bc, steps, state = b * s * h * p * el, b * s * g * n * el, b * s * h * 4, b * h * n * p * 4
    read = 2 * xs + 2 * bc + 2 * steps
    written = xs + 2 * bc + 2 * steps
    nbytes = (read + written + (2 * h * 4 if with_d else 0) + (2 * state if with_h0 else 0)
              + (state if with_dh else 0))
    flops = 0.0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        flops += 2 * (q * (q + 1) / 2 * (3 * n + 2 * p) + 5 * q * n * p)
    return nbytes, b * h * flops


# the scan backward's rows (b, s, h, p, g, n, chunk, dtype, with D, h0,
# dh_final, mLSTM form): zamba2-1.2b's training shape in bf16 and f32, the
# mLSTM's 1024 x 1025 state at xlstm-1.3b's 1 x 512 tokens (the wide route),
# then a ragged S, P and N with an initial state and a final-state
# cotangent on both routes
SCAN_BWD_CASES = [
    ((4, 512, 64, 64, 1, 64, 128), torch.bfloat16, True, False, False, False),
    ((4, 512, 64, 64, 1, 64, 128), torch.float32, True, False, False, False),
    ((1, 512, 4, 1025, 4, 1024, 128), torch.bfloat16, False, False, False, True),
    ((2, 77, 8, 33, 2, 20, 32), torch.float32, True, True, True, False),
    ((2, 77, 8, 33, 2, 20, 32), torch.bfloat16, True, True, True, False),
    ((1, 150, 4, 161, 4, 160, 64), torch.float32, False, True, True, True),
    ((1, 150, 4, 161, 4, 160, 64), torch.bfloat16, False, True, True, True),
]


def kernel_name(key: str) -> str:
    """A profiler record's kernel function name without its namespace,
    template arguments and parameters."""
    m = re.search(r"(\w+_kernel)\b", key)
    return m.group(1) if m else key[:60]


def launch_split(fn, reps: int = 5) -> dict:
    """Device µs of one call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``reps`` calls after a warm-up one (the
    launches' own times: the gaps between them are not in the sums)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / reps
    return dict(by_name)


def phase_scan_backward(randn) -> tuple:
    """The gated scan's backward kernel against its plain version on the
    card (``SCAN_BWD_CASES``, each printed with its route; each gradient
    held element by element, ``hold_scan_backward``, and in bf16 also
    against the mirror of the kernel's roundings; two launches bitwise
    equal), each case timed as a CUDA graph beside the plain version and its
    bound; no single library call computes it.  At the two training shapes
    (the first bf16 case of each route) each launch's device µs are printed
    from one profiled call."""
    from repro_torch.kernels.ssm_scan import (
        gated_scan_backward_op,
        gated_scan_backward_padded,
        scan_backward_plan,
    )

    rows, split_routes = [], set()
    for shape, dtype, with_d, with_h0, with_dh, mlstm in SCAN_BWD_CASES:
        b, s, h, p, g, n, chunk = shape
        x, ld, gi, bm, cm, d = scan_inputs(randn, b, s, h, p, g, n, dtype, mlstm=mlstm,
                                           key_scale=n ** -0.5 if mlstm else 1.0)
        dy = randn(b, s, h, p, dtype=dtype)
        h0 = randn(b, h, n, p, dtype=torch.float32) if with_h0 else None
        dh = randn(b, h, n, p, dtype=torch.float32) if with_dh else None
        args = (dy, dh, x, ld, gi, bm, cm, d, h0, chunk)
        grads = gated_scan_backward_op(*args)
        torch.cuda.synchronize()
        refs = gated_scan_backward_padded(*args)
        mirror = None
        if dtype == torch.bfloat16:
            mirror = gated_scan_backward_padded(
                *(a.float() if isinstance(a, torch.Tensor) else a for a in args), mma=True)
        err, readings = hold_scan_backward(grads, refs, args, TOL[dtype], mirror)
        same = all(torch.equal(a, c) for a, c in zip(grads, gated_scan_backward_op(*args)))
        if not same:
            MISMATCHES.append(f"ssm_scan_backward {shape} {dtype}: two launches differ")
        plan = scan_backward_plan(b, s, h, p, g, n, min(chunk, s), dtype)
        b_ms, b_by = bound_ms(*scan_backward_cost(*shape, dtype, with_d=with_d, with_h0=with_h0,
                                                  with_dh=with_dh), dtype)
        ws_ms = 2 * plan["workspace"] * 4 / HBM_BYTES_PER_S * 1e3
        ms = graph_ms(lambda: gated_scan_backward_op(*args), reps=5)
        plain = graph_ms(lambda: gated_scan_backward_padded(*args), reps=3)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        extras = ", ".join(k for k, v in (("D", with_d), ("h0", with_h0), ("dh_final", with_dh))
                           if v)
        label = (f"x/dy ({b},{s},{h},{p}), B/C ({b},{s},{g},{n}) {name}, chunk {chunk}"
                 f"{', ' + extras if extras else ''} ({plan['route']})")
        against = "the plain backward" + (
            f" (and the mirror of the kernel's roundings within {MIRROR_TOL[torch.float32]:g} "
            f"of f32 outputs element by element, |d| / (rms + |mirror|), and "
            f"{MIRROR_TOL[torch.bfloat16]:g} relative L2 of bf16 outputs)"
            if mirror is not None else "")
        print(f"ssm_scan_backward {label}: grads max|d| {err:.3g} (tol {TOL[dtype]} + "
              f"tol |ref| + {ROUNDING_FLOOR:g} x f32 rounding, against {against}; "
              f"max|d| to f64, plain f32 / kernel: "
              f"{'; '.join(readings)}); two launches bitwise "
              f"{same}; kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}); grids {plan['grids']}, workspace "
              f"{plan['workspace'] * 4 / 1e6:.1f} MB (written and read once: {ws_ms * 1e3:.2f} "
              f"us at {HBM_BYTES_PER_S / 1e12:g} TB/s)")
        rows.append(dict(name="ssm_scan_backward", shape=label, max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        if dtype == torch.bfloat16 and plan["route"] not in split_routes:
            split_routes.add(plan["route"])
            split = launch_split(lambda: gated_scan_backward_op(*args))
            print(f"ssm_scan_backward {label} by launch (profiled, device us a call): "
                  + ", ".join(f"{kernel_name(k)} {v:.1f}"
                              for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
                  + f"; sum {sum(split.values()):.1f}")
        del x, dy, bm, cm, grads, refs, args, mirror
        torch.cuda.empty_cache()
    row = rows[0]
    del row["name"]
    return row, rows[1:]


def kv_len_sweep(dec_case) -> None:
    """Decode attention against SDPA on the same valid keys, as kv_len grows
    in qwen3's 512-position cache (printed only): the kernel's fixed cost and
    its cost per chunk of keys."""
    for n in (1, 16, 32, 63, 127, 255, 511):
        q, k, v, kv_len, _ = dec_case(1, 512, 16, 8, 128, [n], None, torch.bfloat16)
        kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
        from repro_torch.kernels.decode_attention import decode_attention

        t = graph_ms(lambda: decode_attention(q, k, v, kv_len), reps=20)
        t_lib = graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True), reps=20)
        print(f"decode kv_len sweep (1, 512, 16, 8, 128) kv_len {n}: kernel {t * 1e3:.2f} us, "
              f"SDPA {t_lib * 1e3:.2f} us")


def profile_attention(dec_case, fl_case) -> None:
    """Device time of each kernel launched by the two attention kernels and
    by SDPA on the same inputs, from ``torch.profiler`` (printed only; the
    graph timings above include the gaps between launches, these do not):
    qwen3's decode step and a 512-token prefill."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v, kv_len, _ = dec_case(1, 512, 16, 8, 128, [63], None, torch.bfloat16)
    kt, vt = k[:, :63].transpose(1, 2), v[:, :63].transpose(1, 2)
    qf, kf, vf = fl_case(1, 512, 512, 16, 8, 128, torch.bfloat16)
    calls = [lambda: decode_attention(q, k, v, kv_len),
             lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt, enable_gqa=True),
             lambda: flash_attention(qf, kf, vf),
             lambda: F.scaled_dot_product_attention(
                 qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2), is_causal=True,
                 enable_gqa=True)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not kernels:
        print("profile: no device time in the trace (not measured)")
    for e in kernels:
        print(f"profile kernel {e.key[:100]}: {e.count} launches, device "
              f"{e.device_time_total / e.count:.2f} us each")


def sass_count(path: str, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS (``cuobjdump``
    of the CUDA toolkit, or the one Triton's package carries)."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                                  "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if os.path.exists(c)), None)
    check(tool is not None, "no cuobjdump to read the kernels' SASS")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return sum(1 for line in sass.splitlines() if opcode in line)


def scan_inputs(randn, b, s, h, p, g, n, dtype, *, mlstm=False, key_scale=1.0):
    """x, ld, gi, B, C, D as the served paths give them: Mamba2 (ld = dt*A
    with zamba2's A and dt_bias, gi = dt, D) or mLSTM (ld = log sigmoid(f),
    gi = exp(i), no D).  ``key_scale`` scales B: the mLSTM's keys are
    W_k x / sqrt(d_head), so at its N = 1024 a score C.B is of order 1."""
    dev = "cuda"
    x = randn(b, s, h, p, dtype=dtype)
    bm, cm = (randn(b, s, g, n, dtype=torch.float32) * key_scale).to(dtype), \
        randn(b, s, g, n, dtype=dtype)
    if mlstm:
        ld = F.logsigmoid(randn(b, s, h, dtype=torch.float32) + 3.0)
        gi = torch.exp(0.3 * randn(b, s, h, dtype=torch.float32) - 1.0)
        return x, ld, gi, bm, cm, None
    dt = F.softplus(randn(b, s, h, dtype=torch.float32) - 2.0)
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt * a, dt, bm, cm, torch.ones(h, device=dev)


def scan_cost(b, s, h, p, g, n, chunk, dtype) -> tuple:
    """(bytes, flops) of one gated scan: each input read once and each
    output written once; per chunk of Q steps the causal scores (Q(Q+1)/2
    dot products of N), their product with x (Q(Q+1)/2 x P), the carried
    state's term (Q N P) and the state update (Q N P), 2 flops each."""
    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * b * s * h * p * el + 2 * b * s * g * n * el + 2 * b * s * h * 4 \
        + h * 4 + b * h * n * p * 4
    flops = 0.0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        flops += 2 * (q * (q + 1) / 2 * (n + p) + 2 * q * n * p + q * p)
    return nbytes, b * h * flops


def phase_scan(dev, randn):
    """The gated scan against its plain version: zamba2's prefill shapes
    (S = 16 and 32, chunk = S), the stateless bucket (S = 64), a padded
    multi-chunk sequence (S = 300, chunk 128), a ragged last chunk (S = 77,
    chunk 32), the mLSTM form (G = H, no D) at a ragged P, N and P no
    multiple of 8, and an initial state, in f32 and bf16; timed at S = 64
    (the kernels line), 16 and 300 in bf16 and at S = 64 in f32."""
    from repro_torch.kernels.ssm_scan import gated_scan, gated_scan_padded, scan_plan

    cases = [((1, 16, 64, 64, 1, 64), 128, False), ((1, 32, 64, 64, 1, 64), 128, False),
             ((1, Z_STATELESS_BUCKET, 64, 64, 1, 64), 128, False),
             ((1, 300, 64, 64, 1, 64), 128, False), ((2, 77, 8, 33, 8, 64), 32, True),
             ((1, 77, 4, 64, 1, 64), 32, False), ((2, 40, 8, 33, 8, 20), 40, True),
             ((1, 200, 8, 130, 2, 128), 100, False)]
    for shape, chunk, mlstm in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(randn, *shape, dtype, mlstm=mlstm)
            y, h = gated_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            y_r, h_r = gated_scan_padded(*args, None, chunk)
            ey = close(y, y_r, TOL[dtype])
            eh = close(h, h_r, TOL[dtype])
            route = scan_plan(*shape, min(chunk, shape[1]), dtype)["route"]
            print(f"gated_scan {shape} chunk {chunk} {'mlstm' if mlstm else 'mamba2'} {dtype} "
                  f"({route}): max|d| y {ey:.3g}, h {eh:.3g} (tol {TOL[dtype]})")
    for dtype in (torch.float32, torch.bfloat16):   # from a given state, over 3 chunks
        x, ld, gi, bm, cm, d = scan_inputs(randn, 1, 70, 8, 64, 2, 64, dtype)
        h0 = randn(1, 8, 64, 64, dtype=torch.float32)
        y, h = gated_scan(x, ld, gi, bm, cm, d, chunk=32, h0=h0)
        y_r, h_r = gated_scan_padded(x, ld, gi, bm, cm, d, h0, 32)
        print(f"gated_scan h0 (1, 70, 8, 64, 2, 64) chunk 32 {dtype}: max|d| "
              f"y {close(y, y_r, TOL[dtype]):.3g}, h {close(h, h_r, TOL[dtype]):.3g}")
    wide = wide_scan_checks(randn)
    timed = []
    for s, dtype in [(Z_STATELESS_BUCKET, torch.bfloat16), (Z_PROMPT, torch.bfloat16),
                     (300, torch.bfloat16), (Z_STATELESS_BUCKET, torch.float32)]:
        shape = (1, s, 64, 64, 1, 64)
        args = scan_inputs(randn, *shape, dtype)
        y, h = gated_scan(*args)
        y_r, h_r = gated_scan_padded(*args, None, 128)
        ey, eh = close(y, y_r, TOL[dtype]), close(h, h_r, TOL[dtype])
        b_ms, b_by = bound_ms(*scan_cost(*shape, min(128, s), dtype), dtype)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"gated_scan timed x {shape[:4]} {name}: max|d| y {ey:.3g}, h {eh:.3g}")
        timed.append(dict(
            name="ssm_scan",
            shape=f"x (1,{s},64,64), B/C (1,{s},1,64) {name}, chunk {min(128, s)}",
            max_abs_err=max(ey, eh),
            ms=graph_ms(lambda: gated_scan(*args)),
            plain_ms=graph_ms(lambda: gated_scan_padded(*args, None, 128)),
            library_ms=None,    # no single PyTorch call computes this scan
            bound_ms=b_ms, bound_by=b_by,
        ))
    row = timed[0]
    del row["name"]
    return row, timed[1:] + wide


def wide_scan_checks(randn) -> list:
    """The wide-state routes (N > 128) against the plain version in f32 and
    bf16: xlstm-1.3b's mLSTM scan at the stateless bucket (S = 64, chunk 64)
    and the stateful prompt's prefill (S = 16), and a ragged N = 160, P = 161
    over three chunks of 64 from a given state (a ragged last slab of B and
    C), the keys B at the mLSTM's scale; then the bf16 kernel's two timed
    rows (``wide_scan_row``): the bucket and the training forward."""
    from repro_torch.kernels.ssm_scan import gated_scan, gated_scan_padded, scan_plan

    full = (1, M_BUCKET, MLSTM_HEADS, MLSTM_N + 1, MLSTM_HEADS, MLSTM_N)
    cases = [(full, 64, False), ((1, M_PROMPT, MLSTM_HEADS, MLSTM_N + 1, MLSTM_HEADS, MLSTM_N),
                                 128, False), ((1, 150, 4, 161, 4, 160), 64, True)]
    for shape, chunk, with_h0 in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, ld, gi, bm, cm, d = scan_inputs(randn, *shape, dtype, mlstm=True,
                                               key_scale=shape[5] ** -0.5)
            h0 = randn(shape[0], shape[2], shape[5], shape[3], dtype=torch.float32) \
                if with_h0 else None
            y, h = gated_scan(x, ld, gi, bm, cm, d, chunk=chunk, h0=h0)
            torch.cuda.synchronize()
            y_r, h_r = gated_scan_padded(x, ld, gi, bm, cm, d, h0, chunk)
            plan = scan_plan(*shape, min(chunk, shape[1]), dtype)
            print(f"gated_scan wide {shape} chunk {chunk}{' h0' if with_h0 else ''} {dtype} "
                  f"({plan['route']}, grid {plan['grid']}, {plan['smem']} B shared): max|d| "
                  f"y {close(y, y_r, TOL[dtype]):.3g}, h {close(h, h_r, TOL[dtype]):.3g} "
                  f"(tol {TOL[dtype]})")
    return [wide_scan_row(randn, M_BUCKET, 64, "the stateless bucket"),
            wide_scan_row(randn, X_TRAIN_SEQ, 128, "the training forward")]


def wide_scan_row(randn, s: int, chunk: int, what: str) -> dict:
    """xlstm-1.3b's mLSTM scan (x (1,s,4,1025), B/C (1,s,4,1024), bf16) on
    the wide mma route: held against the plain version (``TOL``) and the
    mirror of its roundings (``gated_scan_mma_ref``, relative L2 of y and of
    the final state within ``MIRROR_TOL``), two runs bitwise equal (each
    block sums over N in a fixed order), then timed beside the plain version
    and ``scan_cost``'s bound."""
    from repro_torch.kernels.ssm_scan import gated_scan, gated_scan_padded, scan_plan

    bf = torch.bfloat16
    shape = (1, s, MLSTM_HEADS, MLSTM_N + 1, MLSTM_HEADS, MLSTM_N)
    args = scan_inputs(randn, *shape, bf, mlstm=True, key_scale=MLSTM_N ** -0.5)
    y, h = gated_scan(*args, chunk=chunk)
    y2, h2 = gated_scan(*args, chunk=chunk)
    same = torch.equal(y, y2) and torch.equal(h, h2)
    if not same:
        MISMATCHES.append(f"wide gated_scan {shape} chunk {chunk}: two runs differ")
    y_r, h_r = gated_scan_padded(*args, None, chunk)
    err = max(close(y, y_r, TOL[bf]), close(h, h_r, TOL[bf]))
    ym, hm = scan_mirror_padded(*args, None, chunk)
    mirror = (rel_l2(y, ym), rel_l2(h, hm))
    if not max(mirror) <= MIRROR_TOL[bf]:
        MISMATCHES.append(f"wide gated_scan {shape} chunk {chunk}: relative L2 to the mirror "
                          f"{mirror} over {MIRROR_TOL[bf]}")
    plan = scan_plan(*shape, min(chunk, s), bf)
    b_ms, b_by = bound_ms(*scan_cost(*shape, chunk, bf), bf)
    reps = 10 if s <= 64 else 3
    row = dict(
        name="ssm_scan", shape=f"x (1,{s},{MLSTM_HEADS},{MLSTM_N + 1}), B/C "
                               f"(1,{s},{MLSTM_HEADS},{MLSTM_N}) bf16, chunk {chunk} (mma_wide; "
                               f"{what})",
        max_abs_err=err, ms=graph_ms(lambda: gated_scan(*args, chunk=chunk), reps=reps),
        plain_ms=graph_ms(lambda: gated_scan_padded(*args, None, chunk), reps=reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"gated_scan wide {shape} chunk {chunk} bf16 ({what}; {plan['warps']} warps, "
          f"32 columns, slabs of {plan['slab']}, grid {plan['grid']}, "
          f"{plan['smem']} B shared): max|d| {err:.3g} (tol {TOL[bf]}); relative L2 to the "
          f"mirror y {mirror[0]:.3g}, h {mirror[1]:.3g} (tol {MIRROR_TOL[bf]}); two runs "
          f"bitwise {same}; kernel {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} "
          f"us, bound {b_ms * 1e3:.3f} us ({b_by})")
    return row


def phase_small_reference(dev):
    """The reduced qwen3-0.6b, zamba2-1.2b, minicpm3-4b and xlstm-1.3b in f32
    (head dims the kernels take: 32, 64, 96, 128 and 256), the card
    (kernels) against the CPU (plain versions) on the same weights and
    tokens.  The zamba2 variant has 2 groups with the shared block and a
    1-layer tail, and its 20-token prompt leaves a ragged last scan chunk of
    4."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.registry import get_model

    for cfg, s in ((get_reduced_config("qwen3-0.6b", d_head=32), 12),
                   (get_reduced_config("zamba2-1.2b", n_layers=5, attn_every=2, d_head=32,
                                       ssm_head_dim=32), 20),
                   # the reduced MLA's qk head dim is 16, which the kernels do
                   # not take: minicpm3's own 64 + 32 (flash at d = 96), v 64
                   (get_reduced_config("minicpm3-4b", nope_head_dim=64, rope_head_dim=32,
                                       v_head_dim=64, d_head=96), 12),
                   # two groups of one mLSTM and one sLSTM, a one-block tail;
                   # the mLSTM state is 32 x 33 (the narrow route)
                   (get_reduced_config("xlstm-1.3b", n_layers=5, slstm_every=2), 20)):
        model = get_model(cfg)
        p_cpu = model.init_params(cfg, 1, "cpu")
        p_dev = torch.utils._pytree.tree_map(lambda t: t.to(dev), p_cpu)
        tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, s))
                               .astype(np.int32))
        with torch.no_grad():
            l_cpu, c_cpu = model.prefill(p_cpu, {"tokens": tok}, cfg, s + 4)
            l_dev, c_dev = model.prefill(p_dev, {"tokens": tok.to(dev)}, cfg, s + 4)
            e1 = close(l_dev.cpu(), l_cpu, TOL[torch.float32])
            pos = torch.tensor(s, dtype=torch.int32)
            nxt = tok[:, -1:]
            d_cpu, _ = model.decode_step(p_cpu, nxt, c_cpu, pos, cfg)
            d_dev, _ = model.decode_step(p_dev, nxt.to(dev), c_dev, pos.to(dev), cfg)
            e2 = close(d_dev.cpu(), d_cpu, TOL[torch.float32])
        print(f"reduced {cfg.name} f32 card vs cpu: prefill logits max|d| {e1:.3g}, "
              f"decode logits max|d| {e2:.3g} (tol {TOL[torch.float32]})")


class StepTimer:
    """Wall time of each ``session.infer`` (the outputs are host copies, so
    the call has waited for the card when it returns), and the kernel
    launches each made."""

    def __init__(self, session):
        from repro_torch.kernels import library

        self.steps = []
        inner = session.infer

        def infer(*args):
            before = dict(library.LAUNCHES)
            t0 = time.perf_counter()
            res = inner(*args)
            dt = time.perf_counter() - t0
            launched = {k: n - before[k] for k, n in library.LAUNCHES.items()}
            self.steps.append((res.mode, dt, launched))
            return res

        session.infer = infer

    def mean_ms(self, mode: str, skip: int = 0) -> float:
        ts = [t for m, t, _ in self.steps if m == mode][skip:]
        return 1e3 * sum(ts) / max(1, len(ts))

    def launches(self, mode: str, kernel: str) -> list:
        return [n[kernel] for m, _, n in self.steps if m == mode]


def phase_main_path(dev, name, prompt_len, new_tokens, bucket, *, stateful=True, params=None,
                    cfg=None, inputs=None):
    """Serve one model: ``LocalServing`` (stateful only), ``RRTOServedLM``
    rrto and a ``device_only`` session, on one set of weights.  ``cfg``
    (default: the registry's ``name``) may cut the model's depth;
    ``inputs`` (an encoder-decoder's frames, a VLM's patches) join the
    prompt in ``LocalServing``'s batch, whose cache also holds a VLM's
    patch prefix.  The served app sends tokens alone."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import LocalServing, RRTOServedLM

    cfg = cfg or get_config(name)
    if params is None:
        t0 = time.perf_counter()
        params = get_model(cfg).init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        leaves = torch.utils._pytree.tree_leaves(params)
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        print(f"{name} params: {n_params} ({n_bytes / 1e9:.3f} GB), "
              f"init {time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, prompt_len)).astype(np.int32)

    local = None
    if stateful:
        t0 = time.perf_counter()
        local = LocalServing(cfg, params=params, device=dev).generate(
            {"tokens": prompt, **(inputs or {})}, new_tokens, max_seq=bucket + cfg.num_patches)
        print(f"{name} LocalServing: {new_tokens} tokens in {time.perf_counter() - t0:.2f} s")

    kind = "stateful" if stateful else "stateless"
    t0 = time.perf_counter()
    served = RRTOServedLM(cfg, system="rrto", bucket_len=bucket, params=params, device=dev,
                          stateful=stateful)
    print(f"{name} {kind} RRTOServedLM session (trace of {served.session._n_kernels} aten "
          f"calls per step): {time.perf_counter() - t0:.1f} s")
    timer = StepTimer(served.session)
    t0 = time.perf_counter()
    r_srv = served.generate(prompt, new_tokens)
    print(f"{name} {kind} RRTOServedLM: {len(timer.steps)} steps in "
          f"{time.perf_counter() - t0:.1f} s")

    only = RRTOServedLM(cfg, system="device_only", bucket_len=bucket, params=params, device=dev,
                        stateful=stateful)
    r_dev = only.generate(prompt, new_tokens)

    sess = served.session
    hist = sess.history
    modes = [h.mode for h in hist]
    n_rec = modes.index("replaying") if "replaying" in modes else len(modes)
    steady = [h for h in hist if h.mode == "replaying"][1:]
    cache_bytes = sum(t.numel() * t.element_size() for t in served._cache_leaves)
    return dict(
        name=name, cfg=cfg, params=params, prompt=prompt, local=local, r_srv=r_srv,
        r_dev=r_dev, served=served, sess=sess, modes=modes, n_rec=n_rec, steady=steady,
        cache_bytes=cache_bytes, timer=timer, new_tokens=new_tokens, bucket=bucket,
        stateful=stateful,
    )


def check_main_path(m, per_step=None) -> None:
    """The served path's checks.  ``per_step``: the launches of each kernel
    that every replayed step must make (stateless: the whole bucket's
    forward, one scan per Mamba2 or mLSTM layer, one flash call per
    attention layer; stateful: one decode step)."""
    sess, steady, name = m["sess"], m["steady"], m["name"]
    check(np.array_equal(m["r_srv"].tokens, m["r_dev"].tokens),
          f"{name}: rrto tokens {m['r_srv'].tokens} != device_only {m['r_dev'].tokens}")
    print(f"{name}: rrto tokens == device_only tokens: True")
    check(sess.client.mode == "replaying", f"{name}: session never reached replaying")
    check(m["modes"] == ["recording"] * m["n_rec"] + ["replaying"] * (len(m["modes"]) - m["n_rec"]),
          f"{name}: modes switch more than once: {m['modes']}")
    check(m["n_rec"] <= sess.client.min_repeats + 2,
          f"{name}: locked only after {m['n_rec']} recorded steps")
    check(bool(steady) and all(h.rpcs <= 3 for h in steady),
          f"{name}: steady replay rpcs {[h.rpcs for h in steady]}")
    t = m["timer"]
    for kernel, want in (per_step or {}).items():
        got = t.launches("replaying", kernel)
        check(bool(got) and all(n == want for n in got),
              f"{name}: {kernel} launches per replayed step {got}, want {want}")
    if m["stateful"]:
        check(all(h.network_bytes < m["cache_bytes"] for h in steady),
              f"{name}: carried state on the wire")
        pairs = sess.client.ios.carried_pairs
        n_leaves = len(m["served"]._cache_leaves)
        check(len(pairs) == n_leaves,
              f"{name}: {len(pairs)} carried pairs for {n_leaves} cache leaves")
        print(f"{name} modes: {m['n_rec']} recording then replaying; steady rpcs/token "
              f"{max(h.rpcs for h in steady)}; steady wire bytes/token "
              f"{max(h.network_bytes for h in steady):.0f} < carried state {m['cache_bytes']}; "
              f"carried pairs {pairs}; IOS {len(sess.client.ios)} records")
        match = int((m["local"].tokens == m["r_srv"].tokens).sum())
        print(f"{name} LocalServing vs served tokens matching: {match}/{m['new_tokens']}")
        locked = sum(dt for mode, dt, _ in t.steps if mode == "recording")
        print(f"{name}: the IOS locked after {m['n_rec']} recorded steps, {locked:.1f} s")
        if per_step:
            print(f"{name} launches in each replayed step: {per_step}")
    else:
        check(not sess.client.ios.carried_pairs, f"{name}: stateless app carries state")
        print(f"{name} stateless modes: {m['n_rec']} recording then replaying; steady "
              f"rpcs/token {max(h.rpcs for h in steady)}; wire bytes/token "
              f"{max(h.network_bytes for h in steady):.0f}; IOS {len(sess.client.ios)} records; "
              f"launches in each replayed step: {per_step}")
    print(f"{name} wall per recorded step {t.mean_ms('recording'):.1f} ms, per replayed step "
          f"{t.mean_ms('replaying', skip=1):.1f} ms (steady, first replay excluded)")


def measure_replay_step(m, dev, *, profile: bool = False) -> dict:
    """Split a replayed step: the replay program alone, dispatched eagerly
    (host + device), and captured once in a CUDA graph (device only); the
    rest of a replayed step's wall time is the host's interception.  The
    step gets the wire a served token uploads: the stateful app's token and
    position, or the stateless app's whole bucket and its length.  With
    ``profile``, ``torch.profiler`` reads the graph-replayed step's device
    time by kernel."""
    sess = m["sess"]
    bound = sess.server.context().replay
    env = sess.server.context().env
    params_flat = [env[a] for a in bound.param_addrs]
    cur = m["prompt"].shape[1] + m["new_tokens"] - 1
    if m["stateful"]:
        wire = [torch.zeros((1, 1), dtype=torch.int32, device=dev),
                torch.tensor(cur, dtype=torch.int32, device=dev)]
        state = list(bound.carried_state)

        def step():
            bound.program.step_fn(params_flat, wire, state)
    else:
        tokens = np.zeros((1, m["bucket"]), np.int32)
        tokens[:, :cur] = np.concatenate([m["prompt"], m["r_srv"].tokens], axis=1)[:, :cur]
        wire = [torch.from_numpy(tokens).to(dev), torch.tensor(cur, dtype=torch.int32, device=dev)]

        def step():
            bound.program.fn(params_flat, wire)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    device_ms = graph_ms(step, reps=5)
    wall_ms = m["timer"].mean_ms("replaying", skip=1)
    weight_bytes = sum(t.numel() * t.element_size() for t in params_flat)
    print(f"{m['name']} {'stateful' if m['stateful'] else 'stateless'} replayed step: wall "
          f"{wall_ms:.1f} ms = replay program {eager_ms:.1f} ms (eager dispatch; "
          f"{device_ms:.2f} ms of it as one CUDA graph) + interception "
          f"{wall_ms - eager_ms:.1f} ms; weight-read bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms ({weight_bytes / 1e9:.3f} GB)")
    if profile:
        profile_step(f"{m['name']} {'stateful' if m['stateful'] else 'stateless'}", step)
    return dict(wall_ms=wall_ms, eager_ms=eager_ms, device_ms=device_ms)


def profile_step(label, step, reps: int = 3) -> None:
    """Device time of one graph-replayed step by kernel name, from
    ``torch.profiler`` over ``reps`` replays: the top 10 kernels, and the
    shares of rmsnorm, the scan, flash attention and copies where they ran
    (printed only).  One warm-up replay runs inside the profiler first and
    is left out: the replays are 20 ms apart, so the ``reps`` widest gaps
    between kernel records split the records into the replays (a step's own
    gaps can pass a millisecond), and the first replay is dropped."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    g = capture(step, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(1 + reps):
            g.replay()
            torch.cuda.synchronize()
            time.sleep(0.02)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        print(f"{label} step profile: no device time in the trace (not measured)")
        return
    gaps = sorted(range(1, len(events)), key=lambda i: events[i - 1].time_range.end
                  - events[i].time_range.start)[:reps]
    cuts = [0, *sorted(gaps), len(events)]
    clusters = [events[a:b] for a, b in zip(cuts, cuts[1:])]
    rms = [sum(1 for e in c if "rmsnorm_" in e.name) for c in clusters]
    print(f"{label} step profile: kernel records per replay {[len(c) for c in clusters]}, "
          f"rmsnorm records per replay {rms} (the first is the warm-up, left out)")
    by_name = defaultdict(lambda: [0, 0.0])
    for c in clusters[1:]:
        for e in c:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    n = len(clusters) - 1
    total = sum(t for _, t in by_name.values()) / n
    print(f"{label} step profile (graph replay, {n} steps): device time "
          f"{total / 1e3:.3f} ms a step; {sum(c for c, _ in by_name.values())} kernel records")
    for name, (count, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {t / n:9.1f} us {100 * t / n / total:5.1f}%  {count:5d} records  {name[:90]}")
    for name, keys in (("rmsnorm", ("rmsnorm_",)), ("gated scan", ("ssd_kernel", "ssd_mma_",
                                                                    "ssd_wide_")),
                       ("flash attention", ("wgmma_kernel", "core_kernel")),
                       ("copies and stacks", ("copy_kernel", "CatArray", "index_copy"))):
        hits = [(c, t) for k, (c, t) in by_name.items() if any(x in k for x in keys)]
        if hits:
            t = sum(t for _, t in hits) / n
            print(f"  share of {name}: {t:.1f} us a step ({sum(c for c, _ in hits)} records in "
                  f"{n} steps), {100 * t / total:.1f}% of the step")


def prefill_and_decode_logits(m, dev, params, cfg) -> tuple:
    """Last-position logits of the prompt from ``prefill`` (flash attention,
    the scan kernel) and from a token-by-token ``decode_step`` loop."""
    from repro_torch.models.registry import get_model

    model = get_model(cfg)
    tok = torch.from_numpy(m["prompt"]).to(dev)
    with torch.no_grad():
        l_pre, _ = model.prefill(params, {"tokens": tok}, cfg, m["bucket"])
        cache = model.init_cache(cfg, 1, m["bucket"], dev)
        for i in range(tok.shape[1]):
            pos = torch.tensor(i, dtype=torch.int32, device=dev)
            l_dec, cache = model.decode_step(params, tok[:, i:i + 1], cache, pos, cfg)
    a, b = l_pre[0, 0, :cfg.vocab].float(), l_dec[0, 0, :cfg.vocab].float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          f"{cfg.name} {cfg.dtype}: non-finite logits")
    return a, b


def prefill_vs_decode_gaps(m, dev, params, cfg, label) -> tuple:
    """The model's weights in bf16 and the same weights in f32, last logits
    from prefill and from a decode loop: (f32 gap, bf16 gap, bf16 prefill vs
    f32, bf16 decode loop vs f32), each over the largest f32 logit
    (printed)."""
    a, b = prefill_and_decode_logits(m, dev, params, cfg)
    params32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
    a32, b32 = prefill_and_decode_logits(m, dev, params32,
                                         dataclasses.replace(cfg, dtype="float32"))
    del params32
    scale = a32.abs().max().item()

    def rel(x, y):
        return (x - y).abs().max().item() / scale

    gaps = rel(a32, b32), rel(a, b), rel(a, a32), rel(b, b32)
    print(f"{label} prefill vs decode-loop last logits (max|d| / max|f32 logit| {scale:.4g}): "
          f"f32 {gaps[0]:.3g}; bf16 {gaps[1]:.4g}, argmax equal: "
          f"{int(a.argmax()) == int(b.argmax())}; bf16 vs f32: prefill {gaps[2]:.4g}, "
          f"decode loop {gaps[3]:.4g}")
    return gaps


def check_prefill_vs_decode(m, dev, bf16_tol: float) -> None:
    """In f32 the two paths agree to TOL; in bf16 they agree with each
    other, and each with the f32 logits, to ``bf16_tol`` of the largest f32
    logit."""
    name = m["name"]
    gap32, gap, err_pre, err_dec = prefill_vs_decode_gaps(m, dev, m["params"], m["cfg"], name)
    print(f"{name}: tolerance f32 {TOL[torch.float32]}, bf16 {bf16_tol}")
    check(gap32 <= TOL[torch.float32], f"{name}: f32 prefill and decode-loop logits disagree")
    check(max(gap, err_pre, err_dec) <= bf16_tol,
          f"{name}: bf16 prefill, decode-loop and f32 logits disagree")


def xlstm_first_group(params, cfg):
    """The xLSTM's first group alone (its 7 mLSTM blocks and its sLSTM
    block, full width), the served weights' own leaves, no copy."""
    cut = {k: v for k, v in params.items() if k not in ("m_groups", "s_blocks", "m_tail")}
    cut["m_groups"] = torch.utils._pytree.tree_map(lambda t: t[:1], params["m_groups"])
    cut["s_blocks"] = torch.utils._pytree.tree_map(lambda t: t[:1], params["s_blocks"])
    return cut, dataclasses.replace(cfg, n_layers=cfg.slstm_every)


def check_xlstm_prefill_vs_decode(m, dev) -> None:
    """The random-weight xLSTM amplifies any rounding difference through its
    blocks: at all 48 the reference's own bf16 logits stray from its f32
    ones by more than half of the largest
    (tests/test_torch_xlstm.py::test_bf16_drift_matches_the_reference holds
    the port's drift to the reference's).  So the two paths are held in f32
    at TOL over the first group (7 mLSTM blocks through the scan kernel, one
    sLSTM block); at full depth, and in bf16, the gaps are measured and
    printed."""
    name = m["name"]
    prefill_vs_decode_gaps(m, dev, m["params"], m["cfg"],
                           f"{name} ({m['cfg'].n_layers} blocks, printed)")
    params, cfg = xlstm_first_group(m["params"], m["cfg"])
    gap32 = prefill_vs_decode_gaps(m, dev, params, cfg,
                                   f"{name} first group ({cfg.n_layers} blocks)")[0]
    print(f"{name} first group: f32 tolerance {TOL[torch.float32]}")
    check(gap32 <= TOL[torch.float32],
          f"{name}: f32 prefill and decode-loop logits of the first group disagree")


# ---------------------------------------------------------------------------
# phase 6: KAPAO and the CNN zoo
# ---------------------------------------------------------------------------

def top_k_run(model, dev):
    """One eager inference of ``model`` on ``dev`` (setup graph included),
    with the operand and indices of every ``topk`` captured: the host
    outputs and a list of (scores, indices) on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Capture(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.topk.default:
                self.seen.append((args[0].cpu(), out[1].cpu()))
            return out

    inputs = [torch.from_numpy(np.asarray(x).copy()).to(dev) for x in model.example_inputs]
    with torch.no_grad(), Capture() as cap:
        aux = model.setup(model.params, *inputs)
        outs = model.apply(model.params, aux, *inputs)
    return [o.cpu() for o in outs], cap.seen


def near_tie_compare(outs, cap, ref_outs, ref_cap, tol) -> tuple:
    """KAPAO's outputs against a reference run: each top-k's scores within
    ``tol``; its indices equal except where the reference's two candidates
    lie within ``tol`` of each other (a near tie); the rows gathered at equal
    indices (outputs 2i and 2i+1 for top-k i) within ``tol``.  Returns
    (max |d|, near-tie positions skipped)."""
    worst, skipped = 0.0, 0
    for i, ((scores, idx), (r_scores, r_idx)) in enumerate(zip(cap, ref_cap)):
        bound = tol + tol * r_scores.abs()
        err = (scores - r_scores).abs()
        check(bool((err <= bound).all()), f"top-k {i} scores differ by {err.max().item():.3g}")
        worst = max(worst, err.max().item())
        differ = idx != r_idx
        picked, wanted = r_scores.gather(-1, idx), r_scores.gather(-1, r_idx)
        tie = (picked - wanted).abs() <= tol + tol * wanted.abs()
        check(not bool((differ & ~tie).any()), f"top-k {i} picks other candidates")
        skipped += int(differ.sum())
        for o in (2 * i, 2 * i + 1):
            a, b = outs[o][~differ], ref_outs[o][~differ]
            err = (a - b).abs()
            check(bool((err <= tol + tol * b.abs()).all()),
                  f"output {o} differs by {err.max().item():.3g}")
            worst = max(worst, err.max().item())
    return worst, skipped


def phase_kapao(dev) -> dict:
    """KAPAO at full width through the five systems, ``KAPAO_INFERS``
    inferences each on one set of weights, every output held against
    ``device_only``'s."""
    from repro_torch.core.offload import SYSTEMS, OffloadSession
    from repro_torch.models.cnn_zoo import make_kapao_calibrated

    t0 = time.perf_counter()
    model = make_kapao_calibrated(1.0, KAPAO_SIZE, 0, device=dev)
    leaves = torch.utils._pytree.tree_leaves(model.params)
    print(f"kapao: {len(leaves)} parameter leaves, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e6:.1f} MB, input "
          f"{KAPAO_SIZE}, built and calibrated in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for system in SYSTEMS:
        t0 = time.perf_counter()
        sess = OffloadSession(model, system, device=dev)
        timer = StepTimer(sess)
        sess.load()
        for _ in range(KAPAO_INFERS):
            sess.infer(*model.example_inputs)
        runs[system] = (sess, timer)
        print(f"kapao {system}: {KAPAO_INFERS} inferences in {time.perf_counter() - t0:.1f} s; "
              f"modes {[h.mode for h in sess.history]}; rpcs {[h.rpcs for h in sess.history]}")
    return dict(model=model, runs=runs)


def check_kapao(k, dev) -> None:
    from repro_torch.models.cnn_zoo import make_kapao_calibrated

    runs = k["runs"]
    ref = runs["device_only"][0].history
    for system in ("rrto", "cricket", "semi_rrto"):
        hist = runs[system][0].history
        same = [all(torch.equal(a, b) for a, b in zip(h.outputs, r.outputs))
                for h, r in zip(hist, ref)]
        check(all(same), f"kapao {system} != device_only at inferences {same}")
    nnto_err = max((a - b).abs().max().item()
                   for h, r in zip(runs["nnto"][0].history, ref)
                   for a, b in zip(h.outputs, r.outputs))
    check(nnto_err <= TOL[torch.float32], f"kapao nnto differs from device_only by {nnto_err}")
    print(f"kapao: rrto, cricket, semi_rrto == device_only bitwise at all {KAPAO_INFERS} "
          f"inferences; nnto max|d| {nnto_err:.3g}")
    rrto, cricket = runs["rrto"][0].history, runs["cricket"][0]
    check([h.mode for h in rrto] == ["recording"] * 3 + ["replaying"] * (KAPAO_INFERS - 3),
          f"kapao rrto modes {[h.mode for h in rrto]}")
    check(all(h.rpcs == 11 for h in rrto[3:]), f"kapao rrto rpcs {[h.rpcs for h in rrto]}")
    check(all(h.rpcs == 5895 for h in cricket.history[1:]),
          f"kapao cricket rpcs {[h.rpcs for h in cricket.history]}")
    start = cricket.stage_marks["after_first_inference"]
    loop = cricket.client.logs[start:start + cricket.history[1].rpcs]
    comp = Counter("cudaLaunchKernel" if r.func.startswith("kernel:") else r.func for r in loop)
    check({n: comp.get(n, 0) for n in TAB3_LOOP} == TAB3_LOOP, f"kapao Tab. III loop {comp}")
    print(f"kapao: rrto replaying from inference 4 at 11 RPCs; cricket 5895 RPCs per loop "
          f"inference; Tab. III loop composition exact: {dict(comp)}")

    t0 = time.perf_counter()
    card_outs, card_cap = top_k_run(k["model"], dev)
    check(all(torch.equal(a, b) for a, b in zip(card_outs, ref[-1].outputs)),
          "kapao eager run != device_only session")
    cpu_model = make_kapao_calibrated(1.0, KAPAO_SIZE, 0, device="cpu")
    cpu_outs, cpu_cap = top_k_run(cpu_model, torch.device("cpu"))
    err, skipped = near_tie_compare(card_outs, card_cap, cpu_outs, cpu_cap, TOL[torch.float32])
    check(all(torch.isfinite(o).all() for o in card_outs), "kapao: non-finite outputs")
    print(f"kapao card vs cpu: max|d| {err:.3g} (tol {TOL[torch.float32]}), {skipped} near-tie "
          f"top-k positions skipped ({time.perf_counter() - t0:.1f} s)")


def measure_cnn_step(label, sess, timer, inputs, dev, *, profile=False) -> dict:
    """A CNN's replayed inference split as ``measure_replay_step`` splits the
    LM steps: the replay program dispatched eagerly and as one CUDA graph,
    the rest of the wall time host interception; the graph step's bound from
    the cost model's flops and bytes (f32 outside the tensor cores: TF32 is
    off).  A stateful program (the recurrent decoder) steps its resident
    state.  With ``profile``, the graph step's device time by kernel."""
    from repro_torch.core.flatten import graph_cost

    bound = sess.server.context().replay
    program = bound.program
    params_flat = [sess.server.context().env[a] for a in bound.param_addrs]
    wire = [torch.from_numpy(np.asarray(x).copy()).to(dev) for x in inputs]
    if program.is_stateful:
        wire = [wire[i] for i in program.wire_in]
        state = list(bound.carried_state)

        def step():
            program.step_fn(params_flat, wire, state)
    else:
        def step():
            program.fn(params_flat, wire)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    device_ms = graph_ms(step, reps=5)
    wall_ms = timer.mean_ms("replaying", skip=1)
    flops, nbytes = graph_cost(sess._graph)
    b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
    print(f"{label} replayed inference: wall {wall_ms:.1f} ms = replay program {eager_ms:.1f} ms "
          f"(eager dispatch of {program.n_kernels} calls; {device_ms:.3f} ms of it as one "
          f"CUDA graph) + interception {wall_ms - eager_ms:.1f} ms; bound {b_ms:.3f} ms by "
          f"{b_by} ({flops / 1e9:.2f} GFLOP at {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s "
          f"f32, {nbytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"{100 * b_ms / device_ms:.1f}% of the graph step")
    if profile:
        profile_step(label, step)
    return dict(wall_ms=wall_ms, eager_ms=eager_ms, device_ms=device_ms, bound_ms=b_ms)


def phase_zoo(dev) -> None:
    """Every other CNN of the zoo at full width through rrto and
    ``device_only``: rrto reaches replaying and equals ``device_only``
    bitwise at every inference.  The recurrent decoder threads its state ``h``
    back in; rrto carries it on the server, so its steady replay takes 2 RPCs
    (the frame up, ``y`` down) and its ``h`` download is a stable handle, not
    compared once replaying."""
    from repro_torch.core.offload import OffloadSession
    from repro_torch.models.cnn_zoo import ZOO

    for key, size in ZOO_SIZES.items():
        t0 = time.perf_counter()
        model = ZOO[key](1.0, size, 0, device=dev)
        rrto = OffloadSession(model, "rrto", device=dev)
        only = OffloadSession(model, "device_only", device=dev)
        timer = StepTimer(rrto)
        ins_r = ins_d = list(model.example_inputs)
        for _ in range(ZOO_INFERS):
            r, d = rrto.infer(*ins_r), only.infer(*ins_d)
            n = 1 if (key == "recurrent_sensor_decoder" and r.mode == "replaying") else None
            check(all(torch.equal(a, b) for a, b in zip(r.outputs[:n], d.outputs[:n])),
                  f"{key}: rrto != device_only in {r.mode}")
            if key == "recurrent_sensor_decoder":
                ins_r, ins_d = [ins_r[0], r.outputs[1]], [ins_d[0], d.outputs[1]]
        hist = rrto.history
        check(rrto.client.mode == "replaying", f"{key}: never reached replaying")
        pairs = rrto.client.ios.carried_pairs
        if key == "recurrent_sensor_decoder":
            check(len(pairs) == 1 and hist[-1].rpcs == 2,
                  f"{key}: carried pairs {pairs}, steady rpcs {hist[-1].rpcs}")
        else:
            check(not pairs, f"{key}: carries {pairs}")
        print(f"{key} @ {size}: {len(rrto._graph.nodes)} aten calls; modes "
              f"{[h.mode[:3] for h in hist]}; rpcs {[h.rpcs for h in hist]}; carried {pairs}; "
              f"rrto == device_only bitwise ({time.perf_counter() - t0:.1f} s)")
        measure_cnn_step(f"{key} @ {size}", rrto, timer, ins_r, dev)
        del model, rrto, only
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: multi-tenant serving (co-tenant replays batched with vmap)
# ---------------------------------------------------------------------------

MT_CLIENTS, MT_PROMPTS, MT_NEW = 4, (8, 9, 10, 11), 8        # qwen3-0.6b, bucket 512
MT_Z_CLIENTS, MT_Z_PROMPT, MT_Z_NEW = 2, Z_PROMPT, 8            # zamba2 stateless, bucket 64
# the products of the served steps: qwen3's q / k-v / o / gate-up / down /
# head projections and zamba2's in- and out-projections and MLP
GEMM_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
               (1024, 151936), (2048, 8512), (4096, 2048), (2048, 8192), (8192, 2048)]


def vmap_vs_loop(fn, args, in_dims=0):
    """``fn`` under vmap (fallback disabled) and as a loop over lanes."""
    from repro_torch.core.engine import no_vmap_fallback

    dims = in_dims if isinstance(in_dims, tuple) else (in_dims,) * len(args)
    with no_vmap_fallback():
        v = torch.func.vmap(fn, in_dims=in_dims)(*args)
    lanes = next(a.shape[d] for a, d in zip(args, dims) if d is not None)
    outs = [fn(*(a if d is None else a.select(d, i) for a, d in zip(args, dims)))
            for i in range(lanes)]
    loop = tuple(torch.stack(o) for o in zip(*outs)) if isinstance(outs[0], tuple) \
        else torch.stack(outs)
    return v, loop


def bitwise(a, b) -> bool:
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in pairs)


def phase_mt_kernels(dev) -> dict:
    """Each kernel's batching rule at the served shapes with 4 lanes
    (decode attention with a kv_len per lane), bitwise against the loop of
    the same kernel, one launch against four; then each kernel timed at
    batch 4 (the rule's one launch) beside its plain version, the library
    call and the bound.  Then the products of the served steps, lane against
    loop: bf16 and f32 GEMMs at M = 4 against four at M = 1, zamba2's
    depthwise conv at N = 2 against two at N = 1 (printed; the batched
    replay probes its own products and runs the batch-variant ones per
    lane)."""
    from repro_torch.kernels import library
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_dense, flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.kernels.ssm_scan import gated_scan, gated_scan_padded

    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    w1k, w4k = randn(1024), randn(4096)
    kv_len = torch.tensor([[n + 7] for n in MT_PROMPTS], dtype=torch.int32, device=dev)
    dt_ = F.softplus(randn(4, 1, 64, 64, dtype=torch.float32) - 2.0)
    a_ = -torch.linspace(1.0, 16.0, 64, device=dev)
    d_ = torch.ones(64, device=dev)
    cases = [
        ("rmsnorm", "x (4,1,1,1024)", lambda x: rmsnorm(x, w1k), (randn(4, 1, 1, 1024),)),
        ("rmsnorm", "x (4,1,64,4096)", lambda x: rmsnorm(x, w4k), (randn(4, 1, 64, 4096),)),
        ("decode_attention", "q (4,1,16,128), K/V (4,1,512,8,128), kv_len 15-18",
         decode_attention, (randn(4, 1, 16, 128), randn(4, 1, 512, 8, 128),
                            randn(4, 1, 512, 8, 128), kv_len)),
        ("flash_attention", "q/k/v (4,1,64,32,64)", lambda q, k, v: flash_attention(q, k, v),
         (randn(4, 1, 64, 32, 64), randn(4, 1, 64, 32, 64), randn(4, 1, 64, 32, 64))),
        ("ssm_scan", "x (4,1,64,64,64), B/C (4,1,64,1,64)",
         lambda x, ld, gi, b, c: gated_scan(x, ld, gi, b, c, d_),
         (randn(4, 1, 64, 64, 64), dt_ * a_, dt_, randn(4, 1, 64, 1, 64),
          randn(4, 1, 64, 1, 64))),
    ]
    for name, shape, fn, args in cases:
        library.reset_launches()
        v, loop = vmap_vs_loop(fn, args)
        torch.cuda.synchronize()
        n = library.LAUNCHES[name]
        same = bitwise(v, loop)
        print(f"vmap rule {name} {shape} bf16: vmap == lane loop bitwise {same}; launches "
              f"{n} (1 for the rule, 4 for the loop)")
        check(same and n == 5, f"{name}: the vmap rule at {shape} is not the lane loop")

    rows = {}
    # the rule's launch at batch 4, timed as the kernel at the folded shape
    x = randn(4, 1024)
    b_ms, b_by = bound_ms(2 * x.numel() * 2 + 1024 * 2, 4 * x.numel(), bf)
    rows["rmsnorm"] = dict(
        shape="x (4,1024) bf16 (warp)", max_abs_err=close(rmsnorm(x, w1k), rmsnorm_ref(x, w1k),
                                                          RMSNORM_TOL[bf]),
        ms=graph_ms(lambda: rmsnorm(x, w1k)), plain_ms=graph_ms(lambda: rmsnorm_ref(x, w1k)),
        library_ms=graph_ms(lambda: F.rms_norm(x, (1024,), w1k, 1e-6)), bound_ms=b_ms,
        bound_by=b_by)
    q, k, v = randn(4, 16, 128), randn(4, 512, 8, 128), randn(4, 512, 8, 128)
    lens = kv_len.reshape(4)
    keys = int(lens.sum())
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * keys * 8 * 128 * 2 + 16,
                          4 * 16 * keys * 128, bf)
    n = int(lens.max())
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    rows["decode_attention"] = dict(
        shape="q (4,16,128), K/V (4,512,8,128) bf16, kv_len 15-18",
        max_abs_err=close(decode_attention(q, k, v, lens), decode_attention_ref(q, k, v, lens),
                          TOL[bf]),
        ms=graph_ms(lambda: decode_attention(q, k, v, lens)),
        plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, lens)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)
    q, k, v = randn(4, 64, 32, 64), randn(4, 64, 32, 64), randn(4, 64, 32, 64)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b_ms, b_by = bound_ms(2 * 4 * q.numel(), 4 * 4 * 32 * 64 * 65 / 2 * 64, bf)
    rows["flash_attention"] = dict(
        shape="q/k/v (4,64,32,64) bf16, causal",
        max_abs_err=close(flash_attention(q, k, v), attention_dense(q, k, v), TOL[bf]),
        ms=graph_ms(lambda: flash_attention(q, k, v)),
        plain_ms=graph_ms(lambda: attention_dense(q, k, v)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by)
    sargs = scan_inputs(randn, 4, 64, 64, 64, 1, 64, bf)
    y, h = gated_scan(*sargs)
    y_r, h_r = gated_scan_padded(*sargs, None, 128)
    b_ms, b_by = bound_ms(*scan_cost(4, 64, 64, 64, 1, 64, 64, bf), bf)
    rows["ssm_scan"] = dict(
        shape="x (4,64,64,64), B/C (4,64,1,64) bf16, chunk 64",
        max_abs_err=max(close(y, y_r, TOL[bf]), close(h, h_r, TOL[bf])),
        ms=graph_ms(lambda: gated_scan(*sargs)),
        plain_ms=graph_ms(lambda: gated_scan_padded(*sargs, None, 128)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"time batched {name} [{r['shape']}]: kernel {r['ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound {r['bound_ms'] * 1e3:.3f} us "
              f"({r['bound_by']})")

    # the products of the served steps: lanes folded into M against the loop
    for dtype in (bf, torch.float32):
        worst, unequal = 0.0, []
        for kdim, ndim in GEMM_SHAPES:
            w = randn(kdim, ndim, dtype=dtype) * 0.05
            v, loop = vmap_vs_loop(lambda xi: torch.ops.aten.mm.default(xi, w),
                                   (randn(4, 1, kdim, dtype=dtype),))
            if not torch.equal(v, loop):
                unequal.append((kdim, ndim))
                worst = max(worst, (v.float() - loop.float()).abs().max().item())
        print(f"gemm lanes vs loop {dtype}, M = 4 against 4 x M = 1 at {len(GEMM_SHAPES)} "
              f"shapes: unequal at {unequal}, max|d| {worst:.3g}")
    for dtype in (bf, torch.float32):
        c = 4096 + 2 * 64
        w = randn(c, 1, 4, dtype=dtype)
        v, loop = vmap_vs_loop(lambda xi: F.conv1d(xi, w, groups=c),
                               (randn(2, 1, c, Z_STATELESS_BUCKET + 3, dtype=dtype),))
        print(f"depthwise conv1d lanes vs loop {dtype} (2, 1, {c}, "
              f"{Z_STATELESS_BUCKET + 3}): bitwise {torch.equal(v, loop)}, max|d| "
              f"{(v.float() - loop.float()).abs().max().item():.3g}")
    return rows


class RoundTimer:
    """Wall time of each ``edge.run_round`` (its outputs are host copies, so
    the round has waited for the card when it returns), and the data of the
    last round that every client replayed."""

    def __init__(self, edge):
        self.walls = []
        inner = edge.run_round

        def run_round(inputs):
            sessions = edge.sessions
            if len(inputs) == len(sessions) and all(
                    s.client.mode == "replaying" for s in sessions.values()):
                # a round that every client replays: its inputs and the
                # state it starts from are real data for check_lane_order
                self.full_round = (inputs, {
                    c: edge.server.context(c).replay.carried_state for c in inputs})
            t0 = time.perf_counter()
            res = inner(inputs)
            self.walls.append((all(r.mode == "replaying" for r in res.values()),
                               time.perf_counter() - t0))
            return res

        edge.run_round = run_round

    def replay_ms(self, skip: int = 1) -> float:
        ts = [t for replaying, t in self.walls if replaying][skip:]
        return 1e3 * sum(ts) / max(1, len(ts))


def phase_multitenant(dev, name, params, *, stateful, clients, prompt_lens, new_tokens,
                      bucket, enable_vmap, cfg=None):
    """``MultiClientServedLM`` at full width (``cfg`` may cut the depth),
    every round under ``no_vmap_fallback``: ``clients`` co-tenants, one
    prompt length each."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import no_vmap_fallback
    from repro_torch.serving.engine import MultiClientServedLM

    cfg = cfg or get_config(name)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, (1, n)).astype(np.int32) for n in prompt_lens]
    t0 = time.perf_counter()
    m = MultiClientServedLM(cfg, clients, bucket_len=bucket, params=params, device=dev,
                            stateful=stateful)
    m.edge.batcher.enable_vmap = enable_vmap
    timer = RoundTimer(m.edge)
    with no_vmap_fallback():
        res = m.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    kind = "stateful" if stateful else "stateless"
    print(f"{name} {kind} x{clients} {'vmap' if enable_vmap else 'loop'}: {len(timer.walls)} "
          f"rounds in {time.perf_counter() - t0:.1f} s; wall per steady replay round "
          f"{timer.replay_ms():.1f} ms")
    return dict(m=m, tokens=[r.tokens for r in res], timer=timer, prompts=prompts, cfg=cfg,
                stateful=stateful)


def check_multitenant(label, v, lp) -> None:
    """The batched run against the loop run: equal tokens per client, every
    client replaying, one program built, vmap batches only in the batched
    run, 3 RPCs per steady replayed token; prints the product calls each
    batched program measured as batch-variant (they run per lane)."""
    for i, (a, b) in enumerate(zip(v["tokens"], lp["tokens"])):
        check(np.array_equal(a, b), f"{label}: client {i} tokens {a} (vmap) != {b} (loop)")
    for run, kind in ((v, "vmap"), (lp, "loop")):
        m = run["m"]
        edge = m.edge
        check(all(c.session.client.mode == "replaying" for c in m.clients),
              f"{label} {kind}: a client never reached replaying")
        check(edge.compile_count == 1, f"{label} {kind}: {edge.compile_count} programs built")
        for c in m.clients:
            replayed = [h.rpcs for h in c.session.history if h.mode == "replaying"][1:]
            check(bool(replayed) and all(n == 3 for n in replayed),
                  f"{label} {kind} {c.session.client_id}: replay rpcs {replayed}")
    cache = v["m"].edge.cache
    for key in cache.fingerprints:
        if "#vmap" in key:
            b = cache.peek(key)
            kinds = Counter(f"{c.op}->{tuple(c.out_avals[0][0])} {c.out_avals[0][1]}"
                            for c in b.lane_ordered)
            print(f"{label} {key[-6:]}: {b.n_probed} distinct product calls probed, "
                  f"{len(b.lane_ordered)} calls run per lane: {dict(kinds)}")
    s_v, s_l = v["m"].edge.summary(), lp["m"].edge.summary()
    check(s_v["vmap_batches"] >= 1, f"{label}: no vmap batch")
    check(s_l["vmap_batches"] == 0, f"{label}: the loop run made {s_l['vmap_batches']} batches")
    hist = v["m"].clients[-1].session.history
    print(f"{label}: tokens equal vmap vs loop for all {len(v['tokens'])} clients; modes of the "
          f"last client {[h.mode[:3] for h in hist]}; rpcs {[h.rpcs for h in hist]}; vmap run "
          f"{s_v['vmap_batches']} vmap batches, {s_v['vmap_compiles']} batched programs "
          f"built, {s_v['vmap_padded_lanes']} padded lanes, {s_v['batched_replays']} batched / "
          f"{s_v['solo_replays']} solo replays, cache {s_v['cache']}; loop run "
          f"{s_l['vmap_batches']} vmap batches")


def check_lane_order(label, run) -> None:
    """Every recorded call of the edge's program, run call by call on the
    real data of the last round that every client replayed, both ways —
    vmapped over the clients and as the lane loop — from the same inputs.
    Fails unless the calls whose batched form changes their bits are exactly
    the ones the batched program's probe (on hash noise) runs per lane."""
    from repro_torch.core.engine import _per_lane, _run_call, no_vmap_fallback

    edge = run["m"].edge
    first = next(iter(edge.sessions.values())).client
    ctxs = [edge.server.context(c) for c in edge.sessions]
    program = ctxs[0].replay.program
    batched = edge.cache.peek(f"{first.ios_fp}#vmap{len(ctxs)}")
    check(batched is not None and batched.base is program,
          f"{label}: no batched program of width {len(ctxs)} over the clients' program")
    plan = program.plan
    h2d = plan["h2d_addrs"]
    inputs, states = run["timer"].full_round
    lanes = []
    for cid in edge.sessions:   # each client's uploads in that round
        wire = [edge.server.to_device(x)
                for x in edge.sessions[cid].replay_wire_inputs(inputs[cid])]
        if program.is_stateful:
            ins = dict(zip(program.wire_in, wire))
            ins.update((i, x) for (i, _), x in zip(program.carried_pairs, states[cid]))
            wire = [ins[i] for i in range(len(h2d))]
        lanes.append(wire)
    # the shared parameters once, the uploads stacked over the clients; a
    # call's outputs carry the lanes iff an input does, as under vmap
    env = {a: ctxs[0].env[x] for a, x in zip(plan["param_addrs"], ctxs[0].replay.param_addrs)}
    env.update((a, torch.stack(xs)) for a, xs in zip(h2d, zip(*lanes)))
    batched_addrs = set(h2d)
    variant = []
    with torch.no_grad(), no_vmap_fallback():
        for c in program.kernel_calls:
            operands = [env[a] for _, a in c.in_operands]
            dims = [0 if a in batched_addrs else None for _, a in c.in_operands]
            if all(d is None for d in dims):
                env.update(zip(c.out_addrs, _run_call(c, operands)))
                batched_addrs.difference_update(c.out_addrs)
                continue
            loop = _per_lane(c, operands, dims, len(ctxs))
            vm = torch.func.vmap(lambda *xs: tuple(_run_call(c, list(xs))),
                                 in_dims=tuple(dims))(*operands)
            if not all(torch.equal(a, b) for a, b in zip(vm, loop)):
                variant.append(c)
            env.update(zip(c.out_addrs, loop))
            batched_addrs.update(c.out_addrs)
    found, probed = {id(c) for c in variant}, {id(c) for c in batched.lane_ordered}
    print(f"{label}: of {program.n_kernels} calls, {len(variant)} change their bits batched on "
          f"that round's data {dict(Counter(str(c.op) for c in variant))}; the probe runs "
          f"{len(probed)} per lane; {len(found - probed)} missed, {len(probed - found)} extra")
    check(found == probed, f"{label}: the batch-variant calls on real data are not the ones "
          f"the probe lane-orders ({len(found - probed)} missed, {len(probed - found)} extra)")


def time_multitenant_step(v, dev) -> dict:
    """The qwen3 step at width 4: the batched program (one vmap call over
    the four clients' stacked caches) against the four clients' solo steps,
    captured as CUDA graphs and eagerly, in turns (batched, solo, solo,
    batched)."""
    from repro_torch.core.engine import no_vmap_fallback

    edge = v["m"].edge
    ids = [c.session.client_id for c in v["m"].clients]
    bounds = [edge.server.context(c).replay for c in ids]
    program = bounds[0].program
    env = edge.server.context(ids[0]).env
    params_flat = [env[a] for a in bounds[0].param_addrs]
    batched = program.build_batched(len(ids))
    wires = [[torch.zeros((1, 1), dtype=torch.int32, device=dev),
              torch.tensor(20 + i, dtype=torch.int32, device=dev)] for i in range(len(ids))]
    states = [list(b.carried_state) for b in bounds]
    stacked_wire = [torch.stack(ws) for ws in zip(*wires)]
    stacked_state = [torch.stack(ss) for ss in zip(*states)]

    def batched_step():
        with no_vmap_fallback():
            batched.fn(params_flat, stacked_wire, stacked_state)

    def solo_steps():
        for w, st in zip(wires, states):
            program.step_fn(params_flat, w, st)

    def eager_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    graph = [graph_ms(batched_step, reps=3), graph_ms(solo_steps, reps=3),
             graph_ms(solo_steps, reps=3), graph_ms(batched_step, reps=3)]
    eager = [eager_ms(batched_step), eager_ms(solo_steps), eager_ms(solo_steps),
             eager_ms(batched_step)]
    print(f"qwen3-0.6b step at width 4, in turns (batched / 4 solo / 4 solo / batched): CUDA "
          f"graph {' / '.join(f'{t:.3f}' for t in graph)} ms; eager "
          f"{' / '.join(f'{t:.1f}' for t in eager)} ms")
    return dict(graph_batched_ms=(graph[0] + graph[3]) / 2, graph_solo_ms=(graph[1] + graph[2]) / 2,
                eager_batched_ms=(eager[0] + eager[3]) / 2, eager_solo_ms=(eager[1] + eager[2]) / 2)


# ---------------------------------------------------------------------------
# phase 10: split and pipelined replay (the model cut between device and edge)
# ---------------------------------------------------------------------------

SPLIT_STEPS = 3              # segment-program steps per plan (parts a, c)
SPLIT_NEW = 8                # qwen3 tokens generated through the split (part b)
SPLIT_PLANS_SEED = 0         # part c's random plans
SPLIT_MBPS = (0.5, 2.0, 8.0, 32.0, 128.0)   # benchmarks/partition_sweep.py
SPLIT_STREAM, SPLIT_STREAM_HZ = 16, 200.0   # part d's Poisson stream
KERNEL_OPS = {"rmsnorm": "repro_torch::rmsnorm", "decode_attention": "repro_torch::decode_attention",
              "flash_attention": "repro_torch::flash_attention", "ssm_scan": "repro_torch::gated_scan"}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def feasible_prefixes(graph):
    """Carried-feasible device-prefix plans at boundaries 1, limit // 2 and
    the limit (tests/test_stateful_split.py::feasible_plans)."""
    from repro_torch.partition import PLACE_DEVICE, PLACE_SERVER, SplitPlan

    n = graph.n_ops
    bmax = min(graph.carried_cut_limit(), n - 1)
    return [SplitPlan.from_placements([PLACE_DEVICE] * b + [PLACE_SERVER] * (n - b))
            for b in sorted({1, max(1, bmax // 2), bmax})] if bmax >= 1 else []


def plan_kernels(calls, plan) -> dict:
    """Hand-kernel calls of the IOS per placement: {placement: {kernel: n}}."""
    ops = [c.op.name() for c in calls if c.op is not None]
    out = {}
    for seg in plan.segments:
        counts = out.setdefault(seg.placement, Counter())
        for k in range(seg.start, seg.end):
            counts.update(name for name, op in KERNEL_OPS.items() if ops[k] == op)
    return {p: dict(c) for p, c in out.items()}


def boundary_bytes(graph, plan) -> int:
    """Bytes that cross the cuts of ``plan`` per inference, the app's final
    downloads left out (resident and carried tensors never cross)."""
    from repro_torch.core.costmodel import GTX_2080TI
    from repro_torch.partition import stage_chain

    chain = stage_chain(graph, plan, GTX_2080TI, GTX_2080TI)
    return int(sum(s.nbytes for s in chain if s.resource == "link" and s.label != "down@out"))


def split_segments_qwen(library, m, dev) -> dict:
    """Part a: the locked qwen3-0.6b session's IOS cut at each carried-
    feasible device prefix; each plan's segment programs run ``SPLIT_STEPS``
    steps, held bitwise (outputs and carried state) against
    ``ReplayProgram.step_fn`` from the same state.  Only the segment walks
    run between the launch counts' reset and read."""
    from repro_torch.core.engine import BoundSegmentedReplay, SegmentedReplayProgram, host_copy
    from repro_torch.partition import SegmentGraph

    sess = m["sess"]
    cl = sess.client
    ctx = sess.server.context()
    env, ref = ctx.env, ctx.replay
    pairs = cl.ios.carried_pairs
    params_flat = [env[a] for a in ref.param_addrs]
    t0 = time.perf_counter()
    graph = SegmentGraph(cl._ios_calls, carried_pairs=pairs)
    limit = graph.carried_cut_limit()
    print(f"[phase 10a] qwen3-0.6b IOS: {graph.n_ops} ops, {len(graph.tensors)} tensor versions "
          f"({sum(t.derived for t in graph.tensors)} computed from parameters alone), "
          f"SegmentGraph {1e3 * (time.perf_counter() - t0):.1f} ms; carried_cut_limit() = {limit}")
    wire = [torch.zeros((1, 1), dtype=torch.int32),
            torch.tensor(m["prompt"].shape[1] + m["new_tokens"] - 1, dtype=torch.int32)]
    state0 = [s.clone() for s in ref.carried_state]
    ref_state, ref_steps = [s.clone() for s in state0], []
    for _ in range(SPLIT_STEPS):
        outs, ref_state = ref.program.step_fn(params_flat, [w.to(dev) for w in wire], ref_state)
        ref_steps.append(([host_copy(o) for o in outs], [s.clone() for s in ref_state]))
    plans = feasible_prefixes(graph)
    check(len(plans) == 3, f"qwen3-0.6b: feasible prefixes {[p.signature() for p in plans]}")
    library.reset_launches()
    for plan in plans:
        bound = BoundSegmentedReplay.from_own(
            SegmentedReplayProgram(cl._ios_calls, plan, carried_pairs=pairs))
        bound.carried_state = [s.clone() for s in state0]
        split_env = dict(env)
        t0 = time.perf_counter()
        for step, (want, want_state) in enumerate(ref_steps):
            got = bound.execute(wire, split_env)
            check(all(bitwise(a, b) for a, b in zip(got, want)) and len(got) == len(want),
                  f"qwen3-0.6b {plan.signature()}: outputs differ at step {step}")
            check(all(bitwise(a, b) for a, b in zip(bound.carried_state, want_state)),
                  f"qwen3-0.6b {plan.signature()}: carried state differs at step {step}")
        sync(dev)
        print(f"qwen3-0.6b {plan.signature()}: {plan.n_device_ops} device ops, boundary "
              f"{boundary_bytes(graph, plan)} B, hand kernels by placement "
              f"{plan_kernels(cl._ios_calls, plan)}; {SPLIT_STEPS} steps bitwise == step_fn "
              f"(outputs and carried state), {1e3 * (time.perf_counter() - t0) / SPLIT_STEPS:.1f} "
              f"ms per eager split step")
    return dict(limit=limit, plans=[p.signature() for p in plans], graph=graph)


def split_served_qwen(dev, cfg, params, prompt, dev_tokens, bucket) -> dict:
    """Part b: qwen3-0.6b served end to end through the split:
    ``RRTOServedLM(partition=PartitionConfig(adaptive=False))`` driven token
    by token; once the IOS locks, the longest feasible prefix is installed
    (``client._install_plan``, as the reference's tests do) for the tokens
    left.  The tokens must equal phase 3's ``device_only`` tokens.  Returns
    what :func:`time_split_token` times after the path's launches are read."""
    from repro_torch.partition import PartitionConfig
    from repro_torch.serving.engine import RRTOServedLM

    served = RRTOServedLM(cfg, bucket_len=bucket, params=params, device=dev,
                          partition=PartitionConfig(adaptive=False))
    sess = served.session
    timer = StepTimer(sess)
    g = served.start_generation(prompt, SPLIT_NEW)
    picked = None
    t0 = time.perf_counter()
    for _ in range(served.steps_total(g)):
        res = sess.infer(*served.step_inputs(g))
        served.absorb_step(g, res.outputs)
        cl = sess.client
        if cl.mode == "replaying" and picked is None:
            picked = cl.replanner.current.plan
            print(f"[phase 10b] the planner's own pick at {cl.network.bandwidth_at(cl.clock.t) * 8 / 1e6:.1f} "
                  f"Mbps: {picked.signature()} (full-server: {picked.is_full_server}; an LM "
                  f"token's input is 4 bytes)")
            cl._install_plan(feasible_prefixes(cl.replanner.graph)[-1])
    tokens = np.concatenate(g["out"], axis=1)
    check(np.array_equal(tokens, dev_tokens[:, :SPLIT_NEW]),
          f"qwen3-0.6b split tokens {tokens} != device_only {dev_tokens[:, :SPLIT_NEW]}")
    cl = sess.client
    plan = cl.split_plan
    check(plan is not None and cl.mode == "replaying", "qwen3-0.6b: the split plan is not installed")
    split_steps = [h for h in sess.history if h.mode == "replaying"][1:]
    steady = split_steps[1:]          # the first split round hands the state over
    cache_bytes = sum(t.numel() * t.element_size() for t in served._cache_leaves)
    check(bool(steady) and all(h.network_bytes < cache_bytes for h in steady),
          "qwen3-0.6b split: carried state on the wire")
    launched = [n for mode, _, n in timer.steps if mode == "replaying"][1:]
    for name in ("rmsnorm", "decode_attention"):
        check(all(n[name] > 0 for n in launched), f"qwen3-0.6b split: {name} not launched in "
              f"every split step")
    wall_ms = 1e3 * sum(dt for mode, dt, _ in timer.steps[-len(steady):]) / len(steady)
    print(f"qwen3-0.6b split {plan.signature()} ({plan.n_device_ops} device ops): "
          f"{tokens.shape[1]} tokens == device_only; steady "
          f"rpcs/token {[h.rpcs for h in steady]}; wire bytes/token "
          f"{[int(h.network_bytes) for h in steady]} (full-server: 332); carried state "
          f"{cache_bytes} B never billed; wall {wall_ms:.1f} ms/token; "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(sess=sess, plan=plan, pos=g["pos"], wall_ms=wall_ms)


def time_split_token(r, dev) -> dict:
    """Host and eager times of one part-b split token on this card: the split
    walk and the whole program's step in turns (each uploading the wire and
    copying the outputs back, as a served token does), the host time of
    ``compute_schedule`` (once per split token) and of ``plan_partition``."""
    from repro_torch.core.engine import host_copy
    from repro_torch.partition import plan_partition
    from repro_torch.partition.segments import NetworkLink, compute_schedule

    sess, plan, wall_ms = r["sess"], r["plan"], r["wall_ms"]
    cl = sess.client
    ctx = sess.server.context()
    bound, env, whole = ctx.split, ctx.env, ctx.replay
    wire = [torch.zeros((1, 1), dtype=torch.int32),
            torch.tensor(r["pos"] - 1, dtype=torch.int32)]
    saved = list(bound.carried_state)
    params_flat = [env[a] for a in whole.param_addrs]

    def split_step():
        bound.execute(wire, dict(env))
        bound.carried_state = list(saved)

    def whole_step():
        outs, _ = whole.program.step_fn(params_flat, [w.to(dev) for w in wire], saved)
        return [host_copy(o) for o in outs]

    times = {split_step: [], whole_step: []}
    for fn in (split_step, whole_step) * 4:
        t1 = time.perf_counter()
        fn()
        sync(dev)
        times[fn].append(time.perf_counter() - t1)
    eager_ms, whole_ms = (1e3 * sum(times[f][1:]) / 3 for f in (split_step, whole_step))
    link = NetworkLink(cl.network, cl.input_wire_divisor)
    t1 = time.perf_counter()
    for _ in range(5):
        compute_schedule(bound.graph, plan, cl.client_device, sess.server.device_spec, link,
                         t0=cl.clock.t, include_output_downlink=False)
    sched_ms = (time.perf_counter() - t1) / 5 * 1e3
    t1 = time.perf_counter()
    plan_partition(cl.replanner.graph, cl.client_device, sess.server.device_spec,
                   cl.network.bandwidth_at(cl.clock.t))
    planner_ms = (time.perf_counter() - t1) * 1e3
    print(f"qwen3-0.6b split token: wall {wall_ms:.1f} ms = eager split replay {eager_ms:.1f} "
          f"ms + interception {wall_ms - eager_ms:.1f} ms (the whole program's step in turns: "
          f"{whole_ms:.1f} ms); compute_schedule {sched_ms:.2f} ms host per token; "
          f"plan_partition {planner_ms:.1f} ms host")
    return dict(wall_ms=wall_ms, eager_ms=eager_ms, whole_ms=whole_ms, sched_ms=sched_ms,
                planner_ms=planner_ms)


def random_cut_plans(n_ops, rng, k=3):
    """``k`` random contiguous plans of 2-5 cuts with alternating
    placements (tests/test_partition.py::random_plans)."""
    from repro_torch.partition import PLACE_DEVICE, PLACE_SERVER, SplitPlan

    plans = []
    for _ in range(k):
        cuts = sorted(rng.choice(np.arange(1, n_ops), size=int(rng.integers(2, 6)), replace=False))
        bounds = [0] + [int(c) for c in cuts] + [n_ops]
        place = PLACE_DEVICE if rng.random() < 0.5 else PLACE_SERVER
        placements = []
        for lo, hi in zip(bounds, bounds[1:]):
            placements += [place] * (hi - lo)
            place = PLACE_SERVER if place == PLACE_DEVICE else PLACE_DEVICE
        plans.append(SplitPlan.from_placements(placements))
    return plans


def split_segments_zamba(library, m, dev) -> dict:
    """Part c: the locked zamba2-1.2b stateless session (nothing carried, so
    interior cuts are feasible) under 3 seeded random plans of 2-5 cuts, each
    held bitwise against the whole-program replay; rmsnorm, flash attention
    and the scan must each sit in a device-placed segment of some plan (a
    plan around the first flash call is added when none does)."""
    from repro_torch.core.engine import BoundSegmentedReplay, SegmentedReplayProgram, host_copy
    from repro_torch.partition import PLACE_DEVICE, PLACE_SERVER, SegmentGraph, SplitPlan

    sess = m["sess"]
    calls = sess.client._ios_calls
    ctx = sess.server.context()
    env, ref = ctx.env, ctx.replay
    graph = SegmentGraph(calls)
    n = graph.n_ops
    cur = m["prompt"].shape[1] + m["new_tokens"] - 1
    tokens = np.zeros((1, m["bucket"]), np.int32)
    tokens[:, :cur] = np.concatenate([m["prompt"], m["r_srv"].tokens], axis=1)[:, :cur]
    wire = [torch.from_numpy(tokens), torch.tensor(cur, dtype=torch.int32)]
    want = [host_copy(o) for o in ref.program.fn([env[a] for a in ref.param_addrs],
                                                   [w.to(dev) for w in wire])]
    plans = random_cut_plans(n, np.random.default_rng(SPLIT_PLANS_SEED))
    on_device = Counter()
    for plan in plans:
        on_device.update(plan_kernels(calls, plan).get(PLACE_DEVICE, {}))
    if not on_device["flash_attention"]:
        ops = [c.op.name() for c in calls if c.op is not None]
        k = ops.index(KERNEL_OPS["flash_attention"])
        lo, hi = max(1, k - 8), min(n - 1, k + 8)
        plans.append(SplitPlan.from_placements(
            [PLACE_SERVER] * lo + [PLACE_DEVICE] * (hi - lo) + [PLACE_SERVER] * (n - hi)))
        on_device.update(plan_kernels(calls, plans[-1]).get(PLACE_DEVICE, {}))
    for name in ("rmsnorm", "flash_attention", "ssm_scan"):
        check(on_device[name] > 0, f"zamba2-1.2b: no plan puts {name} in a device segment")
    library.reset_launches()
    for plan in plans:
        t0 = time.perf_counter()
        bound = BoundSegmentedReplay.from_own(SegmentedReplayProgram(calls, plan))
        for step in range(SPLIT_STEPS):
            got = bound.execute(wire, dict(env))
            check(len(got) == len(want) and all(bitwise(a, b) for a, b in zip(got, want)),
                  f"zamba2-1.2b stateless {plan.signature()}: differs at step {step}")
        sync(dev)
        print(f"zamba2-1.2b stateless {plan.signature()}: {len(plan.segments)} segments, "
              f"{plan.n_device_ops} of {n} ops on the device, boundary "
              f"{boundary_bytes(graph, plan)} B, hand kernels by placement "
              f"{plan_kernels(calls, plan)}; {SPLIT_STEPS} steps bitwise == the whole-program "
              f"replay ({1e3 * (time.perf_counter() - t0) / SPLIT_STEPS:.1f} ms per step)")
    return dict(plans=[p.signature() for p in plans], on_device=dict(on_device))


def split_sensor_models(dev) -> dict:
    """Part d: the sensor models of the reference's partition tests at the
    benchmark size (scale 1.0, 96 x 96 frames), through ``OffloadSession``:
    the encoder split by the planner, bitwise against plain rrto and
    ``device_only``; the planner at each of ``SPLIT_MBPS`` against both
    endpoints; a pipelined stream of Poisson arrivals bitwise against the
    sequential split; the recurrent decoder's stateful split bitwise against
    plain stateful rrto."""
    from repro_torch.core.netsim import poisson_arrivals
    from repro_torch.core.offload import OffloadSession
    from repro_torch.models.cnn_zoo import make_recurrent_sensor_decoder, make_sensor_encoder
    from repro_torch.partition import (
        ConstantLink,
        PartitionConfig,
        SplitPlan,
        evaluate_plan,
        pipeline_schedule,
        plan_partition,
    )

    model = make_sensor_encoder(scale=1.0, input_size=96, device=dev)
    split = OffloadSession(model, "rrto", device=dev, partition=PartitionConfig())
    plain = OffloadSession(model, "rrto", device=dev)
    only = OffloadSession(model, "device_only", device=dev)
    for _ in range(ZOO_INFERS):
        s, p, d = (x.infer(*model.example_inputs) for x in (split, plain, only))
        check(bitwise(tuple(s.outputs), tuple(p.outputs)) and bitwise(tuple(s.outputs), tuple(d.outputs)),
              f"sensor_encoder split != plain rrto / device_only in {s.mode}")
    cl = split.client
    check(cl.mode == "replaying", "sensor_encoder split: never reached replaying")
    print(f"[phase 10d] sensor_encoder @ 96 split {cl.split_plan.signature() if cl.split_plan else 'S (full server)'}: "
          f"modes {[h.mode[:3] for h in split.history]}; rpcs {[h.rpcs for h in split.history]}; "
          f"bitwise == plain rrto == device_only")
    graph = cl.replanner.graph
    n, div = graph.n_ops, model.input_wire_divisor
    rows, strictly = [], False
    for mbps in SPLIT_MBPS:
        bw = mbps * 1e6 / 8
        t0 = time.perf_counter()
        best = plan_partition(graph, split.client_device, split.server_device, bw,
                              input_wire_divisor=div)
        host_ms = (time.perf_counter() - t0) * 1e3
        full, local = (evaluate_plan(graph, q, split.client_device, split.server_device, bw,
                                     input_wire_divisor=div).seconds
                       for q in (SplitPlan.full_server(n), SplitPlan.full_device(n)))
        check(best.seconds <= min(full, local) + 1e-12,
              f"sensor_encoder @ {mbps} Mbps: planner {best.seconds} worse than {full}/{local}")
        strictly |= best.seconds < min(full, local) * (1 - 1e-6)
        rows.append((mbps, best.plan.signature(), best.plan.n_device_ops, best.seconds, full, local))
        print(f"  {mbps:6.1f} Mbps: plan {best.plan.signature()} ({best.plan.n_device_ops}/{n} "
              f"device ops) modeled {1e3 * best.seconds:.3f} ms vs full offload "
              f"{1e3 * full:.3f} ms, device only {1e3 * local:.3f} ms; planner {host_ms:.1f} ms host")
    check(strictly, "sensor_encoder: the planner beats both endpoints at no operating point")

    # a pipelined stream against the sequential split, on the same plan
    piped = OffloadSession(model, "rrto", device=dev,
                           partition=PartitionConfig(objective="throughput", pipelined=True))
    seq = OffloadSession(model, "rrto", device=dev, partition=PartitionConfig(adaptive=False))
    for _ in range(4):
        piped.infer(*model.example_inputs)
        seq.infer(*model.example_inputs)
    if piped.client.pipelined_exec is None:
        # the throughput planner kept the whole model on the server at this
        # link: stream the sweep's interior plan instead
        interior = next(sig for _, sig, n_dev, *_ in rows if 0 < n_dev < n)
        piped.client._install_plan(SplitPlan.parse_signature(interior))
    plan = piped.client.split_plan
    seq.client._install_plan(plan)
    rng = np.random.default_rng(SPLIT_PLANS_SEED)
    frames = [(model.example_inputs[0] + rng.normal(0, 0.01, model.example_inputs[0].shape)
               .astype(np.float32),) for _ in range(SPLIT_STREAM)]
    arrivals = poisson_arrivals(SPLIT_STREAM_HZ, SPLIT_STREAM, seed=SPLIT_PLANS_SEED)
    arrivals = [a - arrivals[0] for a in arrivals]
    t0 = time.perf_counter()
    results = piped.infer_stream(frames, arrivals=arrivals)
    stream_s = time.perf_counter() - t0
    for r, f in zip(results, frames):
        check(bitwise(tuple(r.outputs), tuple(seq.infer(*f).outputs)),
              "sensor_encoder: pipelined stream != sequential split")
    check(all(a.done_at <= b.done_at for a, b in zip(results, results[1:])),
          "sensor_encoder: stream completions out of order")
    link = ConstantLink(piped.network.bandwidth_at(piped.clock.t), input_wire_divisor=div)
    pipe = pipeline_schedule(piped.client.replanner.graph, plan, piped.client_device,
                             piped.server_device, link, input_wire_divisor=div)
    span = results[-1].done_at - results[0].arrival_t
    print(f"sensor_encoder stream of {SPLIT_STREAM} at {SPLIT_STREAM_HZ:.0f} Hz Poisson on "
          f"{plan.signature()}: bitwise == sequential split; modeled period "
          f"{1e3 * pipe.period_seconds:.3f} ms vs closed loop {1e3 * pipe.latency_seconds:.3f} ms "
          f"(bottleneck {pipe.bottleneck}); simulated span {1e3 * span:.2f} ms; "
          f"{stream_s:.2f} s wall")

    # the stateful sibling: the carried state stays in the server suffix
    dec = make_recurrent_sensor_decoder(scale=1.0, input_size=96, device=dev)
    ds = OffloadSession(dec, "rrto", device=dev, partition=PartitionConfig(adaptive=False))
    dp = OffloadSession(dec, "rrto", device=dev)
    frame, hs = dec.example_inputs
    hp = hs
    for _ in range(ZOO_INFERS):
        hs, hp = ds.infer(frame, hs).outputs[1], dp.infer(frame, hp).outputs[1]
    check(ds.client.stateful_replay, "recurrent_sensor_decoder: no carried state detected")
    graph = ds.client.replanner.graph
    limit = min(graph.carried_cut_limit(), graph.n_ops - 1)
    check(limit >= 1, "recurrent_sensor_decoder: no feasible device prefix")
    # the feasible prefix whose cut ships the fewest bytes (after the stem)
    live = graph.live_bytes()
    b = min(range(1, limit + 1), key=lambda k: live[k])
    plan = SplitPlan.from_placements(["device"] * b + ["server"] * (graph.n_ops - b))
    ds.client._install_plan(plan)
    for step in range(4):
        a, b = ds.infer(frame, hs), dp.infer(frame, hp)
        hs, hp = a.outputs[1], b.outputs[1]
        check(bitwise(a.outputs[0], b.outputs[0]),
              f"recurrent_sensor_decoder stateful split != plain rrto at step {step}")
    print(f"recurrent_sensor_decoder @ 96 stateful split {plan.signature()} (feasible up to "
          f"{limit}): 4 steps "
          f"bitwise == plain stateful rrto; rpcs {a.rpcs} vs {b.rpcs}, wire bytes "
          f"{a.network_bytes:.0f} vs {b.network_bytes:.0f}")
    return dict(rows=rows, period=pipe.period_seconds, latency=pipe.latency_seconds)


# ---------------------------------------------------------------------------
# phase 11: fault tolerance (the lossy link, outages, the replica fleet)
# ---------------------------------------------------------------------------

FAULT_NEW = 8                # qwen3-0.6b tokens of each fleet stream (part a)
FAULT_MIN_REPEATS = 2
FAULT_LOSS = 0.08            # benchmarks/chaos_serving.py's lossy link...
FAULT_SEED0 = 22             # ...and its seed, the first one part a tries
FAULT_CKPT_EVERY = 4
FAULT_CRASH_SEQ = 10         # r0 crashes once this many stateful steps ran
FAULT_MAX_CKPTS = 3          # each checkpoint writes the whole namespace
OUTAGE_S = 0.005             # benchmarks/chaos_serving.py's outage window
FAULT_Z_NEW = 8              # zamba2-1.2b stateless tokens (part b)
SENSOR_OUTAGE_INFERS = 8     # sensor encoder inferences (part c)


def same_tensors(a, b) -> bool:
    return a is not None and b is not None and len(a) == len(b) and bitwise(tuple(a), tuple(b))


def timed_method(obj, name, dev, log: dict):
    """Wrap ``obj.name`` so each call's seconds (to a synchronised card) and
    result land in ``log[name]``; ``del obj.<name>`` restores the method."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(dev)
        log.setdefault(name, []).append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, wrapped)


def fleet_stream(dev, cfg, params, prompt, bucket, *, fault=None, migrate_at=None,
                 ckpt_dir=None, tracer=None) -> dict:
    """Part a: one stateful decode of ``FAULT_NEW`` tokens held by a
    ``FleetClient`` of ``EdgeFleet(2, hedging=False)``, every step through
    ``FleetClient.dispatch``.  ``migrate_at``: move the session r0 -> r1
    before that step.  ``ckpt_dir``: checkpoint every ``FAULT_CKPT_EVERY``
    stateful steps, at most ``FAULT_MAX_CKPTS`` times (each rewrites the
    parameters), and keep the crashed box's tensors to check that nothing of
    them survives into the restored session.  ``tracer`` traces the fleet
    (the migrated stream, which phase 13b reads)."""
    from repro_torch.serving import EdgeFleet, FleetClient, RRTOServedLM

    t_all = time.perf_counter()
    fleet = EdgeFleet(2, hedging=False, fault=fault, checkpoint_dir=ckpt_dir,
                      checkpoint_every=FAULT_CKPT_EVERY, tracer=tracer, device=dev)
    served = RRTOServedLM(cfg, bucket_len=bucket, params=params, edge=fleet.replicas[0].edge,
                          client_id="u0", min_repeats=FAULT_MIN_REPEATS)
    sess = served.session
    fc = fleet.clients["u0"] = FleetClient(fleet, sess.model, "u0", sess, "r0",
                                           min_repeats=FAULT_MIN_REPEATS, stateful=True)
    log, crashed = {}, None
    if ckpt_dir is not None:
        fleet.checkpointer.attach(sess.client)
        timed_method(fleet.checkpointer, "maybe_checkpoint", dev, log)
        timed_method(fleet, "recover", dev, log)
    g = served.start_generation(prompt, FAULT_NEW)
    steps = []
    t0 = time.perf_counter()
    for step in range(served.steps_total(g)):
        if step == migrate_at:
            src, dst = fleet.replica("r0").edge.server, fleet.replica("r1").edge.server
            timed_method(src, "export_carried_state", dev, log)
            timed_method(dst, "import_carried_state", dev, log)
            timed_method(fleet, "migrate", dev, log)
            check(fleet.migrate("u0", "r1") == "r1", "the migration did not land on r1")
            del src.export_carried_state, dst.import_carried_state, fleet.migrate
        if fault is not None and crashed is None and any(
                tc <= fleet.clock.t for tc in fault.crashes.values()):
            # the crash fires at this dispatch: hold the box's tensors
            ctx = fleet.replica("r0").edge.server.contexts["u0"]
            crashed = [*ctx.env.values(), *ctx.replay.carried_state]
        res, _, _ = fc.dispatch(*served.step_inputs(g))
        served.absorb_step(g, res.outputs)
        steps.append((res.mode, res.rpcs, fleet.clock.t))
        writes = [n for _, n in log.get("maybe_checkpoint", []) if n]
        if fleet.checkpointer is not None and len(writes) >= FAULT_MAX_CKPTS:
            fleet.checkpointer = None
    sync(dev)
    loop_s = time.perf_counter() - t0
    return dict(
        fleet=fleet, sess=sess, client=fc, served=served, g=g, steps=steps, log=log,
        crashed=crashed,
        tokens=np.concatenate(g["out"], axis=1),
        state=fleet.locate("u0").edge.server.export_carried_state("u0"),
        wall=time.perf_counter() - t_all, loop_s=loop_s,
        load_rpcs=sess.client.stats.rpcs - sum(r for _, r, _ in steps),
        wire_outs=len(sess.client._wire_out_index),
    )


def predict_losses(seed: int, clean: dict) -> tuple:
    """(retries, dedup replies) the lossy stream will see with ``seed``,
    from the clean stream's transmissions in order: the load's uploads,
    each recorded step's RPCs, and each replayed step's uploads followed by
    its stateful step (a replayed step's wire downloads draw no fate).  The
    losses change timing only, never which messages are sent, so the draws
    line up with the lossy run's one for one.

    This mirrors the order of ``RRTOClient._ride_out_losses`` (one fate per
    RPC, one jitter per loss) and ``RRTOClient._reliable_step`` (a lost
    request re-sends, a lost response is answered from the dedup table), and
    must change with them: a drift shows as a mismatch of the lossy
    stream's counters against this prediction, which fails the phase."""
    from repro_torch.core.netsim import FaultInjector

    f = FaultInjector(seed=seed, rpc_loss_prob=FAULT_LOSS)
    retries = dedup = 0

    def send(n):
        nonlocal retries
        for _ in range(n):
            while f.rpc_fate() != "ok":
                f.jitter_unit()
                retries += 1

    send(clean["load_rpcs"])
    for mode, rpcs, _ in clean["steps"]:
        if mode != "replaying":
            send(rpcs)
            continue
        send(rpcs - clean["wire_outs"])
        executed = False
        while True:            # RRTOClient._reliable_step's attempts
            fate = f.rpc_fate()
            if fate != "lost_request":
                dedup += executed
                executed = True
                if fate == "ok":
                    break
            f.jitter_unit()
            retries += 1
    return retries, dedup


def phase_fault_qwen(library, dev, cfg, params, prompt, dev_tokens, bucket, by_path) -> tuple:
    """Part a: qwen3-0.6b through ``EdgeFleet(2)``: a clean stream, then a
    migrated, a lossy and a crashed one, each bitwise the clean stream in
    tokens and final carried state.  The migrated stream runs traced, so
    the clean stream holds a traced run bitwise too.  Returns the part's
    seconds and the migrated stream, whose trace phase 13b reads and whose
    decode phase 13e continues."""
    import tempfile

    from repro_torch.core.netsim import FaultInjector
    from repro_torch.obs import Tracer

    t_part = time.perf_counter()
    kernels = ("rmsnorm", "decode_attention")
    streams = {}

    def run(kind, **kw):
        label = f"phase 11a qwen3-0.6b {kind}"
        streams[kind], by_path[label] = run_path(
            library, label, kernels, lambda: fleet_stream(dev, cfg, params, prompt, bucket, **kw))
        return streams[kind]

    clean = run("clean")
    check(np.array_equal(clean["tokens"], dev_tokens[:, :FAULT_NEW]),
          f"fleet clean tokens {clean['tokens']} != device_only {dev_tokens[:, :FAULT_NEW]}")
    modes = [m for m, *_ in clean["steps"]]
    check("replaying" in modes and clean["sess"].client.stateful_replay,
          "fleet clean stream never replayed statefully")
    n_rec = modes.index("replaying")
    replayed = [i for i, m in enumerate(modes) if m == "replaying"]
    check(len(replayed) > FAULT_CRASH_SEQ + 2, f"only {len(replayed)} stateful steps")
    print(f"[phase 11a] clean: {len(modes)} steps ({n_rec} recorded), tokens == phase 3's "
          f"device_only; wall {clean['wall']:.1f} s ({1e3 * clean['loop_s'] / len(modes):.1f} "
          f"ms per step); {clean['load_rpcs']} load RPCs")

    def same_as_clean(kind, r):
        check(np.array_equal(r["tokens"], clean["tokens"]),
              f"{kind} tokens {r['tokens']} != clean {clean['tokens']}")
        check(same_tensors(r["state"], clean["state"]), f"{kind} final carried state != clean")
        fleet, cl = r["fleet"], r["sess"].client
        hits = sum(rep.edge.server.dedup_hits for rep in fleet.replicas)
        check(hits == cl.stats.dedup_replies,
              f"{kind}: server dedup hits {hits} != client dedup replies {cl.stats.dedup_replies}")

    mig = run("migrated", migrate_at=n_rec + 4, tracer=Tracer())
    same_as_clean("migrated", mig)
    check(mig["fleet"].stats.migrations == 1 and mig["fleet"].locate("u0").name == "r1",
          f"migrations {mig['fleet'].stats.migrations}")
    (ex_s, state), = mig["log"]["export_carried_state"]
    (im_s, _), = mig["log"]["import_carried_state"]
    (mig_s, _), = mig["log"]["migrate"]
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    print(f"migrated before step {n_rec + 4}, traced: tokens and carried state bitwise == clean; "
          f"migrate {mig_s:.3f} s (export {ex_s:.4f} s + import {im_s:.4f} s of {state_bytes} B "
          f"carried state; the env's {mig['fleet'].stats.migration_bytes:.0f} B billed to the "
          f"backhaul, moved by reference); wall {mig['wall']:.1f} s")

    seed = FAULT_SEED0
    while True:
        want_retries, want_dedup = predict_losses(seed, clean)
        if want_dedup:
            break
        seed += 1
    lossy = run("lossy", fault=FaultInjector(seed=seed, rpc_loss_prob=FAULT_LOSS))
    same_as_clean("lossy", lossy)
    st = lossy["sess"].client.stats
    check(st.dedup_replies >= 1 and st.retries >= 1,
          f"lossy: {st.retries} retries, {st.dedup_replies} dedup replies")
    check((st.retries, st.dedup_replies) == (want_retries, want_dedup),
          f"lossy: ({st.retries}, {st.dedup_replies}) retries and dedup replies, predicted "
          f"({want_retries}, {want_dedup})")
    print(f"lossy link ({FAULT_LOSS} per message, seed {seed}, the first from {FAULT_SEED0} whose "
          f"draws lose a stateful step's response): {st.retries} retries, {st.dedup_replies} "
          f"dedup replies (as predicted), server dedup hits == dedup replies; tokens and carried "
          f"state bitwise == clean; simulated clock {lossy['steps'][-1][-1]:.3f} s vs clean "
          f"{clean['steps'][-1][-1]:.3f} s; wall {lossy['wall']:.1f} s")

    # the crash lands between two step boundaries, by step index: r0 dies
    # after the step before step k (the stateful step of sequence number
    # FAULT_CRASH_SEQ) and is found dead at k's dispatch.  A crash-only
    # injector and the checkpoints leave the simulated clock as the clean
    # stream's, so its boundaries place the crash
    k = replayed[FAULT_CRASH_SEQ]
    ts = [t for *_, t in clean["steps"]]
    with tempfile.TemporaryDirectory() as ckpt:
        crash = run("crash", fault=FaultInjector(crashes={"r0": 0.5 * (ts[k - 2] + ts[k - 1])}),
                    ckpt_dir=ckpt)
    same_as_clean("crash", crash)
    fs, cl = crash["fleet"].stats, crash["sess"].client
    writes = [(n, sec) for sec, n in crash["log"]["maybe_checkpoint"] if n]
    (restore_s, _), = crash["log"]["recover"]
    check(fs.crashes == 1 and fs.crash_restores == 1 and cl.stats.crash_restores == 1,
          f"crash: {fs.crashes} crashes, {fs.crash_restores} restores")
    check(1 <= fs.checkpoints <= FAULT_MAX_CKPTS and fs.steps_replayed >= 1,
          f"crash: {fs.checkpoints} checkpoints, {fs.steps_replayed} steps replayed")
    check(crash["client"].primary == "r1", "crash: the session is not on r1")
    dead = {t.untyped_storage().data_ptr() for t in crash["crashed"]}
    ctx = crash["fleet"].replica("r1").edge.server.contexts["u0"]
    restored = [*ctx.env.values(), *ctx.replay.carried_state]
    check(all(t.untyped_storage().data_ptr() not in dead for t in restored),
          "crash: the restored session shares storage with the crashed box")
    print(f"crash of r0 before step {k} (stateful seq {FAULT_CRASH_SEQ}): restored on r1 in "
          f"{restore_s:.2f} s, {fs.steps_replayed} logged steps replayed; checkpoints "
          f"{[(n, round(sec, 3)) for n, sec in writes]} (bytes, write s); restored env and state "
          f"share no storage with the crashed box ({len(dead)} tensors held); tokens and carried "
          f"state bitwise == clean; wall {crash['wall']:.1f} s")
    del streams
    return time.perf_counter() - t_part, mig


def zamba_logits_app(cfg, params, bucket):
    """``RRTOServedLM``'s stateless next-token step that also returns the
    last position's logits, so a request's whole result can be held
    bitwise, not only its argmax."""
    from repro_torch.core.offload import OffloadableModel
    from repro_torch.models.registry import get_model

    model = get_model(cfg)

    def next_token(p, padded_tokens, cur_len):
        logits = model.forward(p, {"tokens": padded_tokens}, cfg)
        idx = torch.clamp(cur_len.reshape(1) - 1, 0, padded_tokens.shape[1] - 1)
        last = logits.index_select(1, idx.long())
        return [torch.argmax(last[:, 0, : cfg.vocab], dim=-1).to(torch.int32), last]

    return OffloadableModel(
        name=f"{cfg.name}-nexttoken-logits", apply=next_token, params=params,
        example_inputs=(torch.zeros((1, bucket), dtype=torch.int32),
                        torch.zeros((), dtype=torch.int32)),
    )


def zamba_logits_stream(dev, cfg, params, prompt, bucket, fault=None) -> dict:
    """``FAULT_Z_NEW`` greedy tokens of zamba2 stateless through one session
    on its own ``RRTOEdgeServer``, through :func:`zamba_logits_app`.  With
    ``fault``, one outage window opens at the second replayed request (an
    outage-only injector changes nothing before it, so this is where a clean
    run's boundary would put it)."""
    from repro_torch.serving import RRTOEdgeServer

    edge = RRTOEdgeServer(fault=fault, device=dev)
    sess = edge.connect(zamba_logits_app(cfg, params, bucket), client_id="z0",
                        min_repeats=FAULT_MIN_REPEATS)
    timer = StepTimer(sess)
    buf = np.zeros((1, bucket), np.int32)
    buf[:, : prompt.shape[1]] = prompt
    out = []
    t0 = time.perf_counter()
    for cur in range(prompt.shape[1], prompt.shape[1] + FAULT_Z_NEW):
        modes = [h.mode for h in sess.history]
        if fault is not None and not fault.outages and modes.count("replaying") == 1:
            fault.outages = ((sess.clock.t, sess.clock.t + OUTAGE_S),)
        res = sess.infer(torch.from_numpy(buf.copy()), torch.tensor(cur, dtype=torch.int32))
        out.append(res.outputs[0].numpy()[:, None])
        buf[:, cur] = out[-1][:, 0]
    return dict(sess=sess, timer=timer, tokens=np.concatenate(out, axis=1),
                modes=[h.mode for h in sess.history], wall=time.perf_counter() - t0)


def phase_fault_zamba(dev, cfg, params, prompt, dev_tokens, bucket) -> dict:
    """Part b: zamba2-1.2b stateless, a clean stream and one through an
    outage window (:func:`zamba_logits_stream`).  The outage's request falls
    back to the device and the stream heals.  What the fallback guarantees is
    continuity: every request's outputs, the fallback's logits included, are
    bitwise the clean stream's at the same request, where that request was
    replayed on the server."""
    from repro_torch.core.netsim import FaultInjector

    clean = zamba_logits_stream(dev, cfg, params, prompt, bucket)
    fault = FaultInjector()
    run = zamba_logits_stream(dev, cfg, params, prompt, bucket, fault=fault)
    sess, timer, modes = run["sess"], run["timer"], run["modes"]
    for r in (clean, run):
        check(np.array_equal(r["tokens"], dev_tokens[:, :FAULT_Z_NEW]),
              f"zamba2 outage tokens {r['tokens']} != device_only {dev_tokens[:, :FAULT_Z_NEW]}")
    check(sess.client.stats.outage_fallbacks >= 1 and "outage_fallback" in modes,
          f"zamba2: no outage fallback ({modes})")
    check(modes[-1] == "replaying" and sess.client.mode == "replaying",
          f"zamba2: the stream did not heal ({modes})")
    for mode in ("replaying", "outage_fallback") if dev.type == "cuda" else ():
        for kernel in ("rmsnorm", "flash_attention", "ssm_scan"):
            got = timer.launches(mode, kernel)
            check(bool(got) and all(n > 0 for n in got), f"zamba2 {mode}: {kernel} launches {got}")
    fb = modes.index("outage_fallback")
    check(clean["modes"][fb] == "replaying",
          f"zamba2: the clean stream's request {fb} was not replayed ({clean['modes']})")
    for i, (h, ref) in enumerate(zip(sess.history, clean["sess"].history)):
        check(same_tensors(h.outputs, ref.outputs),
              f"zamba2 outage: request {i} ({h.mode}) outputs differ from the clean stream's "
              f"({ref.mode})")
    print(f"[phase 11b] zamba2-1.2b stateless, outage {fault.outages}: modes "
          f"{[m[:3] for m in modes]} (clean {[m[:3] for m in clean['modes']]}); "
          f"{sess.client.stats.outage_fallbacks} device fallback, healed to replay; the outputs "
          f"of all {len(modes)} requests, token and logits "
          f"{tuple(sess.history[fb].outputs[1].shape)}, bitwise == the clean stream's (the "
          f"fallback's against the clean replay of request {fb}); tokens == phase 5's "
          f"device_only; fallback {1e3 * timer.steps[fb][1]:.1f} ms wall with launches "
          f"{timer.steps[fb][2]}; clean {clean['wall']:.1f} s, outage {run['wall']:.1f} s")
    return dict(modes=modes)


def phase_fault_sensor(dev) -> dict:
    """Part c: the sensor encoder at 96 split by the planner (no replan rate
    limit, so the heal shows at the next sample) under one outage window
    opened at its second replayed inference: ``declare_outage`` installs the
    all-device plan, every output stays bitwise plain rrto's, and the
    session re-offloads once the link is back."""
    from repro_torch.core.netsim import FaultInjector
    from repro_torch.core.offload import OffloadSession
    from repro_torch.models.cnn_zoo import make_sensor_encoder
    from repro_torch.partition import PartitionConfig

    model = make_sensor_encoder(scale=1.0, input_size=96, device=dev)
    fault = FaultInjector()
    split = OffloadSession(model, "rrto", device=dev, fault=fault,
                           partition=PartitionConfig(min_replan_interval_s=0.0))
    plain = OffloadSession(model, "rrto", device=dev)
    cl, plans = split.client, []
    run_split = cl._run_split_replay

    def logged_split():
        # the plan each split inference runs with (a healed link may swap it
        # again at the end of the same inference)
        plans.append(cl.split_plan.n_device_ops)
        run_split()

    cl._run_split_replay = logged_split
    t0 = time.perf_counter()
    for _ in range(SENSOR_OUTAGE_INFERS):
        if not fault.outages and [h.mode for h in split.history].count("replaying") == 1:
            fault.outages = ((split.clock.t, split.clock.t + OUTAGE_S),)
        s, p = split.infer(*model.example_inputs), plain.infer(*model.example_inputs)
        check(same_tensors(s.outputs, p.outputs), f"sensor_encoder split under outage != plain "
              f"rrto in {s.mode}")
    rp = cl.replanner
    n = rp.graph.n_ops
    check(rp.stats.outage_replans == 1 and cl.stats.outage_fallbacks >= 1,
          f"sensor_encoder: {rp.stats.outage_replans} outage replans, "
          f"{cl.stats.outage_fallbacks} outage fallbacks")
    check(n in plans, f"sensor_encoder: the all-device plan was never installed ({plans} of {n})")
    check(plans[-1] < n, f"sensor_encoder: no re-offload after the heal ({plans} of {n})")
    print(f"[phase 11c] sensor_encoder @ 96 under outage {fault.outages}: device ops of each split "
          f"inference {plans} of {n} (the outage plan is all-device, then re-offloaded); outputs bitwise == "
          f"plain rrto; {time.perf_counter() - t0:.1f} s")
    return dict(plans=plans)


# ---------------------------------------------------------------------------
# phase 12: admission and overload
# ---------------------------------------------------------------------------
OVER_CLIENTS = (("z0", "gold"), ("z1", "silver"), ("z2", "bronze"), ("z3", "bronze"))
# benchmarks/load_knee.py: each tenant's share of the offered load (Zipf
# within a tenant), the admission rate as a fraction of the measured
# capacity, the idle gap before each phase and the p99 bound beyond the knee
OVER_POPULATION = {"gold": 0.15, "silver": 0.30, "bronze": 0.55}
ADMIT_FRACTION, DRAIN_GAP_S, P99_RATIO_BOUND = 0.8, 0.05, 0.5
OVER_PHASES = ((0.25, 16), (4.0, 24))    # (offered load / capacity, requests)
OVER_SEED = 0
# the token buckets' burst.  load_knee keeps the default (the queue limit,
# in_flight + 16 tokens), sized for phases of 420 requests; a phase of ~16
# fits inside it, so nothing would ever be denied.  The steady in-flight
# level plus 2 lets the light phase through and runs dry in the heavy one
OVER_BURST_EXTRA = 2
OVER_Q_NEW, OVER_Q_SHED_AT = 8, 3        # qwen3-0.6b tokens; shed after the 3rd (part c)
OVER_SPLIT_MAX = 400                     # sensor inferences allowed for the restore (part d)


def attach_admission(edge, adm) -> None:
    """Attach a controller to a warm edge, the reference's idiom: recording
    never competes with the load for tokens."""
    adm.bind(server=edge.server, ingress=edge.ingress)
    edge.admission = adm
    edge.batcher.admission = adm
    for cid, sess in edge.sessions.items():
        adm.register(cid, sess.tenant)
        sess.admission = adm


def over_request(prompt, dev_tokens, bucket, j) -> tuple:
    """The zamba2 step at position ``prompt_len + j``: the buffer holds the
    prompt and the first ``j`` of phase 5's ``device_only`` tokens, so its
    token must be ``dev_tokens[0, j]``."""
    n = prompt.shape[1]
    buf = np.zeros((1, bucket), np.int32)
    buf[:, :n] = prompt
    buf[:, n:n + j] = dev_tokens[:, :j]
    return torch.from_numpy(buf), torch.tensor(n + j, dtype=torch.int32)


def over_schedule(offered_hz, n_requests, seed) -> list:
    """``load_knee._phase_schedule`` over this phase's clients: each
    client's Poisson stream seeded by ``client_stream_seed``, merged."""
    from repro_torch.core.netsim import client_stream_seed, poisson_arrivals

    by_tenant = {}
    for cid, tenant in OVER_CLIENTS:
        by_tenant.setdefault(tenant, []).append(cid)
    duration = n_requests / offered_hz
    events = []
    for tenant, cids in by_tenant.items():
        zipf = [1.0 / (1 + rank) for rank in range(len(cids))]
        for cid, z in zip(cids, zipf):
            rate = offered_hz * OVER_POPULATION[tenant] * z / sum(zipf)
            offs = poisson_arrivals(rate, max(1, round(rate * duration)),
                                    seed=client_stream_seed(seed, cid))
            events.extend((off, cid) for off in offs)
    return sorted(events)


def drive_overload(edge, events, served, req) -> list:
    """``load_knee._drive_phase``: open loop, the clock set to each arrival.
    Request k of a client is the step at position ``prompt_len + k mod
    Z_NEW``.  A shed is counted and checked, never swallowed."""
    from repro_torch.serving.admission import AdmissionRejectedError

    t0 = max(edge.clock.t, edge.server.busy_until) + DRAIN_GAP_S
    out = []
    for off, cid in events:
        j = served[cid] % Z_NEW
        served[cid] += 1
        edge.clock.t = t0 + off
        try:
            r = edge.sessions[cid].infer(*req(j))
        except AdmissionRejectedError as e:
            check(e.client_id == cid and e.retry_after_s > 0,
                  f"{edge.name}: shed of {cid} without a retry-after ({e})")
            out.append(dict(cid=cid, j=j, mode="shed", err=e))
            continue
        out.append(dict(cid=cid, j=j, mode=r.mode, outputs=r.outputs, wall=r.wall_seconds))
    return out


def p99(xs) -> float:
    return float(np.percentile(np.asarray(xs), 99)) if xs else 0.0


def phase_overload(dev, cfg, params, prompt, dev_tokens, bucket) -> dict:
    """Part a: zamba2-1.2b stateless (:func:`zamba_logits_app`, phase 5's
    weights and prompt) on an edge of four clients, gold / silver / bronze /
    bronze, warmed into replay, then guarded by an admission controller
    calibrated as ``benchmarks/load_knee.py`` calibrates; its twin edge has
    no controller.  Both edges take the same open-loop Poisson schedule, a
    phase below the knee and one beyond it.  The guarded edge and its
    controller are traced, the controller's counters and the ingress depth
    in the edge's registry (phase 13d reads them), and the guarded edge runs
    the replay soundness verifier at each client's lock; the twin does
    neither, so every response bitwise the twin's also holds verify on ==
    off."""
    from repro_torch.obs import Tracer
    from repro_torch.serving import RRTOEdgeServer
    from repro_torch.serving.admission import AdmissionController, SLOClass

    t_part = time.perf_counter()
    app = zamba_logits_app(cfg, params, bucket)

    def req(j):
        return over_request(prompt, dev_tokens, bucket, j)

    edges, timers, hooks = {}, {}, HookTimer()
    tracer = Tracer()
    for name in ("guarded", "twin"):
        edge = RRTOEdgeServer(name=name, device=dev, tracer=tracer if name == "guarded" else None,
                              verify=name == "guarded")
        for cid, tenant in OVER_CLIENTS:
            sess = edge.connect(app, client_id=cid, tenant=tenant, min_repeats=FAULT_MIN_REPEATS)
            timers[name, cid] = StepTimer(sess)
            check(sess.client.verify == (name == "guarded"), f"{name} {cid}: verify not the edge's")
        for cid, sess in edge.sessions.items():
            with hooks:
                while sess.client.mode != "replaying" and len(sess.history) < 4:
                    res = sess.infer(*req(0))
                    check(int(res.outputs[0][0]) == int(dev_tokens[0, 0]),
                          f"{name} {cid}: warm-up token {res.outputs[0]} != device_only")
            check(sess.client.mode == "replaying", f"{name} {cid}: never reached replaying")
        edges[name] = edge
    guarded, twin = edges["guarded"], edges["twin"]
    check(len(hooks.calls) >= len(OVER_CLIENTS), f"12a: the verifier ran {len(hooks.calls)} times")
    print(f"[phase 12a] the guarded edge's verifier at its {len(OVER_CLIENTS)} clients' locks: "
          f"{hooks.summary()}")
    check(guarded.clock.t == twin.clock.t, "the twin edges warmed up on different clocks")
    warm_s = time.perf_counter() - t_part

    # calibration (load_knee._calibrate): one replayed request on each edge
    cal = {name: edge.sessions["z0"].infer(*req(1)) for name, edge in edges.items()}
    check(same_tensors(cal["guarded"].outputs, cal["twin"].outputs), "calibration outputs differ")
    compute_s, wall_s = cal["guarded"].server_busy_seconds, cal["guarded"].wall_seconds
    device_s = guarded.sessions["z0"].device_fallback_seconds()
    capacity = 1.0 / compute_s
    in_flight = int(np.ceil(wall_s / compute_s))
    classes = {
        "gold": SLOClass("gold", deadline_s=0.5 * device_s, priority=2, weight=4.0),
        "silver": SLOClass("silver", deadline_s=max(10 * device_s, 0.05), priority=1, weight=2.0),
        "bronze": SLOClass("bronze", deadline_s=max(20 * device_s, 0.2), priority=0, weight=1.0),
    }
    adm = AdmissionController(queue_limit=in_flight + 16, rate_hz=ADMIT_FRACTION * capacity,
                              burst=in_flight + OVER_BURST_EXTRA, borrow_depth=in_flight + 8,
                              classes=classes, tracer=tracer, metrics=guarded.metrics)
    attach_admission(guarded, adm)
    print(f"[phase 12a] calibration (simulated clock): a replayed request occupies the server "
          f"{1e3 * compute_s:.3f} ms (capacity {capacity:.1f} req/s), its wall {1e3 * wall_s:.3f} "
          f"ms (in flight {in_flight}), the device fallback {1e3 * device_s:.3f} ms; admission "
          f"at {adm.rate_hz:.1f} req/s, burst {adm.burst:g}, queue limit {adm.queue_limit}, "
          f"borrow depth {adm.borrow_depth}; budgets (ms) "
          f"{ {n: round(1e3 * c.deadline_s, 3) for n, c in classes.items()} }")

    runs = []
    served = {name: {cid: 2 for cid, _ in OVER_CLIENTS} for name in edges}
    for k, (mult, n) in enumerate(OVER_PHASES):
        events = over_schedule(mult * capacity, n, OVER_SEED + 1000 + k)
        got = drive_overload(guarded, events, served["guarded"], req)
        ref = drive_overload(twin, events, served["twin"], req)
        runs.append((mult, got, ref))
    for mult, got, ref in runs:
        check(all(r["mode"] == "replaying" for r in ref),
              f"the twin did not replay every request at {mult}x: {[r['mode'] for r in ref]}")
        for i, (g, r) in enumerate(zip(got, ref)):
            check(int(r["outputs"][0][0]) == int(dev_tokens[0, r["j"]]),
                  f"twin request {i} at {mult}x: token != device_only")
            if g["mode"] != "shed":
                check(same_tensors(g["outputs"], r["outputs"]),
                      f"request {i} at {mult}x ({g['mode']}): outputs differ from the twin's replay")
        modes = Counter(g["mode"] for g in got)
        adm_lat = [g["wall"] for g in got if g["mode"] == "replaying"]
        ratio = p99(adm_lat) / p99([r["wall"] for r in ref])
        print(f"[phase 12a] {mult}x capacity, {len(got)} requests: {dict(modes)}; admitted p99 "
              f"{1e3 * p99(adm_lat):.3f} ms, twin p99 {1e3 * p99([r['wall'] for r in ref]):.3f} ms "
              f"(simulated clock; ratio {ratio:.3f})")
        if mult < 1.0:
            check(modes == {"replaying": len(got)}, f"below the knee not all admitted: {dict(modes)}")
        else:
            check(modes["shed"] >= 1, f"beyond the knee: no typed shed ({dict(modes)})")
            check(modes["degraded_device"] >= 1, f"beyond the knee: no degraded_device ({dict(modes)})")
            check(ratio <= P99_RATIO_BOUND, f"beyond the knee: admitted p99 {ratio:.3f} x the twin's")
    if dev.type == "cuda":
        for mode in ("replaying", "degraded_device"):
            for kernel in ("rmsnorm", "flash_attention", "ssm_scan"):
                got = [n for cid, _ in OVER_CLIENTS for n in timers["guarded", cid].launches(mode, kernel)]
                check(bool(got) and all(n > 0 for n in got), f"12a {mode}: {kernel} launches {got}")
    shares = adm.admitted_shares()
    wall = {mode: np.mean([t for cid, _ in OVER_CLIENTS for m, t, _ in timers["guarded", cid].steps
                           if m == mode]) for mode in ("replaying", "degraded_device")}
    step = next(n for m, _, n in timers["guarded", "z1"].steps if m == "replaying")
    deg = next(n for cid, _ in OVER_CLIENTS for m, _, n in timers["guarded", cid].steps
               if m == "degraded_device")
    print(f"[phase 12a] tenants' admitted share against their weight share: "
          f"{ {t: (round(shares.get(t, 0.0), 3), round(adm.weight_share(t), 3)) for t in classes} }; "
          f"stats {adm.stats.as_dict()}; edge summary queue depth {guarded.summary()['queue_depth']}")
    print(f"[phase 12a] host wall per request: replayed {1e3 * wall['replaying']:.1f} ms, "
          f"degraded_device {1e3 * wall['degraded_device']:.1f} ms, shed 0; launches of a replayed "
          f"request {step}, of a degraded one {deg}; every returned response, token and logits "
          f"{tuple(cal['guarded'].outputs[1].shape)}, bitwise == the twin's replay; tokens == phase 5's "
          f"device_only; warm-up {warm_s:.1f} s, part {time.perf_counter() - t_part:.1f} s")
    decisions = [[(g["cid"], g["j"], g["mode"]) for g in got] for _, got, _ in runs]
    return dict(edges=edges, classes=classes, req=req, replay_launches=step, adm=adm,
                tracer=tracer, decisions=decisions)


def phase_round_formation(library, over) -> None:
    """Part b: the same four sessions under a controller that sheds nothing
    and ``round_capacity = 2``.  One ``run_round`` over all four: the pair
    ``drr_select`` picks from the EDF order runs as one vmap batch of width
    2, the other two replay solo, and every output is bitwise the uncapped
    twin round's (a vmap batch of 4) and its lane loop's."""
    from repro_torch.core.engine import no_vmap_fallback
    from repro_torch.serving.admission import AdmissionController, drr_select

    t_part = time.perf_counter()
    guarded, twin = over["edges"]["guarded"], over["edges"]["twin"]
    inert = AdmissionController(rate_hz=1e12, burst=1e12, queue_limit=10**9,
                                classes=over["classes"])
    attach_admission(guarded, inert)
    batcher = guarded.batcher
    batcher.round_capacity = 2
    # the expected pair: EDF (deadline, then priority, then arrival) at the
    # round's stamp time, then DRR from the batcher's current deficits
    t = guarded.clock.t
    order = [cid for _, (cid, tenant) in sorted(
        enumerate(OVER_CLIENTS),
        key=lambda it: (inert.deadline_for(it[1][0], t), -inert.slo(it[1][1]).priority, it[0]))]
    want = drr_select(order, 2, inert.tenant_of, lambda tenant: inert.slo(tenant).weight,
                      dict(batcher._drr_deficits))
    log = []
    inner = batcher._run_vmap_batch

    def logged(fp, members, params_flat):
        before = dict(library.LAUNCHES)
        group = inner(fp, members, params_flat)
        log.append(([cl.client_id for cl, _ in members],
                    {k: n - before[k] for k, n in library.LAUNCHES.items()}))
        return group

    batcher._run_vmap_batch = logged
    solo0, vmap0 = batcher.solo_replays, batcher.vmap_batches

    def round_inputs():
        return {cid: over["req"](i) for i, (cid, _) in enumerate(OVER_CLIENTS)}

    with no_vmap_fallback():
        capped = guarded.run_round(round_inputs())
        free = twin.run_round(round_inputs())
        twin.batcher.enable_vmap = False
        loop = twin.run_round(round_inputs())
    check(len(log) == 1 and log[0][0] == want,
          f"12b: batched members {[ids for ids, _ in log]}, drr_select on the EDF order {order} "
          f"picks {want}")
    check(batcher.vmap_batches == vmap0 + 1 and batcher.batch_sizes[-1] == 2,
          f"12b: vmap batches {batcher.vmap_batches - vmap0}, widths {batcher.batch_sizes}")
    check(batcher.solo_replays == solo0 + 2, f"12b: solo replays rose by {batcher.solo_replays - solo0}")
    check(twin.batcher.batch_sizes[-2:] == [4, 4], f"12b twin widths {twin.batcher.batch_sizes}")
    for i, (cid, _) in enumerate(OVER_CLIENTS):
        check(capped[cid].mode == "replaying", f"12b {cid}: {capped[cid].mode}")
        check(same_tensors(capped[cid].outputs, free[cid].outputs)
              and same_tensors(capped[cid].outputs, loop[cid].outputs),
              f"12b {cid}: the capped round's outputs differ from the uncapped round's or the loop's")
    launched = log[0][1]
    if guarded.server.device.type == "cuda":
        for kernel in ("rmsnorm", "flash_attention", "ssm_scan"):
            check(launched[kernel] == over["replay_launches"][kernel],
                  f"12b: the width-2 call launched {kernel} {launched[kernel]} times, a solo step "
                  f"{over['replay_launches'][kernel]}")
    print(f"[phase 12b] EDF order {order} -> DRR picks {want} batched at width 2 "
          f"(launches {launched}: each kernel once for both lanes), the other two solo; outputs "
          f"bitwise == the uncapped twin round (width 4) and its lane loop; "
          f"{time.perf_counter() - t_part:.1f} s")


def phase_overload_stateful(dev, cfg, params, prompt, dev_tokens, bucket) -> dict:
    """Part c: qwen3-0.6b stateful on an edge that runs the replay soundness
    verifier at the lock (the donation pass proves the KV caches' carried
    pairs).  After the third token a zero-capacity controller sheds the next
    step twice, under gold's tiny budget and under an unbounded one (a
    stateful session cannot take the device fallback); no step runs and the
    carried state is untouched.  Detached, the decode goes on to phase 3's
    ``device_only`` tokens.  Returns the edge and session (phase 14 reads
    the locked IOS)."""
    from repro_torch.serving import RRTOEdgeServer, RRTOServedLM
    from repro_torch.serving.admission import AdmissionController, AdmissionRejectedError, SLOClass

    t_part = time.perf_counter()
    edge = RRTOEdgeServer(device=dev, verify=True)
    lm = RRTOServedLM(cfg, bucket_len=bucket, params=params, edge=edge, client_id="q0",
                      min_repeats=FAULT_MIN_REPEATS)
    sess = lm.session
    g = lm.start_generation(prompt, OVER_Q_NEW)
    with HookTimer() as hooks:
        while len(g["out"]) < OVER_Q_SHED_AT:
            lm.absorb_step(g, sess.infer(*lm.step_inputs(g)).outputs)
    check(sess.client.stateful_replay, "12c: the decode is not in stateful replay")
    check(sess.client.verify and len(hooks.calls) >= 2,
          f"12c: the verifier ran {len(hooks.calls)} times at the lock")
    print(f"[phase 12c] the verifier at the lock ({len(sess.client._ios_calls)} records, "
          f"{len(sess.client.ios.carried_pairs)} carried pairs): {hooks.summary()}")
    state0, seq0, n0 = edge.server.export_carried_state("q0"), sess.client.step_seq, len(sess.history)
    sheds = []
    for budget in (1e-12, 1e9):
        adm = AdmissionController(rate_hz=1e-6, burst=0.0, classes={
            "gold": SLOClass("gold", deadline_s=budget, priority=2, weight=4.0)})
        adm.bind(server=edge.server, ingress=edge.ingress)
        adm.register("q0", "gold")
        sess.admission = adm
        try:
            sess.infer(*lm.step_inputs(g))
        except AdmissionRejectedError as e:
            check(e.retry_after_s > 0 and e.tenant == "gold", f"12c: shed without retry-after ({e})")
            sheds.append(e.retry_after_s)
        else:
            fail(f"12c: a stateful step under a budget of {budget} s was not shed")
        check(adm.stats.shed == 1 and adm.stats.degraded_device == 0,
              f"12c: budget {budget}: {adm.stats.as_dict()}")
    state1 = edge.server.export_carried_state("q0")
    check(sess.client.step_seq == seq0 and len(sess.history) == n0,
          f"12c: a shed step ran (step_seq {seq0} -> {sess.client.step_seq})")
    check(same_tensors(state0, state1), "12c: the carried state changed under the sheds")
    sess.admission = None
    for _ in range(lm.steps_total(g) - g["pos"]):
        lm.absorb_step(g, sess.infer(*lm.step_inputs(g)).outputs)
    tokens = np.concatenate(g["out"], axis=1)
    check(np.array_equal(tokens, dev_tokens[:, :OVER_Q_NEW]),
          f"12c: tokens {tokens} != device_only {dev_tokens[:, :OVER_Q_NEW]}")
    nbytes = sum(t.numel() * t.element_size() for t in state0)
    print(f"[phase 12c] qwen3-0.6b stateful: shed twice after token {OVER_Q_SHED_AT} (gold budget "
          f"1e-12 s and 1e9 s; retry after {[round(r, 6) for r in sheds]} s simulated), step_seq "
          f"{seq0} unchanged, the {nbytes} B carried state bitwise unchanged; detached, "
          f"{OVER_Q_NEW} tokens == phase 3's device_only; {time.perf_counter() - t_part:.1f} s")
    return dict(edge=edge, sess=sess)


def phase_overload_split(dev) -> None:
    """Part d: the sensor encoder at 96 split by the planner, against an
    idle twin.  Under a zero-capacity controller whose budget cannot cover
    the device fallback, one request takes tier 1 (``degraded_split``: the
    device-heavy plan), bitwise the twin's; detached, ``observe`` restores
    the planner's cut once ``min_replan_interval_s`` has passed."""
    from repro_torch.core.offload import OffloadSession
    from repro_torch.models.cnn_zoo import make_sensor_encoder
    from repro_torch.partition import PartitionConfig
    from repro_torch.serving.admission import AdmissionController, SLOClass

    t_part = time.perf_counter()
    model = make_sensor_encoder(scale=1.0, input_size=96, device=dev)
    cfg = PartitionConfig()
    split = OffloadSession(model, "rrto", device=dev, partition=cfg)
    idle = OffloadSession(model, "rrto", device=dev, partition=cfg)
    x = model.example_inputs

    def both(label):
        s, w = split.infer(*x), idle.infer(*x)
        check(same_tensors(s.outputs, w.outputs), f"12d {label} ({s.mode}): outputs differ")
        return s

    for _ in range(5):
        both("warm-up")
    cl = split.client
    check(cl.mode == "replaying" and cl.split_plan is not None, "12d: no split replay")
    plan0, n0 = cl.split_plan.signature(), cl.split_plan.n_device_ops
    adm = AdmissionController(rate_hz=1e-6, burst=0.0, default_class=SLOClass(deadline_s=1e-12))
    split.admission = adm
    adm.register(split.client_id)
    t_deg = split.clock.t
    r = both("degraded")
    n_deg = cl.split_plan.n_device_ops
    check(r.mode == "degraded_split" and n_deg > n0, f"12d: {r.mode}, device ops {n0} -> {n_deg}")
    check(cl.replanner.stats.overload_degrades == 1 and adm.stats.degraded_split == 1,
          f"12d: {cl.replanner.stats.overload_degrades} overload degrades, {adm.stats.as_dict()}")
    split.admission = None
    after = []
    for _ in range(OVER_SPLIT_MAX):
        both("after")
        after.append((split.clock.t - t_deg, cl.split_plan.signature()))
        if after[-1][1] == plan0:
            break
    check(after[-1][1] == plan0, f"12d: the cut {plan0} never came back ({after[-1]})")
    check(after[-1][0] >= cfg.min_replan_interval_s and all(p != plan0 for _, p in after[:-1]),
          f"12d: restored after {after[-1][0]:.4f} s, before min_replan_interval_s")
    print(f"[phase 12d] sensor_encoder @ 96: plan {plan0} ({n0} device ops) -> degraded_split with "
          f"{n_deg} of {cl.replanner.graph.n_ops} device ops, bitwise the idle twin; detached, "
          f"back on {plan0} after {len(after)} inferences ({after[-1][0]:.4f} s simulated, "
          f"interval {cfg.min_replan_interval_s} s); {time.perf_counter() - t_part:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: observability
# ---------------------------------------------------------------------------
# tests/test_obs.py's TestTracedFleet schedule: 8 requests until the IOS
# locks and replays (2 recorded: 6 replays keep the router's median, and so
# its deadline, at a replay's latency), then 6 with the primary stalled by
# this many simulated seconds (the router hedges to r1: the first race meets
# r1's recording, the next ones its replay), then 2 un-stalled
OBS_WARM, OBS_STALLED, OBS_AFTER, OBS_STALL_S = 8, 6, 2, 1.0
OBS_PLAN_MBPS = 8.0          # part c's operating point
OBS_HOST_PAIRS = 6           # part e: replayed steps with the tracer attached / detached
OBS_TRACE = os.path.join(ROOT, "traces", "phase13_trace.json")
# phase 12a's decisions at full width, below the knee and beyond it: they
# run on the simulated clock, so every card and every run gives these,
# traced or not (an untraced edge gave them before the tracer existed)
KNEE_DECISIONS = ({"replaying": 16}, {"replaying": 10, "degraded_device": 12, "shed": 2})


def monotone_tracks(tracer) -> None:
    """Every span closes after it opens, and each track's spans open in
    nondecreasing simulated time (tests/test_obs.py)."""
    check(all(sp.t1 is None or sp.t1 >= sp.t0 for sp in tracer.spans), "a span ends before it begins")
    last = {}
    for sp in tracer.spans:
        check(sp.t0 >= last.get(sp.track, 0.0), f"track {sp.track} went backwards at {sp.name}")
        last[sp.track] = sp.t0
    check(all(i.t >= 0.0 for i in tracer.instants), "an instant before time 0")


def names_by_track(tracer) -> dict:
    out = {}
    for ev in (*tracer.spans, *tracer.instants):
        out.setdefault(ev.track, set()).add(ev.name)
    return out


def snapshot_agrees(fleet, clients) -> dict:
    """``fleet.metrics.snapshot()`` against every stats surface it backs
    (tests/test_obs.py::test_root_snapshot_agrees_with_legacy_counters):
    the fleet's and router's counters, each replica's cache and batcher,
    and each listed client's sessions under the replica that connected
    them (``clients``: client id -> {scope replica: session})."""
    snap = fleet.metrics.snapshot()
    fs, rs = fleet.stats, fleet.router.stats
    for name, value in fs.as_dict().items():
        check(snap[f"fleet.{name}"] == value, f"snapshot fleet.{name} {snap[f'fleet.{name}']} != {value}")
    for name in ("requests", "hedged", "primary_wins", "hedge_wins", "failures_recovered",
                 "total_latency_s"):
        check(snap[f"hedge.{name}"] == getattr(rs, name), f"snapshot hedge.{name} differs")
    check(snap["hedge.latency_s"]["count"] == len(rs.latencies), "snapshot hedge.latency_s differs")
    for i, rep in enumerate(fleet.replicas):
        for name, value in rep.edge.cache.stats.as_dict().items():
            if name != "hit_rate":
                check(snap[f"r{i}.cache.{name}"] == value, f"snapshot r{i}.cache.{name} differs")
        for name, value in rep.edge.batcher.stats.as_dict().items():
            check(snap[f"r{i}.batcher.{name}"] == value, f"snapshot r{i}.batcher.{name} differs")
    for cid, sessions in clients.items():
        for scope, sess in sessions.items():
            for name, value in sess.client.stats.as_dict().items():
                key = f"{scope}.client.{cid}.{name}"
                check(snap[key] == value, f"snapshot {key} {snap[key]} != {value}")
    return snap


def obs_hedged_fleet(dev, app, req, tracer) -> dict:
    """One run of the hedged schedule through ``EdgeFleet(2, hedging=True,
    min_observations=4)``; request k asks for the token at ``prompt_len +
    k mod Z_NEW``.  Returns the fleet, the client and each request's
    outputs, mode, completion latency, winner and simulated clock."""
    from repro_torch.serving import EdgeFleet

    fleet = EdgeFleet(2, hedging=True, min_observations=4, tracer=tracer, device=dev)
    c = fleet.connect(app, client_id="u0", min_repeats=FAULT_MIN_REPEATS)
    reqs = []
    for n, stall in ((OBS_WARM, None), (OBS_STALLED, OBS_STALL_S), (OBS_AFTER, 0.0)):
        if stall is not None:
            fleet.replica(c.primary).slowdown = lambda i, s=stall: s
        for _ in range(n):
            j = len(reqs) % Z_NEW
            res, latency, winner = c.dispatch(*req(j))
            reqs.append(dict(j=j, mode=res.mode, outputs=res.outputs, latency=latency,
                             winner=winner, t=fleet.clock.t))
        if stall is None:
            check(c.session.client.mode == "replaying", "13a: the primary never reached replaying")
    return dict(fleet=fleet, client=c, reqs=reqs)


def phase_obs_fleet(dev, cfg, params, prompt, dev_tokens, bucket, tracer) -> dict:
    """Part a: zamba2-1.2b stateless (:func:`zamba_logits_app`, phase 5's
    weights) through a traced hedged fleet and its untraced twin, on the
    same schedule.  Tracing must change nothing: every response (token and
    logits), winner, latency and simulated clock, the client counters and
    the fleet's, router's and backhaul's summaries equal the twin's.  At
    least one request races, its loser annotated cancelled, and the root
    snapshot agrees with every counter."""
    t_part = time.perf_counter()
    app = zamba_logits_app(cfg, params, bucket)

    def req(j):
        return over_request(prompt, dev_tokens, bucket, j)

    secs = {}
    runs = {}
    for name, tr in (("traced", tracer), ("twin", None)):
        t0 = time.perf_counter()
        runs[name] = obs_hedged_fleet(dev, app, req, tr)
        secs[name] = time.perf_counter() - t0
    got, twin = runs["traced"], runs["twin"]
    for i, (x, y) in enumerate(zip(got["reqs"], twin["reqs"])):
        check(int(x["outputs"][0][0]) == int(dev_tokens[0, x["j"]]),
              f"13a request {i}: token {x['outputs'][0]} != device_only {dev_tokens[0, x['j']]}")
        check(same_tensors(x["outputs"], y["outputs"]), f"13a request {i}: outputs differ from the twin's")
        check(all(x[k] == y[k] for k in ("mode", "latency", "winner", "t")),
              f"13a request {i}: {[(x[k], y[k]) for k in ('mode', 'latency', 'winner', 't')]}")
    check(len(got["reqs"]) == len(twin["reqs"]) == OBS_WARM + OBS_STALLED + OBS_AFTER,
          "13a: the twins served different request counts")
    fleet, c = got["fleet"], got["client"]
    check(sorted(c.sessions) == sorted(twin["client"].sessions), "13a: different sessions")
    for name, sess in c.sessions.items():
        check(sess.client.stats.as_dict() == twin["client"].sessions[name].client.stats.as_dict(),
              f"13a: {name}'s client counters differ from the twin's")
    sa, sb = fleet.summary(), twin["fleet"].summary()
    for key in ("fleet", "router", "backhaul_bytes"):
        check(sa[key] == sb[key], f"13a: summary {key} {sa[key]} != the twin's {sb[key]}")
    by_req = {}
    for sp in tracer.find("hedge_dispatch"):
        by_req.setdefault((sp.args["client"], sp.args["req"]), []).append(sp)
    raced = [sps for sps in by_req.values() if len(sps) >= 2]
    check(raced and len(raced) == fleet.router.stats.hedged,
          f"13a: {len(raced)} raced requests, the router hedged {fleet.router.stats.hedged}")
    for sps in raced:
        check(len(sps) == 2 and {sp.args["role"] for sp in sps} == {"primary", "backup"},
              f"13a: race roles {[sp.args['role'] for sp in sps]}")
        check(sum(sp.args["winner"] for sp in sps) == 1, "13a: a race without exactly one winner")
        check(all(sp.args["cancelled"] == (not sp.args["winner"]) for sp in sps),
              "13a: the race loser is not annotated cancelled")
    check(fleet.stats.backup_sessions == 1 and c.sessions["r1"].client.stats.cache_adoptions == 1,
          f"13a: backup sessions {fleet.stats.backup_sessions}; r1 did not adopt through the cache")
    monotone_tracks(tracer)
    snap = snapshot_agrees(fleet, {"u0": c.sessions})
    winners = Counter(sp.args["role"] for sps in raced for sp in sps if sp.args["winner"])
    print(f"[phase 13a] zamba2-1.2b stateless, EdgeFleet(2, hedging) traced and untraced: "
          f"{len(got['reqs'])} requests each ({OBS_WARM} warm, {OBS_STALLED} with r0 stalled "
          f"{OBS_STALL_S} s, {OBS_AFTER} after); every token == device_only, every response "
          f"(token and logits), winner, latency and simulated clock bitwise the twin's, client "
          f"counters and summaries equal; {len(raced)} races (winners {dict(winners)}), losers "
          f"cancelled; r1's backup adopted the IOS through the cache tier; the snapshot's "
          f"{len(snap)} keys agree with every counter; {tracer.n_events} events on "
          f"{len(tracer.tracks())} tracks; traced {secs['traced']:.1f} s, twin {secs['twin']:.1f} s")
    return dict(secs=secs, races=len(raced))


def phase_obs_migrated(mig) -> None:
    """Part b: the trace of phase 11a's migrated qwen3-0.6b stream (moved r0
    -> r1 before step ``n_rec + 4``), which ran traced and bitwise the clean
    untraced stream in tokens and final carried state.  Its trace must hold
    the recorded RPCs, the replays, the migration and the state transfer on
    monotone tracks, and the root snapshot must agree with every counter."""
    fleet, tracer = mig["fleet"], mig["fleet"].tracer
    check(fleet.stats.migrations == 1 and fleet.locate("u0").name == "r1",
          f"13b: migrations {fleet.stats.migrations}")
    names = names_by_track(tracer)
    on = {rep: set().union(*(v for k, v in names.items() if k.startswith(f"{rep}/")))
          for rep in ("r0", "r1")}
    check({"record_rpc", "replay_call"} <= on["r0"] and "gpu_exec" in on["r1"],
          f"13b: r0's tracks hold {sorted(on['r0'])}, r1's {sorted(on['r1'])}")
    check({"migrate", "state_transfer"} <= names.get("fleet", set()),
          f"13b: the fleet track holds {sorted(names.get('fleet', ()))}")
    (span,) = tracer.find("migrate")
    check(span.args["src"] == "r0" and span.args["dst"] == "r1"
          and span.args["bytes"] == fleet.stats.migration_bytes, f"13b: migrate span {span.args}")
    monotone_tracks(tracer)
    snap = snapshot_agrees(fleet, {"u0": {"r0": mig["sess"]}})
    print(f"[phase 13b] phase 11a's migrated qwen3-0.6b stream, traced there ({len(mig['steps'])} "
          f"steps, tokens and final carried state bitwise the clean untraced stream's): migrate "
          f"span r0 -> r1 of {span.args['bytes']:.0f} B; {len(snap)} snapshot keys agree; r0's "
          f"tracks {sorted(on['r0'])}, r1's {sorted(on['r1'])}; {tracer.n_events} events")


def phase_obs_plan(graph) -> None:
    """Part c: ``plan_partition`` on phase 10a's locked qwen3-0.6b IOS
    graph with a tracer: one ``plan_explain`` instant whose chosen plan is
    the returned one and the cheapest of its candidates; the untraced call
    returns the same plan at the same cost."""
    from repro_torch.core.costmodel import GTX_2080TI, JETSON_XAVIER_NX
    from repro_torch.obs import Tracer
    from repro_torch.partition import plan_cost, plan_partition

    bw = OBS_PLAN_MBPS * 1e6 / 8
    tracer = Tracer()
    t0 = time.perf_counter()
    best = plan_partition(graph, JETSON_XAVIER_NX, GTX_2080TI, bw, tracer=tracer,
                          trace_track="planner", now=0.0)
    traced_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = plan_partition(graph, JETSON_XAVIER_NX, GTX_2080TI, bw)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    explains = [i for i in tracer.instants if i.name == "plan_explain"]
    check(len(explains) == 1 and tracer.n_events == 1, f"13c: {tracer.n_events} events")
    ev = explains[0]
    rows = ev.args["candidates"]
    cheapest = min(rows, key=lambda r: r["cost"])
    check(ev.args["chosen"] == best.plan.signature() == cheapest["plan"],
          f"13c: chosen {ev.args['chosen']}, returned {best.plan.signature()}, cheapest "
          f"{cheapest['plan']}")
    check(cheapest["cost"] == plan_cost(best, "latency"), "13c: the chosen row's cost differs")
    check(plain.plan.signature() == best.plan.signature() and plain.seconds == best.seconds,
          "13c: the untraced planner chose differently")
    json.dumps(ev.args)   # plain values only
    print(f"[phase 13c] plan_partition on phase 10a's qwen3-0.6b IOS ({graph.n_ops} ops, stateful) "
          f"at {OBS_PLAN_MBPS} Mbps: one plan_explain of {len(rows)} candidates, chosen "
          f"{best.plan.signature()} == the cheapest ({1e3 * cheapest['cost']:.3f} ms simulated) == "
          f"the untraced call's; planner host {traced_ms:.1f} ms traced, {plain_ms:.1f} ms untraced")


def phase_obs_admission(over) -> None:
    """Part d: phase 12a's guarded edge, which ran traced with its
    controller's ``metrics=edge.metrics``.  Its decisions equal
    :data:`KNEE_DECISIONS` (12a held every response bitwise its untraced
    twin's); the snapshot holds the ingress queue depth and the batcher's
    pending depth, and each decision is one ``admission`` instant."""
    edge, adm, tracer = over["edges"]["guarded"], over["adm"], over["tracer"]
    counts = tuple(dict(Counter(m for *_, m in d)) for d in over["decisions"])
    check(counts == KNEE_DECISIONS, f"13d: decisions {counts}, expected {KNEE_DECISIONS}")
    snap = edge.metrics.snapshot()
    check("queue_depth" in snap and "batcher.pending_depth" in snap,
          f"13d: snapshot keys {sorted(snap)}")
    check(snap["queue_depth"] == edge.ingress.queue_depth, "13d: the ingress gauge differs")
    for name, value in adm.stats.as_dict().items():
        check(snap[name] == value, f"13d: snapshot {name} {snap[name]} != {value}")
    instants = [i for i in tracer.instants if i.name == "admission"]
    n = sum(len(d) for d in over["decisions"])
    check(len(instants) == n and adm.stats.requests == n,
          f"13d: {len(instants)} admission instants for {n} decisions")
    check(Counter(i.args["action"] for i in instants)
          == Counter({"admit": adm.stats.admitted, "degrade_device": adm.stats.degraded_device,
                      "shed": adm.stats.shed}), "13d: the instants' actions differ from the counters")
    depth = [c for c in tracer.counters if c.name == "queue_depth"]
    check(bool(depth), "13d: no queue_depth samples on the ingress track")
    # no per-track monotonicity here: the open-loop drive sets the clock to
    # each arrival, earlier than the previous request's completion
    print(f"[phase 13d] phase 12a's guarded edge, traced there, controller metrics=edge.metrics: "
          f"all {n} decisions {list(counts)}; snapshot queue_depth {snap['queue_depth']}, "
          f"batcher.pending_depth {snap['batcher.pending_depth']}, {len(instants)} admission "
          f"instants, {len(depth)} queue_depth samples; {tracer.n_events} events")


def plain_value(v) -> bool:
    """A value JSON writes as itself: no tensor, array scalar or device that
    ``default=str`` would turn into a string."""
    if isinstance(v, (bool, int, float, str, type(None))):
        return not isinstance(v, np.integer)
    if isinstance(v, (list, tuple)):
        return all(plain_value(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and plain_value(x) for k, x in v.items())
    return False


def merged_trace(parts: dict):
    """One tracer holding every part's events, each track prefixed with its
    part's label (each part ran on its own simulated clock)."""
    from repro_torch.obs import Tracer

    out = Tracer()
    for label, tr in parts.items():
        base = len(out.spans)
        out.spans.extend(dataclasses.replace(
            sp, id=base + sp.id, track=f"{label}-{sp.track}",
            parent=None if sp.parent is None else base + sp.parent) for sp in tr.spans)
        out.instants.extend(dataclasses.replace(i, track=f"{label}-{i.track}") for i in tr.instants)
        out.counters.extend(dataclasses.replace(c, track=f"{label}-{c.track}") for c in tr.counters)
    return out


def check_chrome_trace(path: str) -> tuple:
    """tests/test_obs.py::test_chrome_trace_schema's rules on the written
    file; returns (events, tracks, replica processes)."""
    with open(path) as f:
        doc = json.load(f)
    check(doc["displayTimeUnit"] == "ms" and doc["traceEvents"], "13e: empty trace")
    names, tracks = set(), set()
    for e in doc["traceEvents"]:
        check(e["ph"] in {"X", "i", "C", "M"}, f"13e: event phase {e['ph']}")
        if e["ph"] == "M":
            check(e["name"] in {"process_name", "thread_name"}, f"13e: metadata {e['name']}")
            continue
        check(isinstance(e["ts"], (int, float)) and e["pid"] == e["tid"].split("/", 1)[0],
              f"13e: event {e}")
        names.add(e["name"])
        tracks.add(e["tid"])
        check(e["ph"] != "X" or e["dur"] >= 0.0, f"13e: negative duration {e}")
        check(e["ph"] != "i" or e["s"] == "t", f"13e: instant scope {e}")
    check({"record_rpc", "replay_call", "hedge_dispatch", "migrate"} <= names,
          f"13e: the trace's names {sorted(names)}")
    replicas = {t.split("/", 1)[0] for t in tracks if re.match(r"^\w+-r\d+/", t)}
    check(len(replicas) >= 2, f"13e: replica processes {replicas}")
    return len(doc["traceEvents"]), len(tracks), len(replicas)


def phase_obs_host(dev, r) -> dict:
    """Part e's host cost: replayed qwen3-0.6b steps continuing part b's
    decode (phase 11a's migrated stream), with a tracer attached to the
    client, its GPU queue and its ingress, and detached, in turns (detached
    first in even pairs, attached first in odd ones): host times move up to
    80% between calls, so only turns within one call compare."""
    from repro_torch.obs import Tracer

    served, g, sess = r["served"], r["g"], r["sess"]
    hooks = (sess.client, sess.client.server, sess.network.ingress)
    scratch = Tracer()
    walls = {"attached": [], "detached": []}
    for i in range(OBS_HOST_PAIRS):
        for mode in ("detached", "attached") if i % 2 == 0 else ("attached", "detached"):
            for h in hooks:
                h.tracer = scratch if mode == "attached" else None
            t0 = time.perf_counter()
            res = sess.infer(*served.step_inputs(g))
            sync(dev)
            walls[mode].append(time.perf_counter() - t0)
            check(res.mode == "replaying", f"13e: a {mode} step was {res.mode}")
            served.absorb_step(g, res.outputs)
    for h in hooks:
        h.tracer = None
    check(scratch.n_events > 0, "13e: the attached steps emitted nothing")
    med = {k: 1e3 * float(np.median(v)) for k, v in walls.items()}
    print(f"[phase 13e] host wall per replayed qwen3-0.6b step, {OBS_HOST_PAIRS} in turns each: "
          f"tracer attached median {med['attached']:.1f} ms (all {[round(1e3 * t, 1) for t in walls['attached']]}), "
          f"detached {med['detached']:.1f} ms (all {[round(1e3 * t, 1) for t in walls['detached']]}); "
          f"{scratch.n_events / OBS_HOST_PAIRS:.0f} events per attached step")
    return med


def phase_obs(library, dev, by_path, z, q, over) -> float:
    """Phase 13, observability on the card: (a) a hedged zamba2-1.2b
    stateless fleet traced against its untraced twin, (b) the trace of
    phase 11a's migrated qwen3-0.6b stream, (c) ``plan_explain`` on phase
    10a's qwen3 IOS, (d) the trace and gauges of phase 12a's guarded edge,
    (e) the Chrome trace of (a) and (b) and the host cost of an attached
    tracer.  Returns the phase's seconds."""
    from repro_torch.obs import Tracer, write_chrome_trace

    t_phase = time.perf_counter()
    secs = {}
    tr_a = Tracer()
    t0 = time.perf_counter()
    _, by_path["phase 13a zamba2-1.2b stateless hedged fleet, traced and twin"] = run_path(
        library, "phase 13a zamba2-1.2b stateless hedged fleet", ("rmsnorm", "flash_attention", "ssm_scan"),
        lambda: phase_obs_fleet(dev, z["cfg"], z["params"], z["prompt"], z["dev_tokens"],
                                Z_STATELESS_BUCKET, tr_a))
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mig = q["migrated"]
    phase_obs_migrated(mig)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, by_path["phase 13c plan_explain"] = run_path(
        library, "phase 13c plan_explain", (), lambda: phase_obs_plan(q["graph"]))
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_obs_admission(over)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(OBS_TRACE), exist_ok=True)
    merged = merged_trace({"13a": tr_a, "13b": mig["fleet"].tracer})
    bad = [(ev.name, ev.args) for ev in (*merged.spans, *merged.instants) if not plain_value(ev.args)]
    check(not bad, f"13e: {len(bad)} events carry args that are not plain values, e.g. {bad[:3]}")
    write_chrome_trace(merged, OBS_TRACE)
    write_s = time.perf_counter() - t0
    n_events, n_tracks, n_replicas = check_chrome_trace(OBS_TRACE)
    print(f"[phase 13e] {os.path.relpath(OBS_TRACE, ROOT)}: {n_events} trace events "
          f"({merged.n_events} spans, instants and counters) on {n_tracks} tracks of "
          f"{n_replicas} replica processes, {os.path.getsize(OBS_TRACE) / 1e6:.1f} MB, written in "
          f"{write_s:.1f} s; schema valid (simulated-clock timestamps)")
    del merged, tr_a
    _, by_path["phase 13e qwen3-0.6b host cost of tracing"] = run_path(
        library, "phase 13e qwen3-0.6b host cost of tracing", ("rmsnorm", "decode_attention"),
        lambda: phase_obs_host(dev, mig))
    secs["e"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"[phase 13] observability: {total:.1f} s over parts a-e "
          f"({', '.join(f'{k} {v:.1f}' for k, v in secs.items())})")
    return total


VERIFY_JSON = os.path.join(ROOT, "traces", "phase14_analysis.json")


class HookTimer:
    """Times the replay soundness verifier's fail-fast hooks while entered:
    every call of ``verify_calls``, ``verify_split_calls`` and
    ``verify_plan`` (the engine's hooks import them at call time), with its
    seconds and the codes it reported."""

    NAMES = (("repro_torch.analysis.verify", "verify_calls"),
             ("repro_torch.analysis.verify", "verify_split_calls"),
             ("repro_torch.analysis.plancheck", "verify_plan"))

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import importlib

        self._saved = []
        for mod_name, name in self.NAMES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls.append((name, time.perf_counter() - t0, [d.code for d in out]))
            return out
        return timed

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def summary(self) -> str:
        if not self.calls:
            return "no hook ran"
        return (f"{len(self.calls)} hook calls ({dict(Counter(n for n, _, _ in self.calls))}), "
                f"{sum(t for _, t, _ in self.calls):.3f} s in all, "
                f"{[round(t, 3) for _, t, _ in self.calls]} s each; codes "
                f"{dict(Counter(c for _, _, codes in self.calls for c in codes))}")


def verify_subject(label, calls, pairs, plans, min_repeats) -> dict:
    """Part a: ``verify_ios``'s passes and census over one locked IOS, each
    timed on the host, gathered into its report; no ERROR diagnostic."""
    from repro_torch.analysis import AnalysisReport, lint_ios, op_census, sanitize_donation
    from repro_torch.analysis.plancheck import verify_plan_for_calls
    from repro_torch.analysis.verify import records_of
    from repro_torch.core.records import CAT_D2D, FUNC_H2D

    secs, report = {}, AnalysisReport(subject=label)
    t0 = time.perf_counter()
    report.extend(lint_ios(records_of(calls), min_repeats=min_repeats))
    secs["dataflow"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report.extend(sanitize_donation(calls, pairs))
    secs["donation"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for plan in plans:
        report.extend(verify_plan_for_calls(calls, plan, pairs))
    secs[f"plans x{len(plans)}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report.census = census = op_census(records_of(calls))
    secs["census"] = time.perf_counter() - t0
    check(report.ok, f"14a {label}: ERROR diagnostics {[d.as_dict() for d in report.errors]}")
    h2d = [c for c in calls if c.record.func == FUNC_H2D]
    n_d2d = sum(1 for c in calls if c.record.category == CAT_D2D)
    with_payload = sum(1 for i, _ in pairs if h2d[i].h2d_value is not None)
    warned = Counter(d.code for d in report.warnings)
    print(f"[phase 14a] {label}: {census['n_records']} records, {census['n_kernels']} kernels "
          f"(+ {n_d2d} DtoD), {census['n_h2d']} H2D + {census['n_d2h']} D2H transfers, wire "
          f"{census['h2d_bytes'] + census['d2h_bytes']:.0f} B, {census['flops']:.4g} flops, "
          f"{census['mem_bytes']:.4g} HBM bytes; {len(pairs)} carried pairs ({with_payload} with "
          f"the upload's payload for RRTO203); {len(plans)} plans; 0 errors, warnings "
          f"{dict(warned)}; host s {', '.join(f'{k} {v:.3f}' for k, v in secs.items())}")
    for code in sorted(warned):
        d = next(d for d in report.warnings if d.code == code)
        print(f"    {code} e.g. {d.message}")
    return dict(report=report, secs=secs)


def expect_unsound(label, code_set, fn, server) -> None:
    """Part b: ``fn`` must raise ``ReplaySoundnessError`` with exactly the
    ERROR codes ``code_set`` before the server builds anything."""
    from repro_torch.analysis import ReplaySoundnessError

    built = server.compile_count
    t0 = time.perf_counter()
    try:
        fn()
    except ReplaySoundnessError as e:
        got = {d.code for d in e.diagnostics}
        check(got == code_set, f"14b {label}: raised {sorted(got)}, expected {sorted(code_set)}")
        where = [d.where for d in e.diagnostics][:2]
    else:
        fail(f"14b {label}: no ReplaySoundnessError")
    check(server.compile_count == built, f"14b {label}: a program was built before the check")
    print(f"[phase 14b] {label}: ReplaySoundnessError {sorted(code_set)} (where {where}), "
          f"compile_count {built} unchanged, {time.perf_counter() - t0:.3f} s")


def negative_cases(q) -> None:
    """Part b on copies of phase 12c's locked qwen3-0.6b IOS calls, through
    its verified edge's server and client."""
    from repro_torch.core.intercept import InterceptedCall
    from repro_torch.core.records import FUNC_D2H, FUNC_H2D, OperatorRecord
    from repro_torch.partition import SegmentGraph, SplitPlan

    cl, server = q["sess"].client, q["edge"].server
    calls, pairs = list(cl._ios_calls), tuple(cl.ios.carried_pairs)
    check(server.verify and cl.verify, "14b: 12c's edge is not verified")

    def ordinals(cs, func):
        return [id(c) for c in cs if c.record.func == func]

    # a window rotated by one record; the carried pairs follow their
    # transfers to their new ordinals
    rotated = calls[1:] + calls[:1]
    remap = {}
    for func in (FUNC_H2D, FUNC_D2H):
        old, new = ordinals(calls, func), ordinals(rotated, func)
        remap[func] = {k: new.index(c) for k, c in enumerate(old)}
    moved = tuple((remap[FUNC_H2D][i], remap[FUNC_D2H][j]) for i, j in pairs)
    expect_unsound(f"window rotated by one record ({calls[0].record.func} moved last)",
                   {"RRTO101"}, lambda: server.prepare_replay(rotated, client_id="14b",
                                                              carried_pairs=moved), server)

    # a forged pair: a wire upload paired with a download of a parameter
    # buffer (read in the window, written nowhere in it)
    written = {b for c in calls for b in c.record.out_buffers}
    param = next(b for c in calls for b in c.record.in_buffers if b not in written)
    carried_in = {i for i, _ in pairs}
    h2d = [c for c in calls if c.record.func == FUNC_H2D]
    i = next(k for k in range(len(h2d)) if k not in carried_in)
    value = h2d[i].h2d_value
    aval = (tuple(value.shape), value.dtype) if value is not None else ((), torch.int32)
    forged = calls + [InterceptedCall(
        OperatorRecord(FUNC_D2H, (param, 0), in_buffers=(param,)),
        in_operands=(("a", param),), out_avals=(aval,))]
    n_d2h = sum(1 for c in calls if c.record.func == FUNC_D2H)
    expect_unsound(f"forged carried pair ({i}, {n_d2h}) reading parameter buffer {param:#x}",
                   {"RRTO204"}, lambda: server.prepare_replay(
                       forged, client_id="14b", carried_pairs=pairs + ((i, n_d2h),)), server)

    # a plan over n + 5 ops; its derived cache key names n + 5 ops too, so
    # RRTO305 comes with RRTO301, as in the reference
    n = SegmentGraph(calls).n_ops
    plan = SplitPlan.parse_signature(f"D0:1|S1:{n + 5}")
    expect_unsound(f"_install_plan({plan.signature()}) on a {n}-op IOS", {"RRTO301", "RRTO305"},
                   lambda: cl._install_plan(plan), server)
    check(cl.split_plan is None and "14b" not in server.contexts,
          "14b: a refused plan or program was installed")


def phase_verifier(dev, q, z, kapao) -> dict:
    """Phase 14: (a) the verifier's passes and census over three full-width
    IOSes already locked in this run, (b) three unsound copies refused
    before anything is built, (c) the CLI's registry sweep on the card."""
    from repro_torch.analysis.__main__ import (
        SWEEP_BANDWIDTHS, SWEEP_OBJECTIVES, main, sweep_plans,
    )
    from repro_torch.partition import SegmentGraph, SplitPlan

    secs = {}
    t0 = time.perf_counter()
    cl = q["sess"].client
    verify_subject("qwen3-0.6b stateful (12c)", cl._ios_calls, tuple(cl.ios.carried_pairs),
                   [SplitPlan.parse_signature(p) for p in q["plans"]], cl.min_repeats)
    verify_subject("zamba2-1.2b stateless (phase 5)", z["calls"], (),
                   [SplitPlan.parse_signature(p) for p in z["plans"]], z["min_repeats"])
    tp = time.perf_counter()
    plans = sweep_plans(SegmentGraph(kapao["calls"]), kapao["client_device"],
                        kapao["server_device"])
    print(f"[phase 14a] KAPAO planner sweep ({len(SWEEP_OBJECTIVES)} objectives x "
          f"{len(SWEEP_BANDWIDTHS)} bandwidths): {[p.signature() for p in plans]}, "
          f"{time.perf_counter() - tp:.3f} s")
    verify_subject("KAPAO @ 640 (phase 6)", kapao["calls"], (), plans, kapao["min_repeats"])
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    negative_cases(q)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(VERIFY_JSON), exist_ok=True)
    rc = main(["--all-registry", "--json", VERIFY_JSON, "--device", dev.type])
    with open(VERIFY_JSON) as f:
        blob = json.load(f)
    secs["c"] = time.perf_counter() - t0
    warned = Counter(d["code"] for r in blob["reports"] for d in r["diagnostics"])
    check(rc == 0 and blob["ok"] and blob["n_errors"] == 0, f"14c: the CLI sweep exits {rc}")
    check(len(blob["reports"]) == 11, f"14c: {len(blob['reports'])} subjects, not 11")
    print(f"[phase 14c] python -m repro_torch.analysis --all-registry on {dev}: exit {rc}, "
          f"{len(blob['reports'])} subjects, {blob['n_errors']} errors, warnings {dict(warned)}, "
          f"{secs['c']:.1f} s")
    return secs


class PlainOnCard:
    """While entered, every plain version of the training path's kernels
    (the forward ops' and the backward ops') fails the run if it is handed
    a CUDA tensor: on the card the ops must launch their kernels."""

    NAMES = (("repro_torch.kernels.rmsnorm.ops", "rmsnorm_ref"),
             ("repro_torch.kernels.rmsnorm.ops", "rmsnorm_backward_ref"),
             ("repro_torch.kernels.flash_attention.ops", "attention_chunked"),
             ("repro_torch.kernels.flash_attention.ops", "attention_chunked_backward"),
             ("repro_torch.kernels.ssm_scan.ops", "gated_scan_padded"),
             ("repro_torch.kernels.ssm_scan.ops", "gated_scan_backward_padded"))

    def __enter__(self):
        import importlib

        self._saved = []
        for mod_name, name in self.NAMES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._guard(name, fn))
        return self

    @staticmethod
    def _guard(name, fn):
        def guarded(*args, **kwargs):
            check(not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args),
                  f"the plain {name} ran on a CUDA tensor")
            return fn(*args, **kwargs)
        return guarded

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class StoreTimer:
    """Seconds of each checkpoint ``save`` (a blocking one writes; an
    asynchronous one returns after the host snapshot) and ``restore``
    while entered."""

    def __enter__(self):
        from repro_torch.checkpoint import store

        self.store, self.calls = store, []
        self._saved = [(name, getattr(store, name)) for name in ("save", "restore")]
        for name, fn in self._saved:
            setattr(store, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            kind = name if name == "restore" or kwargs.get("blocking", True) else "snapshot"
            self.calls.append((kind, time.perf_counter() - t0))
            return out
        return timed

    def __exit__(self, *exc):
        for name, fn in self._saved:
            setattr(self.store, name, fn)


def train_grads(cfg, params, nb, dev) -> tuple:
    """The loss of one batch and its gradient over every parameter leaf, by
    the train step's own loss function."""
    from repro_torch.training.optimizer import leaf_paths, tree_map
    from repro_torch.training.step import batch_to_device, make_loss_fn

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = make_loss_fn(cfg)(live, batch_to_device(nb, dev))
    paths = [path for path, p in leaf_paths(live) if p.numel()]
    grads = torch.autograd.grad(loss, [p for _, p in leaf_paths(live) if p.numel()])
    return loss.detach().cpu(), {k: g.cpu() for k, g in zip(paths, grads)}


def phase_train_small(dev) -> None:
    """Phase 15a: one training step of a reduced qwen3-0.6b, minicpm3-4b
    (head dims the backward kernels take: 32, and MLA's 96), zamba2-1.2b,
    xlstm-1.3b (reduced so that every block runs: the shared attention block
    at d_head 32 and the Mamba2 scan at P 32; the mLSTM and the sLSTM),
    whisper-base, llava-next-34b, mixtral-8x7b and llama4-maverick (d_head
    32; the MoE pairs routed on the f32 router, none dropped), the
    card (kernels, forward and backward) against the CPU (plain versions) on
    the same weights and batch.  In f32 the loss and every
    gradient leaf agree within 2e-4 of the leaf's largest magnitude (only
    the sum orders differ).  In bf16 the loss and one ``make_train_step``'s
    loss and grad norm agree within 2e-2; its gradient leaves are printed,
    not held against the CPU: bf16's own rounding moves these leaves 0.5-1.9%
    (relative L2) from f32 on the CPU, so a 2e-2 bound on them would measure
    rounding luck (the scan families' bf16 leaves are held against the plain
    scan backward on the card, ``phase_scan_backward_in_model``)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import init_opt_state, tree_map
    from repro_torch.training.step import make_train_step

    # 300 tokens: two loss chunks, the second padded; ragged 64-row tiles.
    # The scan families take 150 (the sLSTM loops over time on the CPU too):
    # nine chunks of 16 and a ragged tenth
    for name, heads, seq in (("qwen3-0.6b", dict(d_head=32), 300),
                             ("minicpm3-4b", dict(nope_head_dim=64, rope_head_dim=32,
                                                  v_head_dim=64, d_head=96), 300),
                             ("zamba2-1.2b", dict(n_layers=5, attn_every=2, d_head=32,
                                                  ssm_head_dim=32), 150),
                             ("xlstm-1.3b", dict(n_layers=5, slstm_every=2), 150),
                             # the decoder capped at 64 positions, 32 frames;
                             # 16 patches before 284 text tokens
                             ("whisper-base", dict(d_head=32), 300),
                             ("llava-next-34b", dict(d_head=32), 300),
                             # the MoE family: 600 tokens route through the
                             # static dispatch (capacity factor 8: no drop)
                             ("mixtral-8x7b", dict(d_head=32), 300),
                             ("llama4-maverick-400b-a17b", dict(d_head=32), 300)):
        shape = ShapeConfig("phase15a", seq, 2, "train")
        for dtype in (torch.float32, torch.bfloat16):
            cfg = get_reduced_config(name, dtype=str(dtype).split(".")[1], **heads)
            tol = TOL[dtype]
            p_cpu = get_model(cfg).init_params(cfg, 1, "cpu")
            p_dev = tree_map(lambda t: t.to(dev), p_cpu)
            nb = synth_batch(cfg, shape, 0, DataConfig())
            l_cpu, g_cpu = train_grads(cfg, p_cpu, nb, "cpu")
            l_dev, g_dev = train_grads(cfg, p_dev, nb, dev)
            check(abs(float(l_dev) - float(l_cpu)) <= tol * abs(float(l_cpu)),
                  f"15a {cfg.name} {dtype}: loss {float(l_dev)} on the card, {float(l_cpu)} "
                  f"on the cpu")
            worst, worst_l2, gate = 0.0, 0.0, ""
            for k, ref in g_cpu.items():
                ref, got = ref.float(), g_dev[k].float()
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                if cfg.moe_top_k == 1 and k[-1] == "router":
                    # top-1's renormalised gate is p / p = 1: the router's
                    # gradient is that quotient's rounding on either side,
                    # so it is held near zero (tests/test_torch_moe_training.py)
                    big = max(scale, float(got.abs().max()))
                    if dtype == torch.float32:
                        check(big < ROUTER_ZERO, f"15a {cfg.name}: top-1 router grad {k} "
                                                 f"max|g| {big:.3g}, not below {ROUTER_ZERO}")
                    gate += f"; top-1 router grad {'/'.join(k)} max|g| {big:.3g}"
                    continue
                if dtype == torch.float32:
                    check(err <= tol * scale, f"15a {cfg.name}: grad {k} max|d| {err:.3g} over "
                                              f"{tol} x {scale:.3g}")
                worst = max(worst, err / scale if scale else 0.0)
                worst_l2 = max(worst_l2, float((got - ref).norm() / ref.norm()))
            m = {}
            for where, params in (("cpu", p_cpu), ("card", p_dev)):
                params = tree_map(torch.clone, params)   # the step updates them in place
                _, _, metrics = make_train_step(cfg)(params, init_opt_state(params), nb)
                m[where] = (float(metrics["loss"]), float(metrics["grad_norm"]))
            for i, what in enumerate(("loss", "grad_norm")):
                check(abs(m["card"][i] - m["cpu"][i]) <= tol * abs(m["cpu"][i]),
                      f"15a {cfg.name} {dtype}: train step {what} {m['card'][i]} vs "
                      f"{m['cpu'][i]}")
            print(f"[15a] reduced {cfg.name} {dtype}, batch 2 x {seq}: loss card "
                  f"{float(l_dev):.6f} / cpu {float(l_cpu):.6f}; {len(g_cpu)} grad leaves, worst "
                  f"max|d| / max|ref| {worst:.3g}, worst relative L2 {worst_l2:.3g} "
                  f"({'held at ' + str(tol) if dtype == torch.float32 else 'printed'}){gate}; "
                  f"train step loss / grad norm card {m['card']} cpu {m['cpu']} (tol {tol})")


class ScanBackwardPlain:
    """While entered, the scan backward op computes the gradients of CUDA
    tensors with the plain backward in place of its kernel, or with
    ``mma`` the mirror of the bf16 kernel's roundings
    (``gated_scan_backward_mma_ref``): a comparison run, outside every
    counted path."""

    def __init__(self, mma: bool = False):
        self.mma = mma

    def __enter__(self):
        import functools

        from repro_torch.kernels.ssm_scan import ops

        self._saved = ops.gated_scan_backward_cuda
        ops.gated_scan_backward_cuda = functools.partial(ops.gated_scan_backward_padded,
                                                         mma=self.mma)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssm_scan import ops

        ops.gated_scan_backward_cuda = self._saved
        return False


class ScanForwardPlain:
    """While entered, the scan forward op computes CUDA tensors with the
    plain version (``gated_scan_padded``) in place of its kernel: a
    comparison run, outside every counted path."""

    def __enter__(self):
        from repro_torch.kernels.ssm_scan import ops

        self._saved = ops.gated_scan_cuda
        ops.gated_scan_cuda = ops.gated_scan_padded
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssm_scan import ops

        ops.gated_scan_cuda = self._saved
        return False


def scan_mirror_padded(x, ld, gi, Bm, Cm, D, h0, chunk: int):
    """``gated_scan_mma_ref`` (the mirror of the bf16 forward kernel's
    roundings) with the wrapper's padding rule."""
    from repro_torch.kernels.ssm_scan.ref import gated_scan_mma_ref

    s = x.shape[1]
    eff = min(chunk, s)
    pad = (-s) % eff
    if pad:
        x, ld, gi, Bm, Cm = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
                             for t in (x, ld, gi, Bm, Cm))
    y, h = gated_scan_mma_ref(x, ld, gi, Bm, Cm, D, chunk=eff, h0=h0)
    return y[:, :s], h


class ScanForwardWatch:
    """While entered, each scan forward kernel call on CUDA tensors is held
    against the mirror of its bf16 roundings (``scan_mirror_padded``) and
    against the plain version on the same inputs, outside every counted
    path: the relative L2 of y and of the final state, per call."""

    def __enter__(self):
        from repro_torch.kernels.ssm_scan import ops

        self._saved = ops.gated_scan_cuda
        self.calls = []

        def watched(x, ld, gi, Bm, Cm, D, h0, chunk):
            y, h = self._saved(x, ld, gi, Bm, Cm, D, h0, chunk)
            ym, hm = scan_mirror_padded(x, ld, gi, Bm, Cm, D, h0, chunk)
            yp, hp = ops.gated_scan_padded(x, ld, gi, Bm, Cm, D, h0, chunk)
            self.calls.append(dict(
                shape=tuple(x.shape), n=Bm.shape[-1],
                mirror=(rel_l2(y, ym), rel_l2(h, hm)), plain=(rel_l2(y, yp), rel_l2(h, hp)),
                mirror_plain=(rel_l2(ym, yp), rel_l2(hm, hp))))
            return y, h

        ops.gated_scan_cuda = watched
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssm_scan import ops

        ops.gated_scan_cuda = self._saved
        return False

    def worst(self, key: str) -> tuple:
        return tuple(max(c[key][i] for c in self.calls) for i in range(2))


def rel_l2(got, ref) -> float:
    ref = ref.float()
    norm = float(ref.norm())
    return float((got.float() - ref).norm()) / norm if norm else float((got.float()).norm())


def phase_scan_backward_in_model(dev) -> None:
    """Phase 15a, the scan families in bf16 (outside every counted path):
    one batch of reduced zamba2-1.2b and xlstm-1.3b as in 15a, and the
    xLSTM without its sLSTM blocks, on the card with the scan backward
    kernel and again with the plain backward in its place (the same
    forward, bit for bit), and on the CPU.  Every gradient leaf of the
    kernel's run is held within ``TOL`` (relative L2) of the plain
    backward's run; each run's worst leaf against the CPU is printed, which
    tells the scan backward's share of the card's distance to the CPU from
    the rest of the model's bf16 rounding.  Each model runs once more with
    the mirror of the bf16 kernel's roundings in place of the backward
    (``ScanBackwardPlain(mma=True)``): its run's distance to the
    plain-backward run, beside the kernel run's, tells whether the
    kernel's designed roundings account for that distance; the kernel
    run's distance to the mirror run is printed too.  Each xLSTM runs once more with
    the scan forward's plain version in place of its kernel
    (``ScanForwardPlain``, the backward kernel kept), which tells the
    forward kernel's bf16 products' share of it."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import tree_map

    tol = TOL[torch.bfloat16]
    for name, kw in (("zamba2-1.2b", dict(n_layers=5, attn_every=2, d_head=32, ssm_head_dim=32)),
                     ("xlstm-1.3b", dict(n_layers=5, slstm_every=2)),
                     ("xlstm-1.3b", dict(n_layers=5, slstm_every=8))):
        cfg = get_reduced_config(name, dtype="bfloat16", **kw)
        p_cpu = get_model(cfg).init_params(cfg, 1, "cpu")
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        nb = synth_batch(cfg, ShapeConfig("phase15a", 150, 2, "train"), 0, DataConfig())
        _, g_cpu = train_grads(cfg, p_cpu, nb, "cpu")
        with ScanForwardWatch() as watch:
            _, g_kernel = train_grads(cfg, p_dev, nb, dev)
        if name == "xlstm-1.3b":
            # queue C: the forward kernel inside the model against the
            # mirror of its roundings on the same inputs
            check(bool(watch.calls), f"15a {cfg.name}: no scan forward kernel call seen")
            ym, hm = watch.worst("mirror")
            (yp, hp), (mp, mhp) = watch.worst("plain"), watch.worst("mirror_plain")
            print(f"[15a] reduced {cfg.name} bf16: {len(watch.calls)} scan forward calls "
                  f"(x {watch.calls[0]['shape']}, N {watch.calls[0]['n']}), worst relative L2 "
                  f"of y / final state: kernel vs mirror {ym:.3g} / {hm:.3g} (held at "
                  f"{MIRROR_TOL[torch.bfloat16]}), kernel vs plain {yp:.3g} / {hp:.3g}, mirror "
                  f"vs plain {mp:.3g} / {mhp:.3g}")
            check(max(ym, hm) <= MIRROR_TOL[torch.bfloat16],
                  f"15a {cfg.name}: the scan forward kernel {ym:.3g} / {hm:.3g} from the "
                  f"mirror of its roundings")
        with ScanBackwardPlain():
            _, g_plain = train_grads(cfg, p_dev, nb, dev)
        with ScanBackwardPlain(mma=True):
            _, g_mirror = train_grads(cfg, p_dev, nb, dev)

        def worst(got, refs=g_cpu):
            return max((rel_l2(got[k], ref), "/".join(k)) for k, ref in refs.items())

        err, leaf = worst(g_kernel, g_plain)
        (m_err, m_leaf), (km_err, km_leaf) = worst(g_mirror, g_plain), worst(g_kernel, g_mirror)
        check(err <= tol, f"15a {cfg.name} bf16: grad {leaf} of the scan backward kernel's run "
                          f"{err:.3g} (relative L2) from the plain backward's run, over {tol}")
        (k_err, k_leaf), (p_err, p_leaf) = worst(g_kernel), worst(g_plain)
        blocks = "no sLSTM" if kw.get("slstm_every", 0) > kw["n_layers"] else "every block"
        fwd = ""
        if name == "xlstm-1.3b":
            with ScanForwardPlain():
                _, g_fwd = train_grads(cfg, p_dev, nb, dev)
            f_err, f_leaf = worst(g_fwd)
            fwd = f", plain-forward run {f_leaf} {f_err:.3g}"
        print(f"[15a] reduced {cfg.name} bf16 ({blocks}): kernel run vs plain-backward run "
              f"worst leaf {leaf} {err:.3g} (held at {tol}); mirror run vs plain-backward run "
              f"{m_leaf} {m_err:.3g}, kernel run vs mirror run {km_leaf} {km_err:.3g}; worst "
              f"leaf vs the CPU: kernel run {k_leaf} {k_err:.3g}, plain-backward run "
              f"{p_leaf} {p_err:.3g}{fwd} (relative L2)")


# phase 15a: reduced zamba2-1.2b (the default reduction: two Mamba2 layers,
# no shared block) through the trainer, straight and crashed at 2 and resumed
SMALL_TRAIN_ARGS = ["--arch", "zamba2-1.2b", "--reduced", "--batch", "2", "--seq", "256",
                    "--steps", "4", "--log-every", "1", "--device", "cuda"]
SCAN_TRAIN_KERNELS = ("rmsnorm", "ssm_scan", "rmsnorm_backward", "ssm_scan_backward")


def phase_train_small_resume(library, by_path) -> None:
    """Phase 15a, last part: reduced zamba2-1.2b trained 4 steps through
    ``repro_torch.launch.train.main`` straight, then crashed after step 2
    (checkpoints every 2 steps) and resumed: every loss finite, the resumed
    final loss bitwise the straight one (the step runs under PyTorch's
    deterministic algorithms: the Mamba2 conv's backward included)."""
    import tempfile

    from repro_torch.launch import train

    label = "phase 15a reduced zamba2-1.2b"
    straight, by_path[f"{label} straight"] = run_path(
        library, f"{label} straight", SCAN_TRAIN_KERNELS, lambda: train.main(SMALL_TRAIN_ARGS))
    with tempfile.TemporaryDirectory() as ckpt:
        extra = ["--ckpt-every", "2", "--ckpt-dir", ckpt]
        crashed, by_path[f"{label} crash"] = run_path(
            library, f"{label} crash", SCAN_TRAIN_KERNELS,
            lambda: train.main(SMALL_TRAIN_ARGS + extra + ["--kill-at", "2"]))
        resumed, by_path[f"{label} resume"] = run_path(
            library, f"{label} resume", SCAN_TRAIN_KERNELS,
            lambda: train.main(SMALL_TRAIN_ARGS + extra))
    losses = [v for _, v in straight["losses"] + crashed["losses"] + resumed["losses"]]
    check(crashed.get("crashed_at") == 2 and [s for s, _ in resumed["losses"]] == [2, 3],
          f"15a resume: crashed {crashed}, resumed {resumed}")
    check(all(np.isfinite(v) for v in losses), f"15a resume: a loss is not finite: {losses}")
    print(f"[15a] reduced zamba2-1.2b losses straight {straight['losses']}, crashed "
          f"{crashed['losses']}, resumed {resumed['losses']}; resumed final == straight final: "
          f"{resumed['final_loss'] == straight['final_loss']}")
    check(resumed["final_loss"] == straight["final_loss"],
          f"15a: the resumed final loss {resumed['final_loss']!r} is not the straight run's "
          f"{straight['final_loss']!r}")


# phase 15a: the top-1 router's gradient, the rounding of a gate of p / p,
# below this on the card and the CPU in f32 (the CPU tests' absolute
# gradient tolerance)
ROUTER_ZERO = 2e-5
# phase 15a: reduced mixtral-8x7b (2 MoE layers of top-2 over 4 experts;
# d_head 32, which the kernels take) through the trainer, straight and
# crashed at 2 and resumed; then one step launched twice from one state
M_SMALL_TRAIN_ARGS = ["--arch", "mixtral-8x7b", "--reduced", "--batch", "2", "--seq", "256",
                      "--steps", "4", "--log-every", "1", "--device", "cuda"]
M_SMALL_HEADS = dict(d_head=32)


class ReducedOverrides:
    """While entered, the trainer's ``--reduced`` config takes ``overrides``
    (the reduced mixtral's ``d_head`` of 16 is below the kernels' head
    dims)."""

    def __init__(self, **overrides):
        self.overrides = overrides

    def __enter__(self):
        from repro_torch.launch import train

        inner, extra = train.get_reduced_config, self.overrides
        self._saved = inner
        train.get_reduced_config = lambda name, **kw: inner(name, **{**extra, **kw})
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train

        train.get_reduced_config = self._saved
        return False


def phase_train_moe_resume(library, dev, by_path) -> None:
    """Phase 15a, MoE part: reduced mixtral-8x7b trained 4 steps through
    ``repro_torch.launch.train.main`` straight, then crashed after step 2
    and resumed: the resumed final loss bitwise the straight one.  Then one
    step launched twice from the same state: parameters and loss bitwise
    equal.  The dispatch's backward holds two scatter-adds (the gathers'
    ``index_select`` backward; ``index_copy``'s indices repeat at the spare
    row only when pairs drop), which PyTorch's deterministic algorithms run
    deterministically on the card."""
    import tempfile

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import leaf_paths, tree_map
    from repro_torch.training.step import init_train_state, make_train_step

    label = "phase 15a reduced mixtral-8x7b"
    with ReducedOverrides(**M_SMALL_HEADS):
        straight, by_path[f"{label} straight"] = run_path(
            library, f"{label} straight", TRAIN_KERNELS, lambda: train.main(M_SMALL_TRAIN_ARGS))
        with tempfile.TemporaryDirectory() as ckpt:
            extra = ["--ckpt-every", "2", "--ckpt-dir", ckpt]
            crashed, by_path[f"{label} crash"] = run_path(
                library, f"{label} crash", TRAIN_KERNELS,
                lambda: train.main(M_SMALL_TRAIN_ARGS + extra + ["--kill-at", "2"]))
            resumed, by_path[f"{label} resume"] = run_path(
                library, f"{label} resume", TRAIN_KERNELS,
                lambda: train.main(M_SMALL_TRAIN_ARGS + extra))
    losses = [v for _, v in straight["losses"] + crashed["losses"] + resumed["losses"]]
    check(crashed.get("crashed_at") == 2 and [s for s, _ in resumed["losses"]] == [2, 3],
          f"15a mixtral resume: crashed {crashed}, resumed {resumed}")
    check(all(np.isfinite(v) for v in losses), f"15a mixtral: a loss is not finite: {losses}")
    print(f"[15a] reduced mixtral-8x7b losses straight {straight['losses']}, crashed "
          f"{crashed['losses']}, resumed {resumed['losses']}; resumed final == straight final: "
          f"{resumed['final_loss'] == straight['final_loss']}")
    check(resumed["final_loss"] == straight["final_loss"],
          f"15a mixtral: the resumed final loss {resumed['final_loss']!r} is not the straight "
          f"run's {straight['final_loss']!r}")

    cfg = get_reduced_config("mixtral-8x7b", **M_SMALL_HEADS)
    nb = synth_batch(cfg, ShapeConfig("twice", 256, 2, "train"), 0, DataConfig())

    def twice():
        params, opt = init_train_state(cfg, seed=0, device=dev)
        outs = []
        for _ in range(2):
            p, o, m = make_train_step(cfg)(tree_map(torch.clone, params),
                                           tree_map(torch.clone, opt), nb)
            outs.append((leaf_paths(p), m["loss"]))
        return outs

    outs, by_path[f"{label} twice"] = run_path(library, f"{label} twice", TRAIN_KERNELS, twice)
    same = torch.equal(outs[0][1], outs[1][1]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(outs[0][0], outs[1][0]))
    print(f"[15a] reduced mixtral-8x7b: one step launched twice from one state, loss "
          f"{float(outs[0][1]):.6f}; parameters and loss bitwise equal: {same}")
    check(same, "15a mixtral: two launches of one step differ")


TRAIN_GROUPS = (("rmsnorm forward", ("rmsnorm_warp", "rmsnorm_block", "rmsnorm_scalar")),
                ("rmsnorm backward", ("vector_rows_kernel", "rows_kernel", "scale_kernel")),
                ("flash forward", ("wgmma_kernel", "core_kernel")),
                ("flash backward", ("dq_mma_kernel", "dkv_mma_kernel", "dq_kernel",
                                    "dkv_kernel")),
                ("scan forward", ("ssd_kernel", "ssd_mma_kernel", "ssd_mma_wide_kernel",
                                  "ssd_wide_kernel")),
                ("scan backward", ("::cumsum_kernel", "state_pass_kernel", "scores_part_kernel",
                                   "scores_kernel", "dx_kernel",
                                   "dbc_kernel", "finish_kernel", "reduce_bc_kernel",
                                   "reduce_d_kernel", "pad_rows_kernel", "state_pass_mma_kernel",
                                   "scores_part_mma_kernel", "dx_mma_kernel",
                                   "dbc_mma_kernel")),
                ("GEMMs", ("gemm", "Gemm", "xmma", "cutlass", "nvjet", "sm90_")))


def profile_train_step(step, label: str = "15c") -> dict:
    """Device time of one eager training step by kernel, from
    ``torch.profiler`` (one warm-up step first, outside it): the top 12
    kernels, the shares of the hand kernels and the GEMMs, and the share of
    the step's wall the card was busy (kernels on one stream do not
    overlap, so their sum is the busy time)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    total = sum(t for _, t in by_name.values())
    if not total:
        print(f"[{label}] train step profile: no device time in the trace (not measured)")
        return {}
    print(f"[{label}] train step profile: device busy {total / 1e3:.1f} ms of a {wall / 1e3:.1f} ms "
          f"profiled step ({100 * total / wall:.1f}%; idle {100 - 100 * total / wall:.1f}%), "
          f"{sum(c for c, _ in by_name.values())} kernel records")
    for name, (count, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t / 1e3:8.2f} ms {100 * t / total:5.1f}%  {count:5d} records  {name[:90]}")
    shares = {}
    for group, keys in TRAIN_GROUPS:
        hits = [(c, t) for k, (c, t) in by_name.items() if any(x in k for x in keys)]
        t = sum(t for _, t in hits)
        shares[group] = t / 1e3
        print(f"  share of {group}: {t / 1e3:.2f} ms ({sum(c for c, _ in hits)} records), "
              f"{100 * t / total:.1f}% of the device time")
        if group == "scan backward" and hits:
            split = sorted(((kernel_name(k), c, t) for k, (c, t) in by_name.items()
                            if any(x in k for x in keys)), key=lambda kv: -kv[2])
            print("    by launch: " + ", ".join(f"{n} {t / 1e3:.2f} ms ({c})" for n, c, t in split))
    return dict(busy_ms=total / 1e3, wall_ms=wall / 1e3, shares_ms=shares)


def train_flops(cfg, params, tokens: int, batch: int, seq: int, attn_layers=None) -> float:
    """A training step's work: 6 x parameters x tokens, plus attention's
    causal products, the forward's 4 B Hq S(S+1)/2 d a layer (every layer,
    or ``attn_layers`` attention sites) and 2.5 times that for the
    backward."""
    from repro_torch.training.optimizer import leaf_paths

    n_params = sum(p.numel() for _, p in leaf_paths(params))
    sites = cfg.n_layers if attn_layers is None else attn_layers
    attn = 4 * batch * cfg.n_heads * seq * (seq + 1) / 2 * cfg.d_head * sites
    return 6 * n_params * tokens + 3.5 * attn


def fixed_batch(cfg, opt_cfg, nb, dev, steps: int = FIXED_STEPS, remat: bool = True) -> tuple:
    """``steps`` steps (with `remat` unless told otherwise) on the batch
    ``nb`` from the seed-0 train state: (params, opt state, losses, seconds
    per step)."""
    from repro_torch.training.step import init_train_state, make_train_step

    params, opt = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, opt_cfg, remat=remat)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, nb)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return params, opt, losses, secs


class FlashBackwardAs:
    """While entered, the flash attention backward op computes the
    gradients of CUDA tensors with the plain ``fn`` in place of its kernel:
    a comparison run, outside every counted path."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        fn = self.fn

        def swapped(dout, q, k, v, out, causal, window, logit_cap, q_offset):
            grads = fn(dout, q, k, v, out, causal=causal, window=window,
                       logit_cap=logit_cap, q_offset=q_offset)
            return tuple(g.contiguous() for g in grads)

        self._saved = ops.flash_attention_backward_cuda
        ops.flash_attention_backward_cuda = swapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops

        ops.flash_attention_backward_cuda = self._saved
        return False


def witness_rounding_calls(dev, kernel_losses) -> None:
    """Phase 15d, part 1: phase 15c's fixed batch again, each flash
    backward call of the kernel held within ``BWD_EMULATION_TOL`` (relative
    L2, gradient by gradient) of the plain emulation of its roundings
    (``attention_backward_bf16_products``) on the same inputs, inside the
    model along the kernel's own trajectory; the losses equal 15c's
    (``kernel_losses``) bit for bit.  Per step, the worst distances of the
    kernel and of the emulation to the f32 gradients are printed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_bf16_products,
        attention_chunked_backward,
    )
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import AdamWConfig

    def rel(a, b) -> float:
        return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

    kernel, calls = ops.flash_attention_backward_cuda, []

    def watched(dout, q, k, v, out, **kw):
        grads = kernel(dout, q, k, v, out, kw["causal"], kw["window"], kw["logit_cap"],
                       kw["q_offset"])
        emul = attention_backward_bf16_products(dout, q, k, v, out, **kw)
        f32 = attention_chunked_backward(dout.float(), q.float(), k.float(), v.float(), **kw)
        calls.append((max(rel(g, e) for g, e in zip(grads, emul)),
                      max(rel(g, t) for g, t in zip(grads, f32)),
                      max(rel(e, t) for e, t in zip(emul, f32))))
        return grads

    cfg = get_config("qwen3-0.6b")
    batch, seq = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1]) for f in ("--batch", "--seq"))
    nb = synth_batch(cfg, ShapeConfig("fixed", seq, batch, "train"), 0, DataConfig())
    with FlashBackwardAs(watched):
        losses = fixed_batch(cfg, AdamWConfig(lr=FIXED_LR, warmup_steps=1), nb, dev)[2]
    torch.cuda.empty_cache()
    check(losses == kernel_losses, f"15d: the watched run's losses {losses} are not 15c's "
                                   f"{kernel_losses}")
    per = len(calls) // FIXED_STEPS
    for i in range(FIXED_STEPS):
        step = calls[i * per:(i + 1) * per]
        print(f"[15d] step {i}: {len(step)} flash backward calls, worst relative L2 kernel vs "
              f"emulation {max(c[0] for c in step):.3g} (tol {BWD_EMULATION_TOL}), kernel vs "
              f"f32 {max(c[1] for c in step):.3g}, emulation vs f32 {max(c[2] for c in step):.3g}")
    worst = max(c[0] for c in calls)
    check(worst <= BWD_EMULATION_TOL, f"15d: a flash backward call lies {worst:.3g} from the "
                                      f"emulation of its roundings")


def phase_train_full(library, dev, by_path) -> dict:
    """Phase 15b and c: full-width qwen3-0.6b (28 layers, d_model 1024,
    bf16) trained through ``repro_torch.launch.train.main`` (b: straight, a
    crash after step 2 with asynchronous checkpoints every 2 steps, and its
    resume: the resumed final loss equal to the straight one, every loss
    finite) and on one fixed batch (c: the loss falling at every step), each
    part with the launch counters set to 0 just before it and the plain
    versions barred from CUDA tensors."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.step import make_train_step

    out = {}
    with PlainOnCard(), StoreTimer() as st:
        straight, by_path["phase 15b qwen3-0.6b straight"] = run_path(
            library, "phase 15b qwen3-0.6b straight", TRAIN_KERNELS,
            lambda: train.main(TRAIN_ARGS))
        with tempfile.TemporaryDirectory() as ckpt:
            crashed, by_path["phase 15b qwen3-0.6b crash"] = run_path(
                library, "phase 15b qwen3-0.6b crash", TRAIN_KERNELS,
                lambda: train.main(TRAIN_ARGS + TRAIN_CKPT + [
                    "--ckpt-dir", ckpt, "--kill-at", str(TRAIN_KILL_AT)]))
            resumed, by_path["phase 15b qwen3-0.6b resume"] = run_path(
                library, "phase 15b qwen3-0.6b resume", TRAIN_KERNELS,
                lambda: train.main(TRAIN_ARGS + TRAIN_CKPT + ["--ckpt-dir", ckpt]))
            step_dir = os.path.join(ckpt, "step_00000004")
            ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                             for f in os.listdir(step_dir))
        steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
        check(crashed.get("crashed_at") == TRAIN_KILL_AT, f"15b: crash {crashed}")
        check([s for s, _ in straight["losses"]] == list(range(steps)), f"15b: {straight}")
        check([s for s, _ in resumed["losses"]] == list(range(TRAIN_KILL_AT, steps)),
              f"15b: resumed {resumed}")
        losses = [v for _, v in straight["losses"] + crashed["losses"] + resumed["losses"]]
        check(all(np.isfinite(v) for v in losses), f"15b: a loss is not finite: {losses}")
        diff = abs(resumed["final_loss"] - straight["final_loss"])
        print(f"[15b] losses straight {straight['losses']}, crashed {crashed['losses']}, "
              f"resumed {resumed['losses']}; resumed final - straight final = {diff!r} "
              f"(bitwise {diff == 0.0}; rtol 1e-4 enforced)")
        check(diff <= 1e-4 * abs(straight["final_loss"]), f"15b: resumed {resumed} vs "
                                                          f"straight {straight}")
        kinds = {k: [round(t, 3) for kk, t in st.calls if kk == k]
                 for k in ("snapshot", "save", "restore")}
        print(f"[15b] checkpoint {ckpt_bytes} bytes ({ckpt_bytes / 1e9:.3f} GB); s per "
              f"asynchronous snapshot {kinds['snapshot']}, blocking save {kinds['save']}, "
              f"restore {kinds['restore']}")
        out.update(ckpt_bytes=ckpt_bytes, store=kinds, diff=diff)
        torch.cuda.empty_cache()

        cfg = get_config("qwen3-0.6b")
        batch, seq = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1]) for f in ("--batch", "--seq"))
        nb = synth_batch(cfg, ShapeConfig("fixed", seq, batch, "train"), 0, DataConfig())
        opt_cfg = AdamWConfig(lr=FIXED_LR, warmup_steps=1)

        # what 15b's runs leave allocated goes before the peak is reset, so
        # the peak is the fixed-batch run's own
        held = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[15c] allocated before the fixed batch: {held / 1e9:.2f} GB, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after gc.collect()")
        base = torch.cuda.memory_allocated()      # no argument of the step is made yet
        torch.cuda.reset_peak_memory_stats()
        (params, opt, losses, secs), launches = run_path(
            library, "phase 15c qwen3-0.6b fixed batch", TRAIN_KERNELS,
            lambda: fixed_batch(cfg, opt_cfg, nb, dev))
        by_path["phase 15c qwen3-0.6b fixed batch"] = launches
        peak = torch.cuda.max_memory_allocated()
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"15c: the loss did not fall at every step: {losses}")
        per_step = {k: n / FIXED_STEPS for k, n in launches.items() if n}
        out["measured"] = {"15c": dict(launches=per_step, peak=peak, other=base)}
        remat_step = make_train_step(cfg, opt_cfg, remat=True)
        out["profile"] = profile_train_step(lambda: remat_step(params, opt, nb))

        def no_remat():
            step = make_train_step(cfg, opt_cfg, remat=False)
            secs = []
            for _ in range(NO_REMAT_STEPS):
                t0 = time.perf_counter()
                _, _, m = step(params, opt, nb)
                float(m["loss"])
                secs.append(time.perf_counter() - t0)
            return secs

        nr_base = torch.cuda.memory_allocated() - tensor_bytes(params, opt)
        torch.cuda.reset_peak_memory_stats()
        nr_secs, nr_launches = run_path(library, "phase 15c qwen3-0.6b fixed batch, no remat",
                                        TRAIN_KERNELS, no_remat)
        by_path["phase 15c qwen3-0.6b fixed batch, no remat"] = nr_launches
        nr_peak = torch.cuda.max_memory_allocated()
        out["measured"]["15c no remat"] = dict(
            launches={k: n / NO_REMAT_STEPS for k, n in nr_launches.items() if n},
            peak=nr_peak, other=nr_base)
        step_s = float(np.median(secs[1:]))
        nr_step_s = float(np.median(nr_secs[1:]))
        tokens = batch * seq
        flops = train_flops(cfg, params, tokens, batch, seq)
        bound_s = flops / PEAK_FLOPS[torch.bfloat16]
        print(f"[15c] fixed batch {batch} x {seq}, lr {FIXED_LR}: losses {losses}; s per step "
              f"{[round(t, 4) for t in secs]} (the first builds)")
        print(f"[15c] step with remat {step_s * 1e3:.1f} ms ({tokens / step_s:.0f} tokens/s, "
              f"peak {peak / 1e9:.2f} GB), without {nr_step_s * 1e3:.1f} ms "
              f"({tokens / nr_step_s:.0f} tokens/s, peak {nr_peak / 1e9:.2f} GB); bound "
              f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s = {bound_s * 1e3:.2f} ms: "
              f"{100 * bound_s / step_s:.2f}% of it with remat, {100 * bound_s / nr_step_s:.2f}% "
              f"without")
        print(f"[15c] launches per step with remat {per_step}; without "
              f"{ {k: n / NO_REMAT_STEPS for k, n in nr_launches.items() if n} }")
        out.update(losses=losses, step_ms=step_s * 1e3, no_remat_ms=nr_step_s * 1e3,
                   tokens_per_s=tokens / step_s, bound_ms=bound_s * 1e3, per_step=per_step)
        del params, opt
    torch.cuda.empty_cache()
    return out


# phase 15e: full-width zamba2-1.2b through the trainer and on one batch
Z_TRAIN_ARGS = ["--arch", "zamba2-1.2b", "--batch", "4", "--seq", "512", "--steps", "4",
                "--log-every", "1", "--device", "cuda"]
Z_FIXED_STEPS = 4          # steps with remat on one batch (the first not timed)
Z_NO_REMAT_STEPS = 3       # steps without remat (the first not timed)
Z_TRAIN_KERNELS = ("rmsnorm", "flash_attention", "ssm_scan", "rmsnorm_backward",
                   "flash_attention_backward", "ssm_scan_backward")
# phase 15f: full-width xlstm-1.3b on one batch of 1 x 512 tokens
X_TRAIN_BATCH, X_TRAIN_SEQ, X_FIXED_STEPS = 1, 512, 2


def phase_train_zamba(library, dev, by_path) -> dict:
    """Phase 15e: full-width zamba2-1.2b (38 Mamba2 layers, the shared block
    at 6 sites, bf16) trained 4 steps at 4 x 512 tokens through
    ``repro_torch.launch.train.main``, then ``Z_FIXED_STEPS`` steps with
    `remat` and ``Z_NO_REMAT_STEPS`` without on one batch: every loss finite
    and the fixed batch's falling; ms a step, tokens/s, the share of the
    bound, the peak, one profiled step, and each kernel's launches a step
    (the scan forward's and backward's among them), each part a path with
    the counters set to 0 just before it and the plain versions barred from
    CUDA tensors."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.step import make_train_step

    cfg = get_config("zamba2-1.2b")
    batch, seq = (int(Z_TRAIN_ARGS[Z_TRAIN_ARGS.index(f) + 1]) for f in ("--batch", "--seq"))
    out = {}
    with PlainOnCard():
        straight, by_path["phase 15e zamba2-1.2b train.main"] = run_path(
            library, "phase 15e zamba2-1.2b train.main", Z_TRAIN_KERNELS,
            lambda: train.main(Z_TRAIN_ARGS))
        losses = [v for _, v in straight["losses"]]
        check(len(losses) == 4 and all(np.isfinite(v) for v in losses),
              f"15e: train.main losses {straight['losses']}")
        print(f"[15e] train.main zamba2-1.2b {batch} x {seq}: losses {straight['losses']}")
        gc.collect()
        torch.cuda.empty_cache()
        nb = synth_batch(cfg, ShapeConfig("fixed", seq, batch, "train"), 0, DataConfig())
        opt_cfg = AdamWConfig(lr=FIXED_LR, warmup_steps=1)
        base = torch.cuda.memory_allocated()      # no argument of the step is made yet
        torch.cuda.reset_peak_memory_stats()
        with RmsnormBackwardShapes() as rb:
            (params, opt, losses, secs), launches = run_path(
                library, "phase 15e zamba2-1.2b fixed batch", Z_TRAIN_KERNELS,
                lambda: fixed_batch(cfg, opt_cfg, nb, dev, steps=Z_FIXED_STEPS))
        print(f"[15e] rmsnorm backward launches a step by route: {rb.by_route(Z_FIXED_STEPS)}")
        by_path["phase 15e zamba2-1.2b fixed batch"] = launches
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(v) for v in losses) and all(b < a for a, b in zip(losses, losses[1:])),
              f"15e: the fixed batch's loss did not fall at every step: {losses}")
        per_step = {k: n / Z_FIXED_STEPS for k, n in launches.items() if n}
        out["measured"] = {"15e": dict(launches=per_step, peak=peak, other=base)}
        remat_step = make_train_step(cfg, opt_cfg, remat=True)
        out["profile"] = profile_train_step(lambda: remat_step(params, opt, nb), "15e")

        def no_remat():
            step = make_train_step(cfg, opt_cfg, remat=False)
            times = []
            for _ in range(Z_NO_REMAT_STEPS):
                t0 = time.perf_counter()
                _, _, m = step(params, opt, nb)
                float(m["loss"])
                times.append(time.perf_counter() - t0)
            return times

        gc.collect()
        torch.cuda.empty_cache()
        nr_base = torch.cuda.memory_allocated() - tensor_bytes(params, opt)
        torch.cuda.reset_peak_memory_stats()
        nr_secs, nr_launches = run_path(library, "phase 15e zamba2-1.2b fixed batch, no remat",
                                        Z_TRAIN_KERNELS, no_remat)
        by_path["phase 15e zamba2-1.2b fixed batch, no remat"] = nr_launches
        nr_peak = torch.cuda.max_memory_allocated()
        out["measured"]["15e no remat"] = dict(
            launches={k: n / Z_NO_REMAT_STEPS for k, n in nr_launches.items() if n},
            peak=nr_peak, other=nr_base)
    step_s, nr_step_s = float(np.median(secs[1:])), float(np.median(nr_secs[1:]))
    tokens = batch * seq
    flops = train_flops(cfg, params, tokens, batch, seq,
                        attn_layers=cfg.n_layers // cfg.attn_every)
    bound_s = flops / PEAK_FLOPS[torch.bfloat16]
    print(f"[15e] fixed batch {batch} x {seq}, lr {FIXED_LR}: losses {losses}; s per step "
          f"{[round(t, 4) for t in secs]} (the first builds)")
    print(f"[15e] step with remat {step_s * 1e3:.1f} ms ({tokens / step_s:.0f} tokens/s, peak "
          f"{peak / 1e9:.2f} GB), without {nr_step_s * 1e3:.1f} ms ({tokens / nr_step_s:.0f} "
          f"tokens/s, peak {nr_peak / 1e9:.2f} GB); bound {flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s = {bound_s * 1e3:.2f} ms: {100 * bound_s / step_s:.2f}% of it with remat, "
          f"{100 * bound_s / nr_step_s:.2f}% without")
    print(f"[15e] launches per step with remat {per_step}; without "
          f"{ {k: n / Z_NO_REMAT_STEPS for k, n in nr_launches.items() if n} }")
    out.update(losses=losses, step_ms=step_s * 1e3, no_remat_ms=nr_step_s * 1e3,
               tokens_per_s=tokens / step_s, bound_ms=bound_s * 1e3, per_step=per_step,
               peak_gb=peak / 1e9, no_remat_peak_gb=nr_peak / 1e9)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


class ScanBackwardWatch:
    """While entered, every launch of the scan backward kernel is followed
    by the plain backward on the same inputs, each gradient held element by
    element (``hold_scan_backward``); a comparison run, outside every
    counted path."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels.ssm_scan import ops

        kernel, plain, calls = ops.gated_scan_backward_cuda, ops.gated_scan_backward_padded, \
            self.calls

        def watched(*args):
            grads = kernel(*args)
            torch.cuda.synchronize()
            before = len(MISMATCHES)
            err, _ = hold_scan_backward(grads, plain(*args), args, TOL[args[2].dtype])
            route = "wide" if args[5].shape[-1] > 128 else "narrow"
            calls.append((tuple(args[2].shape), route, err, len(MISMATCHES) == before))
            return grads

        self._saved = kernel
        ops.gated_scan_backward_cuda = watched
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssm_scan import ops

        ops.gated_scan_backward_cuda = self._saved
        return False


def phase_train_xlstm(library, dev, by_path) -> dict:
    """Phase 15f: full-width xlstm-1.3b (42 mLSTM blocks with the 1024 x 1025
    state, 6 sLSTM blocks, bf16) trained ``X_FIXED_STEPS`` steps with
    `remat` on one batch of 1 x 512 tokens (every loss finite; a path, the
    plain versions barred from CUDA tensors), then one more step with every
    scan backward call (the wide route) held within ``TOL`` of the plain
    backward on the model's own inputs (``ScanBackwardWatch``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.step import make_train_step

    cfg = get_config("xlstm-1.3b")
    nb = synth_batch(cfg, ShapeConfig("fixed", X_TRAIN_SEQ, X_TRAIN_BATCH, "train"), 0,
                     DataConfig())
    opt_cfg = AdamWConfig(lr=FIXED_LR, warmup_steps=1)
    torch.cuda.reset_peak_memory_stats()
    with PlainOnCard(), RmsnormBackwardShapes() as rb:
        (params, opt, losses, secs), launches = run_path(
            library, "phase 15f xlstm-1.3b fixed batch", SCAN_TRAIN_KERNELS,
            lambda: fixed_batch(cfg, opt_cfg, nb, dev, steps=X_FIXED_STEPS))
    print(f"[15f] rmsnorm backward launches a step by route: {rb.by_route(X_FIXED_STEPS)}")
    by_path["phase 15f xlstm-1.3b fixed batch"] = launches
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for v in losses), f"15f: a loss is not finite: {losses}")
    with ScanBackwardWatch() as watch:
        _, _, m = make_train_step(cfg, opt_cfg, remat=True)(params, opt, nb)
    routes = Counter(route for _, route, _, _ in watch.calls)
    worst = max((err for _, _, err, _ in watch.calls), default=float("nan"))
    bad = [c for c in watch.calls if not c[3]]
    shapes = sorted({c[0] for c in watch.calls})
    print(f"[15f] xlstm-1.3b {X_TRAIN_BATCH} x {X_TRAIN_SEQ}: losses {losses} then "
          f"{float(m['loss']):.6f}; s per step {[round(t, 3) for t in secs]}; peak "
          f"{peak / 1e9:.2f} GB; launches per step "
          f"{ {k: n / X_FIXED_STEPS for k, n in launches.items() if n} }")
    print(f"[15f] checked step: {len(watch.calls)} scan backward calls {dict(routes)}, x "
          f"{shapes}; worst max|d| {worst:.3g} against the plain backward (tol "
          f"{TOL[torch.bfloat16]} + {ROUNDING_FLOOR:g} x f32 rounding); {len(bad)} outside it")
    check(np.isfinite(float(m["loss"])) and routes.get("wide", 0) == cfg.n_layers
          - cfg.n_layers // cfg.slstm_every and not bad,
          f"15f: {len(bad)} scan backward calls outside TOL, routes {dict(routes)}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, secs=secs, peak_gb=peak / 1e9, calls=len(watch.calls), worst=worst)


def rss() -> str:
    """This process's resident host memory now (``/proc``, where the kernel
    reports it) and at its peak (``getrusage``)."""
    import resource

    with open("/proc/self/status") as f:
        now = next((line.split(":", 1)[1].strip() for line in f if line.startswith("VmRSS:")),
                   "not reported")
    return f"{now} (peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB)"


def run_path(library, label, kernels, fn):
    """Drive one path with every launch count set to 0 just before it and
    read just after; fail if a kernel of the path never launched."""
    library.reset_launches()
    t0 = time.perf_counter()
    m = fn()
    launches = dict(library.LAUNCHES)
    print(f"[{label}] ({time.perf_counter() - t0:.1f} s); launches {launches}")
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} never launched on the {label} path")
    return m, launches


def phases_8_9(library, dev) -> dict:
    """Phase 8 (minicpm3-4b) and phase 9 (xlstm-1.3b), each stateful and
    stateless, then phase 16 (the MoE family; 18b on its weights), phase 17
    (whisper-base and llava-next-34b), phase 7 (multi-tenant serving) and
    phase 19 (the sharding layer); returns their launches by path and phase
    7's batched kernel rows."""
    by_path = {}
    t0 = time.perf_counter()
    mla = ("rmsnorm", "flash_attention")
    m, by_path["minicpm3-4b"] = run_path(
        library, "phase 8 minicpm3-4b stateful", mla,
        lambda: phase_main_path(dev, "minicpm3-4b", M_PROMPT, M_NEW, M_BUCKET))
    check_main_path(m)
    measure_replay_step(m, dev)
    check_prefill_vs_decode(m, dev, LOGIT_REL_TOL)
    params = m["params"]
    del m
    torch.cuda.empty_cache()
    m, by_path["minicpm3-4b stateless"] = run_path(
        library, "phase 8 minicpm3-4b stateless", mla,
        lambda: phase_main_path(dev, "minicpm3-4b", M_PROMPT, M_NEW, M_BUCKET, stateful=False,
                                params=params))
    n = m["cfg"].n_layers
    check_main_path(m, {"flash_attention": n, "rmsnorm": 4 * n + 1})
    measure_replay_step(m, dev)
    del m, params
    torch.cuda.empty_cache()
    print(f"[phase 8] ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    print(f"host RSS before xlstm-1.3b stateful: {rss()}")
    m, by_path["xlstm-1.3b"] = run_path(
        library, "phase 9 xlstm-1.3b stateful", ("rmsnorm", "ssm_scan"),
        lambda: phase_main_path(dev, "xlstm-1.3b", X_PROMPT, X_NEW, X_BUCKET))
    print(f"host RSS after xlstm-1.3b stateful: {rss()}")
    check_main_path(m)
    measure_replay_step(m, dev)
    check_xlstm_prefill_vs_decode(m, dev)
    params = m["params"]
    del m
    torch.cuda.empty_cache()
    m, by_path["xlstm-1.3b stateless"] = run_path(
        library, "phase 9 xlstm-1.3b stateless", ("rmsnorm", "ssm_scan"),
        lambda: phase_main_path(dev, "xlstm-1.3b", X_STATELESS_PROMPT, X_NEW, X_BUCKET,
                                stateful=False, params=params))
    n_m = m["cfg"].n_layers - m["cfg"].n_layers // m["cfg"].slstm_every
    check_main_path(m, {"ssm_scan": n_m, "rmsnorm": 2 * m["cfg"].n_layers + 1})
    measure_replay_step(m, dev)
    del m, params
    torch.cuda.empty_cache()
    print(f"[phase 9] ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    phase_mixtral(library, dev, by_path)
    t1 = time.perf_counter()
    phase_llama4_reduced(library, dev, by_path)
    print(f"[phase 16] the MoE family: {time.perf_counter() - t0:.1f} s (16a "
          f"{t1 - t0:.1f}, 16b {time.perf_counter() - t1:.1f})")
    phase_encdec_vlm(library, dev, by_path)
    batched_rows = phase_7(library, dev, by_path)
    phase_sharding(library, dev, by_path)
    return by_path, batched_rows


SERVE_PROMPT, SERVE_NEW = 8, 8           # phase 19a: the launcher's qwen3-0.6b run
SP_CACHE, SP_KV_LEN, SP_WINDOW = 32768, 30001, 4096   # phase 19b's decode step
# phase 19b's SP decode against the decode kernel, max |d| over outputs of
# about 0.026 (unit-normal q and K/V, window 4,096): the card read 4.88e-4
SP_TOL = 2e-3
MOE_TOKENS = 64                          # phase 19b: tokens through one mixtral layer


def phase_serve_launcher(dev) -> None:
    """19a: full-width qwen3-0.6b through ``repro_torch.launch.serve.main``,
    locally and through the rrto stack, on the launcher's seeded weights."""
    from repro_torch.launch import serve

    argv = ["--arch", "qwen3-0.6b", "--tokens", str(SERVE_NEW), "--prompt-len",
            str(SERVE_PROMPT), "--device", dev.type]
    t0 = time.perf_counter()
    local = serve.main(argv + ["--system", "local"])
    t1 = time.perf_counter()
    rrto = serve.main(argv + ["--system", "rrto"])
    print(f"19a serve launcher: local {t1 - t0:.1f} s, rrto {time.perf_counter() - t1:.1f} s; "
          f"rrto rpcs first {rrto['rpcs_first']} last {rrto['rpcs_last']}, mode {rrto['mode']}")
    check(local["tokens"] == rrto["tokens"],
          f"19a: launcher tokens local {local['tokens']} != rrto {rrto['tokens']}")
    check(rrto["rpcs_last"] == 3 and rrto["mode"] == "replaying",
          f"19a: rrto last token {rrto['rpcs_last']} RPCs in mode {rrto['mode']}")


def phase_sharding(library, dev, by_path) -> None:
    """Phase 19: the serve launcher (19a), then a one-rank NCCL group with a
    (1, 1) mesh: the compressed all-reduce, the sequence-parallel decode
    attention and the shard-local MoE dispatch (19b), and the sharded
    restore (19c)."""
    import tempfile

    import torch.distributed as dist

    t_all = time.perf_counter()
    _, by_path["phase 19a qwen3-0.6b serve launcher"] = run_path(
        library, "phase 19a qwen3-0.6b serve launcher",
        ("rmsnorm", "decode_attention", "flash_attention"), lambda: phase_serve_launcher(dev))
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_all

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(dev.index or 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            from repro_torch.launch.mesh import make_live_mesh

            mesh = make_live_mesh((1, 1), ("data", "model"))
            t0 = time.perf_counter()
            phase_sharding_collectives(dev, mesh)
            t_b = time.perf_counter() - t0
            t0 = time.perf_counter()
            phase_sharded_restore(dev, mesh, tmp)
            t_c = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "19: the NCCL group outlived the phase")
    torch.cuda.empty_cache()
    print(f"[phase 19] the sharding layer: {time.perf_counter() - t_all:.1f} s (19a {t_a:.1f}, "
          f"19b {t_b:.1f}, 19c {t_c:.1f}); group destroyed")


def phase_sharding_collectives(dev, mesh) -> None:
    """19b on the one-rank group: exact identities at world size 1, and the
    sharded layers against the single-device ones at full width."""
    import dataclasses as dc
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import compressed_psum, dequantize_int8, quantize_int8
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.layers import moe
    from repro_torch.layers.attention import _sp_decode_attention
    from repro_torch.models import lm

    cfg = get_config("qwen3-0.6b")
    x = lm.init_params(cfg, 0, dev)["embed"].float()
    t0 = time.perf_counter()
    mean, err = compressed_psum(x, mesh.group("data"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    deq = dequantize_int8(*quantize_int8(x))
    check(torch.equal(mean, deq), "19b: compressed_psum at world 1 is not dequantize(quantize(x))")
    check(torch.equal(err, x - deq), "19b: compressed_psum's error feedback is not x - that")
    print(f"19b compressed_psum {tuple(x.shape)} f32 over NCCL (world 1): bitwise "
          f"dequantize(quantize(x)) and x - that; max|err| {float(err.abs().max()):.3g}; "
          f"{ms:.2f} ms (first call)")
    del x, mean, err, deq

    g = torch.Generator(device=dev).manual_seed(19)
    b, hq, hkv, d = 1, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn((b, hq, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, SP_CACHE, hkv, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    kv_len = torch.full((b,), SP_KV_LEN, dtype=torch.int32, device=dev)
    sp = _sp_decode_attention(q, k, v, kv_len, SimpleNamespace(window=SP_WINDOW), mesh)
    ref = decode_attention(q, k, v, kv_len, window=SP_WINDOW)
    sp_err = float((sp.float() - ref.float()).abs().max())
    print(f"19b _sp_decode_attention q {tuple(q.shape)} K/V {tuple(k.shape)} bf16, kv_len "
          f"{SP_KV_LEN}, window {SP_WINDOW}: max|d| vs the decode kernel {sp_err:.3g} "
          f"(tol {SP_TOL}; max|ref| {float(ref.float().abs().max()):.3g})")
    check(sp_err <= SP_TOL, f"19b: sequence-parallel decode off the kernel by {sp_err}")
    sp_ms = eager_ms(lambda: _sp_decode_attention(q, k, v, kv_len, SimpleNamespace(window=SP_WINDOW),
                                                  mesh))
    dec_ms = eager_ms(lambda: decode_attention(q, k, v, kv_len, window=SP_WINDOW))
    kv_bytes = 2 * k.numel() * k.element_size()
    print(f"19b SP decode {sp_ms:.4f} ms a call (eager, host included; the whole {SP_CACHE}-key "
          f"slice, {kv_bytes / 1e6:.1f} MB of K/V, read: {kv_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"at the memory rate), the decode kernel {dec_ms:.4f} ms (the window's rows)")
    del q, k, v, sp, ref

    mcfg = dc.replace(get_config("mixtral-8x7b"), n_layers=1)
    p = {name: t[0] for name, t in moe.moe_init(g, mcfg, torch.bfloat16, 1).items()}
    xs = (torch.randn((1, MOE_TOKENS, mcfg.d_model), generator=g, device=dev)).to(torch.bfloat16)
    c = torch.randn(xs.shape, generator=g, device=dev).to(torch.bfloat16)
    p["router"].requires_grad_()

    def run(cfg_):
        # the output, and the gradients of sum(y * c) for x and the router
        x_ = xs.clone().requires_grad_()
        y = moe.moe_apply(p, x_, cfg_)
        gx, gr = torch.autograd.grad((y.float() * c.float()).sum(), (x_, p["router"]))
        return y.detach(), gx, gr

    glob = run(mcfg)
    with use_mesh(mesh):
        local = run(dc.replace(mcfg, moe_groups=1))
    rel = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
           for a, b in zip(local, glob)]
    print(f"19b shard-local MoE dispatch, one mixtral-8x7b layer ({mcfg.moe_experts} experts, "
          f"d {mcfg.d_model}, ff {mcfg.d_ff}, {MOE_TOKENS} tokens, bf16): max|d| / max|global| "
          f"of y, dx, drouter {', '.join(f'{r:.3g}' for r in rel)} (tol {LOGIT_REL_TOL}); "
          f"bitwise the global dispatch: "
          f"{', '.join(str(bool(torch.equal(a, b))) for a, b in zip(local, glob))}")
    check(max(rel) <= LOGIT_REL_TOL, f"19b: the shard-local MoE dispatch is off by {rel}")


def phase_sharded_restore(dev, mesh, tmp) -> None:
    """19c: a qwen3-0.6b parameter checkpoint restored onto the mesh as
    DTensors, bitwise the saved tree."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import named_sharding_tree
    from repro_torch.models import lm
    from repro_torch.training.optimizer import leaf_paths, tree_map

    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(cfg, 0, dev)
    t0 = time.perf_counter()
    store.save(os.path.join(tmp, "ckpt"), 1, {"params": params})
    t1 = time.perf_counter()
    template = {"params": tree_map(lambda t: torch.empty(t.shape, device="meta"), params)}
    shardings = {"params": named_sharding_tree(lm.param_specs(cfg), mesh)}
    restored = store.restore(os.path.join(tmp, "ckpt"), 1, template, shardings=shardings)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pairs = list(zip(leaf_paths(params), leaf_paths(restored["params"])))
    same = [pa == pb and isinstance(b, DTensor) and b.dtype == a.dtype
            and torch.equal(b.to_local(), a) for (pa, a), (pb, b) in pairs]
    n_bytes = sum(a.numel() * a.element_size() for (_, a), _ in pairs)
    print(f"19c restore(shardings=) of qwen3-0.6b params ({len(pairs)} leaves, "
          f"{n_bytes / 1e9:.3f} GB bf16) onto the (1, 1) mesh: save {t1 - t0:.1f} s, restore "
          f"{t2 - t1:.1f} s; {sum(same)}/{len(same)} leaves bitwise, DTensors in the "
          f"checkpoint's dtype")
    check(all(same), "19c: the sharded restore is not the saved tree")


def phase_7(library, dev, by_path) -> dict:
    """Phase 7 (in the second process, last): the vmap rules' kernel rows,
    then ``MultiClientServedLM`` with 4 qwen3-0.6b clients stateful and 2
    zamba2-1.2b clients stateless, on phase 3's and 4's weights (seed 0,
    drawn again here), each batched and looped; returns the batched kernel
    rows for the kernel table."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    # as phase 6 sets them in the main process before this phase ran there
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    q_cfg, z_cfg = get_config("qwen3-0.6b"), get_config("zamba2-1.2b")
    q_params = get_model(q_cfg).init_params(q_cfg, seed=0, device=dev)
    params = get_model(z_cfg).init_params(z_cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    batched_rows = phase_mt_kernels(dev)
    check(not MISMATCHES, f"{len(MISMATCHES)} batched kernel checks disagreed")
    print(f"[phase 7 kernels] vmap rules == lane loops ({time.perf_counter() - t0:.1f} s)")
    runs = {}
    for vm in (True, False):
        label = f"phase 7 qwen3-0.6b x{MT_CLIENTS} {'vmap' if vm else 'loop'}"
        runs[vm], by_path[label] = run_path(
            library, label, ("rmsnorm", "decode_attention"),
            lambda: phase_multitenant(dev, "qwen3-0.6b", q_params, stateful=True,
                                      clients=MT_CLIENTS, prompt_lens=MT_PROMPTS,
                                      new_tokens=MT_NEW, bucket=BUCKET, enable_vmap=vm))
    check_multitenant(f"qwen3-0.6b x{MT_CLIENTS}", runs[True], runs[False])
    check_lane_order(f"qwen3-0.6b x{MT_CLIENTS}", runs[True])
    step_times = time_multitenant_step(runs[True], dev)
    del runs
    torch.cuda.empty_cache()
    runs = {}
    for vm in (True, False):
        label = f"phase 7 zamba2-1.2b stateless x{MT_Z_CLIENTS} {'vmap' if vm else 'loop'}"
        runs[vm], by_path[label] = run_path(
            library, label, ("rmsnorm", "flash_attention", "ssm_scan"),
            lambda: phase_multitenant(dev, "zamba2-1.2b", params, stateful=False,
                                      clients=MT_Z_CLIENTS,
                                      prompt_lens=(MT_Z_PROMPT,) * MT_Z_CLIENTS,
                                      new_tokens=MT_Z_NEW, bucket=Z_STATELESS_BUCKET,
                                      enable_vmap=vm))
    check_multitenant(f"zamba2-1.2b stateless x{MT_Z_CLIENTS}", runs[True], runs[False])
    check_lane_order(f"zamba2-1.2b stateless x{MT_Z_CLIENTS}", runs[True])
    del runs
    torch.cuda.empty_cache()
    print(f"[phase 7] ({time.perf_counter() - t0:.1f} s); batched step {step_times}")
    del q_params, params
    torch.cuda.empty_cache()
    return batched_rows



def phase_qwen3_int8(library, dev, by_path, bf16_step: dict) -> None:
    """Phase 18a: qwen3-0.6b at full width with ``kv_cache_bits=8`` (int8
    K/V and f32 scales per position and head; the step attends through the
    plain ``decode_attention_q8_ref``, as the reference does, so no decode
    attention kernel launches), weights from seed 0: ``LocalServing`` (its
    prefill quantizes the prompt's K/V from flash attention), rrto and
    ``device_only`` at phase 3's prompt and bucket: rrto == ``device_only``
    bitwise, 3 RPCs a steady token, the int8 cache carried off the wire; the
    replayed step timed (wall, eager, CUDA graph) beside phase 3's bf16
    step (``bf16_step``); then how many of the int8 tokens equal the bf16
    cache's ``LocalServing`` tokens on the same weights (printed)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import LocalServing

    bf16 = get_config("qwen3-0.6b")
    cfg = dataclasses.replace(bf16, kv_cache_bits=8)
    n = cfg.n_layers
    m, by_path["phase 18a qwen3-0.6b int8 cache"] = run_path(
        library, "phase 18a qwen3-0.6b int8 cache", ("rmsnorm", "flash_attention"),
        lambda: phase_main_path(dev, "qwen3-0.6b int8 cache", PROMPT_LEN, Q8_NEW, BUCKET,
                                cfg=cfg))
    check_main_path(m, {"rmsnorm": 4 * n + 1, "decode_attention": 0})
    steady = m["steady"]
    check(all(h.rpcs == 3 for h in steady), f"18a: steady rpcs {[h.rpcs for h in steady]}")
    leaves = m["served"]._cache_leaves
    check([t.dtype for t in leaves] == [torch.int8, torch.float32] * 2,
          f"18a: cache leaves {[t.dtype for t in leaves]}")
    print(f"[18a] carried pairs {len(m['sess'].client.ios.carried_pairs)} (the stacked k, ks, v, "
          f"vs of all {n} layers: {[tuple(t.shape) for t in leaves]}), carried bytes "
          f"{m['cache_bytes']} ({m['cache_bytes'] / 1e6:.2f} MB; the bf16 cache's: "
          f"{2 * n * BUCKET * cfg.n_kv_heads * cfg.d_head * 2 / 1e6:.2f} MB); wire bytes a steady "
          f"token {max(h.network_bytes for h in steady):.0f}")
    step = measure_replay_step(m, dev)
    print(f"[18a] replayed step, int8 / phase 3's bf16 cache: graph {step['device_ms']:.3f} / "
          f"{bf16_step['device_ms']:.3f} ms, eager {step['eager_ms']:.1f} / "
          f"{bf16_step['eager_ms']:.1f} ms, wall {step['wall_ms']:.1f} / "
          f"{bf16_step['wall_ms']:.1f} ms")
    ref = LocalServing(bf16, params=m["params"], device=dev).generate(
        {"tokens": m["prompt"]}, Q8_NEW, max_seq=BUCKET)
    same = int((ref.tokens == m["local"].tokens).sum())
    print(f"[18a] int8 LocalServing tokens equal to the bf16 cache's on the same weights: "
          f"{same}/{Q8_NEW} ({m['local'].tokens.tolist()} vs {ref.tokens.tolist()})")
    del m
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: the MoE family (in the second process, after phase 9)
# ---------------------------------------------------------------------------

MIX_F32_LAYERS = 2   # 16a's f32 prefill/decode check: mixtral's first layers (11.6 GB in f32)


class MoEDispatches:
    """While entered, each MoE dispatch's plan is recorded
    (``repro_torch.layers.moe.route`` wrapped; outside every counted path):
    the (token, expert) pairs it dropped over capacity, and each token's
    experts (a dropped pair reads E)."""

    def __enter__(self):
        from repro_torch.layers import moe

        self._moe, self._route = moe, moe.route
        self.calls = []

        def route(p, xf, cfg, cap):
            order, slot, weight, counts = self._route(p, xf, cfg, cap)
            experts = torch.div(slot, cap, rounding_mode="floor").index_select(
                0, torch.argsort(order))
            self.calls.append(dict(
                dropped=int(torch.clamp(counts - cap, min=0).sum()),
                experts=experts.reshape(xf.shape[0], cfg.moe_top_k).sort(-1).values.cpu()))
            return order, slot, weight, counts

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False


def n_moe_layers(cfg) -> int:
    return sum(cfg.moe_layer(i) for i in range(cfg.n_layers))


def first_layers(params, cfg, n: int) -> tuple:
    """The LM's first ``n`` layers (whole super-blocks), the served weights'
    own leaves, no copy."""
    cut = {k: v for k, v in params.items() if k != "blocks"}
    cut["blocks"] = torch.utils._pytree.tree_map(lambda t: t[:n // cfg.moe_every],
                                                 params["blocks"])
    return cut, dataclasses.replace(cfg, n_layers=n)


def moe_routes(m, dev, params, cfg) -> tuple:
    """``prefill_and_decode_logits`` with every dispatch recorded: the two
    last-position logits, the pairs the prefill dropped by MoE layer, and
    the (layer, token) routings whose experts differ between the prefill
    and the decode loop."""
    with MoEDispatches() as d:
        a, b = prefill_and_decode_logits(m, dev, params, cfg)
    n, s = n_moe_layers(cfg), m["prompt"].shape[1]
    pre, dec = d.calls[:n], d.calls[n:]
    check(len(dec) == n * s, f"{cfg.name}: {len(d.calls)} dispatches recorded")
    flips = sum(int(not torch.equal(pre[i]["experts"][t], dec[t * n + i]["experts"][0]))
                for i in range(n) for t in range(s))
    return a, b, [c["dropped"] for c in pre], flips


def check_moe_prefill_vs_decode(m, dev) -> None:
    """16a's prefill against its token-by-token decode loop.  The prefill
    routes the prompt's 16 tokens with a capacity of 8 pairs per expert, so
    a pair can drop (the reference's semantics, not a fault); a decode step
    of one token never drops.  The drops are printed.  Where nothing
    dropped, the bf16 model's two paths agree to ``LOGIT_REL_TOL`` at its
    full depth, and ``check_prefill_vs_decode`` holds on its first
    ``MIX_F32_LAYERS`` layers (f32 at TOL; an f32 copy of all of them does
    not fit the card beside the bf16 weights); where a pair dropped, the
    check runs on the reduced mixtral (capacity factor 8: drop-free) on the
    card instead.  Routings that differ between the two paths are
    printed."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.layers.moe import moe_capacity
    from repro_torch.models.registry import get_model

    name, cfg, params = m["name"], m["cfg"], m["params"]
    s = m["prompt"].shape[1]
    a, b, dropped, flips = moe_routes(m, dev, params, cfg)
    gap = (a - b).abs().max().item() / a.abs().max().item()
    print(f"{name}: the prefill of {s} tokens dropped {sum(dropped)} (token, expert) "
          f"assignments over a capacity of {moe_capacity(s, cfg)} (by layer {dropped}); "
          f"{flips} of {s * n_moe_layers(cfg)} routings differ between the prefill and the "
          f"decode loop (a dropped pair counts); bf16 last logits prefill vs decode loop {gap:.4g} of the largest "
          f"(tol {LOGIT_REL_TOL})")
    if sum(dropped) == 0:
        check(gap <= LOGIT_REL_TOL, f"{name}: bf16 prefill and decode-loop logits disagree")
        cut, cut_cfg = first_layers(params, cfg, MIX_F32_LAYERS)
        check_prefill_vs_decode(dict(m, name=f"{name} first {MIX_F32_LAYERS} layers",
                                     params=cut, cfg=cut_cfg), dev, LOGIT_REL_TOL)
        return
    # the kernels take head dims from 32: the reduction's 16 is raised to 32
    rcfg = get_reduced_config("mixtral-8x7b", dtype="bfloat16", d_head=32)
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab, (1, s)).astype(np.int32)
    rm = dict(m, name=f"reduced {rcfg.name} (d_head 32)", cfg=rcfg, prompt=prompt,
              params=get_model(rcfg).init_params(rcfg, seed=0, device=dev))
    _, _, r_dropped, r_flips = moe_routes(rm, dev, rm["params"], rcfg)
    print(f"{rm['name']}: the prefill dropped {sum(r_dropped)} assignments; {r_flips} "
          f"routings differ between the prefill and the decode loop")
    check(sum(r_dropped) == 0, f"{rm['name']}: its prefill dropped {r_dropped}")
    check_prefill_vs_decode(rm, dev, LOGIT_REL_TOL)


def moe_weight_bytes(cfg, params) -> tuple:
    """Bytes of weights one decode step reads: every weight the static
    dispatch reads (all E experts of every MoE layer; the embedding's one
    row unless it is the head too), and the weights top-k routing needs (k
    of the E experts, per token)."""
    total = expert = 0
    for path, t in torch.utils._pytree.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", None) for k in path]
        nbytes = t.numel() * t.element_size()
        if keys[0] == "embed" and not cfg.tie_embeddings:
            nbytes = t.shape[1] * t.element_size()
        total += nbytes
        if keys[-1] in ("w_gate", "w_up", "w_down") and "shared" not in keys \
                and t.dim() == 4:
            expert += nbytes
    if not cfg.moe_experts:
        return total, total
    return total, total - expert * (1 - cfg.moe_top_k / cfg.moe_experts)


def phase_mixtral(library, dev, by_path) -> None:
    """Phase 16a: mixtral-8x7b at full width, ``MIX_LAYERS`` of its 32
    layers, bf16, random weights from seed 0, served stateful
    (``LocalServing``, rrto, ``device_only``) and stateless (bucket 64), each
    path with its launches counted and checked, its replayed step timed as
    one CUDA graph beside two bounds at 3.35 TB/s: the weights the static
    dispatch reads (every expert) and those top-2 routing needs."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=MIX_LAYERS)
    name = f"mixtral-8x7b ({MIX_LAYERS} layers)"
    n = cfg.n_layers
    kinds = (("stateful", ("rmsnorm", "decode_attention"),
              {"rmsnorm": 2 * n + 1, "decode_attention": n}),
             ("stateless", ("rmsnorm", "flash_attention"),
              {"flash_attention": n, "rmsnorm": 2 * n + 1}))
    params = None
    for kind, kernels, per_step in kinds:
        t0 = time.perf_counter()
        m, by_path[f"phase 16a {name} {kind}"] = run_path(
            library, f"phase 16a {name} {kind}", kernels,
            lambda: phase_main_path(dev, name, MIX_PROMPT, MIX_NEW, MIX_BUCKET,
                                    stateful=kind == "stateful", params=params, cfg=cfg))
        params = m["params"]
        check_main_path(m, per_step)
        step = measure_replay_step(m, dev)
        every, needed = moe_weight_bytes(cfg, params)
        print(f"{name} {kind} graph step {step['device_ms']:.3f} ms against its bounds at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: the static dispatch's weight reads "
              f"{every / 1e9:.3f} GB -> {every / HBM_BYTES_PER_S * 1e3:.3f} ms "
              f"({every / HBM_BYTES_PER_S * 1e3 / step['device_ms']:.1%} of the step), the "
              f"weights top-{cfg.moe_top_k} routing needs {needed / 1e9:.3f} GB -> "
              f"{needed / HBM_BYTES_PER_S * 1e3:.3f} ms")
        if kind == "stateful":
            check_moe_prefill_vs_decode(m, dev)
        del m
        torch.cuda.empty_cache()
        print(f"[phase 16a] {kind} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_mixtral_multitenant(library, dev, by_path, cfg, params)
    print(f"[phase 18b] ({time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()


def phase_mixtral_multitenant(library, dev, by_path, cfg, params) -> None:
    """Phase 18b, run right after 16a on its weights (so that no second
    copy of the 23.75 GB is made, and none is held through phase 17):
    ``MultiClientServedLM`` with ``MIX_MT_CLIENTS`` mixtral-8x7b clients,
    stateful and then stateless, each run vmap-batched and looped under
    ``no_vmap_fallback``: equal tokens, 3 RPCs a steady token, one program
    built; the dispatch's ``topk``, stable ``argsort``, ``index_copy`` and
    the expert ``bmm`` at a new batch rank all batched.  ``check_lane_order``
    then reruns every call of the batched program on a real round, vmapped
    and as the lane loop: the calls whose bits change must be exactly the
    ones the probe runs per lane (their number printed)."""
    name = f"mixtral-8x7b ({cfg.n_layers} layers)"
    for stateful in (True, False):
        kind = "stateful" if stateful else "stateless"
        kernels = ("rmsnorm", "decode_attention") if stateful else ("rmsnorm", "flash_attention")
        label = f"phase 18b {name} {kind} x{MIX_MT_CLIENTS}"
        runs = {}
        for vm in (True, False):
            runs[vm], by_path[f"{label} {'vmap' if vm else 'loop'}"] = run_path(
                library, f"{label} {'vmap' if vm else 'loop'}", kernels,
                lambda: phase_multitenant(dev, "mixtral-8x7b", params, stateful=stateful,
                                          clients=MIX_MT_CLIENTS, prompt_lens=MIX_MT_PROMPTS,
                                          new_tokens=MIX_MT_NEW, bucket=MIX_BUCKET,
                                          enable_vmap=vm, cfg=cfg))
        check_multitenant(label, runs[True], runs[False])
        check_lane_order(label, runs[True])
        del runs
        torch.cuda.empty_cache()


def phase_llama4_reduced(library, dev, by_path) -> None:
    """Phase 16b: the reduced llama4-maverick (a dense layer, then a MoE
    layer of top-1 over 4 experts beside a shared expert; f32; d_head 32, as
    the kernels take head dims from 32) on the card against the same
    weights on the CPU: forward, prefill and decode-step logits within TOL;
    then served stateful and stateless, rrto bitwise ``device_only``."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.registry import get_model

    cfg = get_reduced_config("llama4-maverick-400b-a17b", d_head=32)
    model = get_model(cfg)
    p_cpu = model.init_params(cfg, 1, "cpu")
    p_dev = torch.utils._pytree.tree_map(lambda t: t.to(dev), p_cpu)
    s = 12
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, s))
                           .astype(np.int32))
    n0 = len(MISMATCHES)
    with torch.no_grad():
        e0 = close(model.forward(p_dev, {"tokens": tok.to(dev)}, cfg).cpu(),
                   model.forward(p_cpu, {"tokens": tok}, cfg), TOL[torch.float32])
        l_cpu, c_cpu = model.prefill(p_cpu, {"tokens": tok}, cfg, s + 4)
        l_dev, c_dev = model.prefill(p_dev, {"tokens": tok.to(dev)}, cfg, s + 4)
        e1 = close(l_dev.cpu(), l_cpu, TOL[torch.float32])
        pos, nxt = torch.tensor(s, dtype=torch.int32), tok[:, -1:]
        d_cpu, _ = model.decode_step(p_cpu, nxt, c_cpu, pos, cfg)
        d_dev, _ = model.decode_step(p_dev, nxt.to(dev), c_dev, pos.to(dev), cfg)
        e2 = close(d_dev.cpu(), d_cpu, TOL[torch.float32])
    print(f"[phase 16b] reduced {cfg.name} f32 (d_head 32) card vs cpu: forward logits max|d| "
          f"{e0:.3g}, prefill {e1:.3g}, decode step {e2:.3g} (tol {TOL[torch.float32]})")
    check(len(MISMATCHES) == n0, f"16b: reduced {cfg.name} logits on the card disagree with "
                                 f"the CPU's")
    name = f"reduced {cfg.name}"
    n = cfg.n_layers
    for stateful, kernels, per_step in (
            (True, ("rmsnorm", "decode_attention"), {"rmsnorm": 2 * n + 1, "decode_attention": n}),
            (False, ("rmsnorm", "flash_attention"), {"flash_attention": n, "rmsnorm": 2 * n + 1})):
        kind = "stateful" if stateful else "stateless"
        m, by_path[f"phase 16b {name} {kind}"] = run_path(
            library, f"phase 16b {name} {kind}", kernels,
            lambda: phase_main_path(dev, name, MIX_PROMPT, MIX_NEW, MIX_BUCKET, stateful=stateful,
                                    params=p_dev, cfg=cfg))
        check_main_path(m, per_step)
        del m


# ---------------------------------------------------------------------------
# phase 17: the encoder-decoder and patch-prefix families (in the second
# process, after phase 16)
# ---------------------------------------------------------------------------

def check_extended_forward(label, model, params, cfg, batch, tokens, max_seq, dev,
                           tol: float) -> None:
    """The prefill's last logits and each decode step's (fed ``tokens``, at
    ``s + num_patches + i``) against the forward over the prompt extended
    by those tokens, position by position: the largest difference within
    ``tol`` of the largest forward logit (printed with the positions whose
    argmax agrees)."""
    tokens = torch.as_tensor(tokens, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    s, n = batch["tokens"].shape[1], tokens.shape[1]
    ext = dict(batch, tokens=torch.cat([batch["tokens"], tokens[:, :-1]], dim=1))
    with torch.no_grad():
        full = model.forward(params, ext, cfg)[0, s - 1:, :cfg.vocab].float()
        logits, cache = model.prefill(params, batch, cfg, max_seq)
        steps = [logits[0, 0, :cfg.vocab].float()]
        for i in range(n - 1):
            pos = torch.tensor(s + cfg.num_patches + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, tokens[:, i:i + 1], cache, pos, cfg)
            steps.append(logits[0, 0, :cfg.vocab].float())
    got = torch.stack(steps)
    check(bool(torch.isfinite(got).all() and torch.isfinite(full).all()),
          f"{label} {cfg.dtype}: non-finite logits")
    gap = float((got - full).abs().max() / full.abs().max())
    same = int((got.argmax(-1) == full.argmax(-1)).sum())
    print(f"{label} {cfg.dtype}: prefill + {n - 1} decode steps vs the extended forward, "
          f"max|d| / max|logit| {gap:.3g} (tol {tol}); argmax equal at {same}/{n} positions")
    check(gap <= tol, f"{label} {cfg.dtype}: prefill/decode logits disagree with the "
                      f"extended forward's")


class FlashBackwardShapes:
    """While entered, the shapes of every flash backward kernel launch are
    counted: ``(q shape, k shape, causal)`` (the wrapper is wrapped; it
    launches as before)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self.ops, self.inner, self.shapes = ops, ops.flash_attention_backward_cuda, Counter()

        def counted(dout, q, k, v, out, causal, *rest):
            self.shapes[(tuple(q.shape), tuple(k.shape), bool(causal))] += 1
            return self.inner(dout, q, k, v, out, causal, *rest)

        ops.flash_attention_backward_cuda = counted
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention_backward_cuda = self.inner


def whisper_step_bytes(cfg, params, kv_len: int) -> int:
    """Bytes one stateful decode step of the encoder-decoder must read: the
    decoder's weights but the cross K/V projections (the cross cache holds
    their products), the final norm and the head, one row of the embedding
    and of the learned positions, the cross cache, and the self cache's
    ``kv_len`` rows."""
    el = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    for path, t in torch.utils._pytree.tree_flatten_with_path(params["decoder"])[0]:
        keys = [getattr(k, "key", None) for k in path]
        if not (keys[0] == "cross_attn" and keys[-1] in ("wk", "wv")):
            total += t.numel() * t.element_size()
    total += (params["final_norm"].numel() + params["lm_head"].numel() + 2 * cfg.d_model) * el
    total += 2 * cfg.dec_layers * (cfg.enc_seq * cfg.n_heads + kv_len * cfg.n_kv_heads) \
        * cfg.d_head * el
    return total


def phase_whisper(library, dev, by_path) -> None:
    """Phase 17a: whisper-base at full width (6 + 6 layers, d_model 512,
    bf16, random weights from seed 0) on 1,500 frames from the seed:
    ``LocalServing`` (the frames encoded, the cross cache filled), its
    prefill and decode-step logits against the extended forward's in bf16
    and in f32; then stateful ``RRTOServedLM`` rrto and ``device_only``,
    which send tokens alone and so decode from the zero cross cache (the
    reference's app), rrto bitwise ``device_only`` at 3 RPCs a token with
    the cross cache carried off the wire, and the replayed step as a CUDA
    graph beside the bytes it must read."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    cfg = get_config("whisper-base")
    model = get_model(cfg)
    frames = np.random.default_rng(0).normal(0, 1, (1, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    n = cfg.dec_layers
    per_step = {"rmsnorm": 3 * n + 1, "decode_attention": 2 * n}
    m, by_path["phase 17a whisper-base stateful"] = run_path(
        library, "phase 17a whisper-base stateful",
        ("rmsnorm", "decode_attention", "flash_attention"),
        lambda: phase_main_path(dev, "whisper-base", W_PROMPT, W_NEW, W_BUCKET, cfg=cfg,
                                inputs={"frames": frames}))
    check_main_path(m, per_step)
    leaves = m["served"]._cache_leaves
    cross = sum(t.numel() * t.element_size() for t in leaves[:2])
    check(tuple(leaves[0].shape) == (n, 1, cfg.enc_seq, cfg.n_heads, cfg.d_head),
          f"whisper-base: the first cache leaf is {tuple(leaves[0].shape)}, not the cross K")
    check(all(h.rpcs == 3 and h.network_bytes < cross for h in m["steady"]),
          "whisper-base: the cross cache crossed the wire")
    print(f"whisper-base: cross cache {cross} bytes (K and V, {n} layers x {cfg.enc_seq} keys), "
          f"carried on the server; steady wire bytes/token "
          f"{max(h.network_bytes for h in m['steady']):.0f}, rpcs/token "
          f"{max(h.rpcs for h in m['steady'])}")
    step = measure_replay_step(m, dev)
    kv_len = W_PROMPT + W_NEW - 1
    nbytes = whisper_step_bytes(cfg, m["params"], kv_len)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"whisper-base stateful graph step {step['device_ms']:.3f} ms against its byte bound "
          f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: the "
          f"decoder's weights, the head, the cross cache, {kv_len} self-cache rows; "
          f"{bound / step['device_ms']:.1%} of the step)")
    batch = {"tokens": m["prompt"], "frames": frames}
    tokens = m["local"].tokens
    check_extended_forward("whisper-base", model, m["params"], cfg, batch, tokens, W_BUCKET, dev,
                           LOGIT_REL_TOL)
    p32 = torch.utils._pytree.tree_map(lambda t: t.float(), m["params"])
    check_extended_forward("whisper-base", model, p32, dataclasses.replace(cfg, dtype="float32"),
                           batch, tokens, W_BUCKET, dev, TOL[torch.float32])
    del m, p32
    torch.cuda.empty_cache()


def encdec_train_flops(cfg, batch: int, dec_len: int) -> float:
    """A training step's work for the encoder-decoder: 6 x each matrix's
    parameters x the rows it multiplies (the encoder's and the cross K/V
    projections' ``batch`` x ``enc_seq`` frames; the decoder's, the head's
    ``batch`` x ``dec_len`` tokens), plus attention's products, 4 B H Sq Sk
    d a layer forward (the encoder's no mask, the decoder's causal and its
    cross attention) and 2.5 times that backward."""
    d, f, h, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_head
    enc_rows, dec_rows = batch * cfg.enc_seq, batch * dec_len
    attn, mlp = 4 * d * h * dh, 3 * d * f
    mm = (cfg.enc_layers * (attn + mlp) * enc_rows
          + cfg.dec_layers * ((attn + 2 * d * h * dh + mlp) * dec_rows + 2 * d * h * dh * enc_rows)
          + d * cfg.padded_vocab * dec_rows)
    pairs = (cfg.enc_layers * cfg.enc_seq ** 2
             + cfg.dec_layers * (dec_len * (dec_len + 1) / 2 + dec_len * cfg.enc_seq))
    return 6 * mm + 3.5 * 4 * batch * h * dh * pairs


def phase_whisper_train(library, dev, by_path) -> None:
    """Phase 17b: whisper-base at full width trained on one fixed batch of
    2 x (1,500 frames, 448 tokens), ``W_TRAIN_STEPS`` steps with ``remat``
    and as many without, each from the seed-0 state: the loss falls at each
    step; ms a step (the median after the first) against the step's flop
    bound; the launches a step by kernel, and the flash backward's by shape
    (the encoder's 1,500 frames with no mask, the decoder's 448 causal, and
    across). The plain versions are barred from CUDA tensors."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import AdamWConfig

    cfg = get_config("whisper-base")
    nb = synth_batch(cfg, ShapeConfig("fixed", W_TRAIN_DEC, W_TRAIN_BATCH, "train"), 0,
                     DataConfig())
    opt_cfg = AdamWConfig(lr=FIXED_LR, warmup_steps=1)
    flops = encdec_train_flops(cfg, W_TRAIN_BATCH, W_TRAIN_DEC)
    bound_ms_ = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    for remat in (True, False):
        label = f"phase 17b whisper-base fixed batch{'' if remat else ', no remat'}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with PlainOnCard(), FlashBackwardShapes() as fb:
            (params, _, losses, secs), launches = run_path(
                library, label, TRAIN_KERNELS,
                lambda: fixed_batch(cfg, opt_cfg, nb, dev, steps=W_TRAIN_STEPS, remat=remat))
        by_path[label] = launches
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(v) for v in losses) and all(b < a for a, b in zip(losses, losses[1:])),
              f"17b: the fixed batch's loss did not fall at every step: {losses}")
        step_ms = float(np.median(secs[1:])) * 1e3
        print(f"[17b] {label}: losses {losses}; ms per step {[round(t * 1e3, 1) for t in secs]} "
              f"(the first builds); step {step_ms:.1f} ms, peak {peak / 1e9:.2f} GB; bound "
              f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s = {bound_ms_:.3f} ms "
              f"({bound_ms_ / step_ms:.2%} of the step)")
        print(f"[17b] launches per step { {k: n / W_TRAIN_STEPS for k, n in launches.items() if n} }"
              f"; flash backward launches by (q, k, causal): "
              f"{ {k: n // W_TRAIN_STEPS for k, n in fb.shapes.items()} } a step")
        check(len(fb.shapes) == 3 and all(n == W_TRAIN_STEPS * cfg.n_layers
                                          for n in fb.shapes.values()),
              f"17b: flash backward launches by shape {dict(fb.shapes)}")
        del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_llava(library, dev, by_path) -> None:
    """Phase 17c: llava-next-34b at full width and ``L_LAYERS`` of its 60
    layers (d_model 7168, 56 query heads on 8 KV heads, bf16, random weights
    from seed 0) with 576 patch embeddings from the seed: ``LocalServing``
    (the patch prefix prefilled, every decode at ``s + num_patches``), its
    logits against the extended forward's (bf16 at its depth; f32 on its
    first ``L_F32_LAYERS`` layers); then stateful rrto and ``device_only``,
    which send text alone, as the reference's app does: rrto bitwise
    ``device_only`` at 3 RPCs a token, the replayed step as a CUDA graph
    beside the bytes of its weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=L_LAYERS)
    name = f"llava-next-34b ({L_LAYERS} layers)"
    model = get_model(cfg)
    patches = np.random.default_rng(0).normal(0, 1, (1, cfg.num_patches, cfg.d_model)).astype(
        np.float32)
    n = cfg.n_layers
    m, by_path[f"phase 17c {name} stateful"] = run_path(
        library, f"phase 17c {name} stateful", ("rmsnorm", "decode_attention", "flash_attention"),
        lambda: phase_main_path(dev, name, L_PROMPT, L_NEW, L_BUCKET, cfg=cfg,
                                inputs={"patches": patches}))
    check_main_path(m, {"rmsnorm": 2 * n + 1, "decode_attention": n})
    step = measure_replay_step(m, dev)
    nbytes, _ = moe_weight_bytes(cfg, m["params"])
    print(f"{name} stateful graph step {step['device_ms']:.3f} ms against its weight reads "
          f"{nbytes / 1e9:.3f} GB -> {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"({nbytes / HBM_BYTES_PER_S * 1e3 / step['device_ms']:.1%} of the step)")
    batch = {"tokens": m["prompt"], "patches": patches}
    max_seq = L_PROMPT + cfg.num_patches + L_NEW
    check_extended_forward(name, model, m["params"], cfg, batch, m["local"].tokens, max_seq, dev,
                           LOGIT_REL_TOL)
    cut, cut_cfg = first_layers(m["params"], cfg, L_F32_LAYERS)
    p32 = torch.utils._pytree.tree_map(lambda t: t.float(), cut)
    check_extended_forward(f"llava-next-34b (first {L_F32_LAYERS} layers)", model, p32,
                           dataclasses.replace(cut_cfg, dtype="float32"), batch,
                           m["local"].tokens, max_seq, dev, TOL[torch.float32])
    del m, cut, p32
    torch.cuda.empty_cache()


def phase_encdec_vlm(library, dev, by_path) -> None:
    """Phase 17 (a, b, c), each part timed."""
    t = [time.perf_counter()]
    for fn in (phase_whisper, phase_whisper_train, phase_llava):
        fn(library, dev, by_path)
        t.append(time.perf_counter())
    print(f"[phase 17] the encoder-decoder and patch-prefix families: {t[3] - t[0]:.1f} s (17a "
          f"{t[1] - t[0]:.1f}, 17b {t[2] - t[1]:.1f}, 17c {t[3] - t[2]:.1f})")


# ---------------------------------------------------------------------------
# phase 15g: mixtral-8x7b trained at full width (main process, last)
# ---------------------------------------------------------------------------

class RmsnormBackwardShapes:
    """While entered, the (rows, d) of every rmsnorm backward kernel launch
    are counted, and its (route, d) by ``rmsnorm_backward_plan`` (the
    wrapper is wrapped; it launches as before)."""

    def __enter__(self):
        from repro_torch.kernels.rmsnorm import ops

        self.ops, self.inner = ops, ops.rmsnorm_backward_cuda
        self.shapes, self.routes = Counter(), Counter()

        def counted(dy, x, scale, *rest):
            rows, d = x.numel() // x.shape[-1], x.shape[-1]
            self.shapes[(rows, d)] += 1
            aligned = all(t.data_ptr() % ops.VEC_BYTES == 0 for t in (dy, x, scale))
            plan = ops.rmsnorm_backward_plan(rows, d, x.dtype, aligned=aligned)
            self.routes[(plan["route"], d)] += 1
            return self.inner(dy, x, scale, *rest)

        ops.rmsnorm_backward_cuda = counted
        return self

    def __exit__(self, *exc):
        self.ops.rmsnorm_backward_cuda = self.inner

    def by_route(self, steps: int) -> str:
        """The launches a step by route, and by d within each."""
        out = {}
        for (route, d), n in sorted(self.routes.items()):
            out.setdefault(route, {})[d] = n / steps
        return ", ".join(f"{route} {sum(ds.values()):g} (by d {ds})" for route, ds in out.items())


def moe_train_flops(cfg, params, batch: int, seq: int) -> tuple:
    """Two bounds of a MoE training step's work, 6 x parameters x tokens
    plus attention (``train_flops``): with the experts counted as top-k
    routing needs them (k of E per token), and as the static dispatch
    computes them (E x C rows a layer, C the capacity)."""
    from repro_torch.layers.moe import moe_capacity
    from repro_torch.training.optimizer import leaf_paths

    tokens = batch * seq
    leaves = leaf_paths(params)
    expert = sum(p.numel() for path, p in leaves if path[-1] in ("w_gate", "w_up", "w_down"))
    dense = sum(p.numel() for _, p in leaves) - expert
    n_moe = sum(cfg.moe_layer(j) for j in range(cfg.moe_every)) * (cfg.n_layers // cfg.moe_every)
    per_row = expert / (n_moe * cfg.moe_experts)            # one expert's weights, one layer
    attn = 4 * batch * cfg.n_heads * seq * (seq + 1) / 2 * cfg.d_head * cfg.n_layers
    base = 6 * dense * tokens + 3.5 * attn
    routed = base + 6 * per_row * tokens * cfg.moe_top_k * n_moe
    rows = cfg.moe_experts * moe_capacity(tokens, cfg)
    static = base + 6 * per_row * rows * n_moe
    return routed, static, rows


def phase_train_mixtral(library, dev, by_path) -> dict:
    """Phase 15g: mixtral-8x7b at full width (d_model 4096, 8 experts of
    d_ff 14336, top-2, 32 query heads on 8 KV heads) and ``MIX_TRAIN_LAYERS``
    of its 32 layers, bf16, ``MIX_TRAIN_STEPS`` steps with ``remat`` on one
    fixed batch of 4 x 512 tokens from the seed-0 state: the loss falls at
    each step; ms a step (the median after the first), tokens/s and the
    peak against two bounds at 989 TFLOP/s (the experts top-2 routing
    needs, and the static dispatch's E x C rows); the flash and rmsnorm
    backward launches by shape.  No checkpoint (the state is 35+ GB).  The
    plain versions are barred from CUDA tensors.  Returns the launches a
    step, the peak and the bytes allocated before the run for phase 20."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.data import DataConfig, synth_batch
    from repro_torch.training.optimizer import AdamWConfig, leaf_paths

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=MIX_TRAIN_LAYERS)
    b, s_ = MIX_TRAIN_BATCH, MIX_TRAIN_SEQ
    nb = synth_batch(cfg, ShapeConfig("fixed", s_, b, "train"), 0, DataConfig())
    label = f"phase 15g mixtral-8x7b ({cfg.n_layers} layers) fixed batch"
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()          # no argument of the step is made yet
    torch.cuda.reset_peak_memory_stats()
    with PlainOnCard(), FlashBackwardShapes() as fb, RmsnormBackwardShapes() as rb:
        (params, _, losses, secs), by_path[label] = run_path(
            library, label, TRAIN_KERNELS,
            lambda: fixed_batch(cfg, AdamWConfig(lr=FIXED_LR, warmup_steps=1), nb, dev,
                                steps=MIX_TRAIN_STEPS, remat=True))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for v in losses) and all(y < x for x, y in zip(losses, losses[1:])),
          f"15g: the fixed batch's loss did not fall at every step: {losses}")
    n_params = sum(p.numel() for _, p in leaf_paths(params))
    routed, static, rows = moe_train_flops(cfg, params, b, s_)
    step_ms = float(np.median(secs[1:])) * 1e3
    peak_rate = PEAK_FLOPS[torch.bfloat16]
    print(f"[15g] {label}: {n_params} params; losses {losses}; ms per step "
          f"{[round(t * 1e3, 1) for t in secs]} (the first builds); step {step_ms:.1f} ms, "
          f"{b * s_ / step_ms * 1e3:.0f} tokens/s, peak {peak / 1e9:.2f} GB")
    print(f"[15g] bounds at {peak_rate / 1e12:.0f} TFLOP/s: top-{cfg.moe_top_k} routing "
          f"{routed / 1e12:.3f} TFLOP = {routed / peak_rate * 1e3:.3f} ms "
          f"({routed / peak_rate * 1e3 / step_ms:.2%} of the step); the static dispatch's "
          f"{rows} rows a layer ({cfg.moe_experts} x capacity, for {b * s_ * cfg.moe_top_k} "
          f"pairs) {static / 1e12:.3f} TFLOP = {static / peak_rate * 1e3:.3f} ms")
    steps = MIX_TRAIN_STEPS
    print(f"[15g] launches per step { {k: n / steps for k, n in by_path[label].items() if n} }; "
          f"flash backward by (q, k, causal) { {k: n // steps for k, n in fb.shapes.items()} }, "
          f"rmsnorm backward by (rows, d) { {k: n // steps for k, n in rb.shapes.items()} } a "
          f"step")
    want = ((b, s_, cfg.n_heads, cfg.d_head), (b, s_, cfg.n_kv_heads, cfg.d_head), True)
    check(list(fb.shapes) == [want]
          and fb.shapes[list(fb.shapes)[0]] == steps * cfg.n_layers,
          f"15g: flash backward launches by shape {dict(fb.shapes)}")
    # two norms a layer over every token; the loss's final norm once for
    # each of its two 256-position chunks
    check(dict(rb.shapes) == {(b * s_, cfg.d_model): steps * 2 * cfg.n_layers,
                              (b * s_ // 2, cfg.d_model): steps * 2},
          f"15g: rmsnorm backward launches by shape {dict(rb.shapes)}")
    print(f"[15g] rmsnorm backward launches a step by route: {rb.by_route(steps)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"15g": dict(launches={k: n / steps for k, n in by_path[label].items() if n},
                        peak=peak, other=base)}


def tensor_bytes(*trees) -> int:
    """Bytes of the distinct storages under the tensor leaves of nested
    dicts, tuples and lists."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    for t in trees:
        walk(t)
    return sum(seen.values())


# phase 20: the dry run's trace of each step, held against the step on the
# card (15c with and without remat, 15e with and without, 15g, and one
# qwen3-0.6b decode step at phase 3's served shape)
DRYRUN_FILE = "phase20_predictions.json"      # in BESIDE_DIR
# predicted peak against the measured one: the eager-lifetime model read
# within 0.01% on all six steps, a walk freeing each buffer after its last
# reader 15-17.5% low on four of them (PERF.md)
DRYRUN_PEAK_TOL = 0.02
DRYRUN_TOP = ("15e", "15e no remat", "15g")    # their largest buffers printed


def dryrun_steps():
    """(key, arch, config overrides, shape, remat) of each step phase 20
    predicts, at the shapes phases 3 and 15 run them."""
    from repro_torch.configs.base import ShapeConfig

    train = ShapeConfig("fixed", 512, 4, "train")
    mix = ShapeConfig("fixed", MIX_TRAIN_SEQ, MIX_TRAIN_BATCH, "train")
    return [
        ("15c", "qwen3-0.6b", {}, train, True),
        ("15c no remat", "qwen3-0.6b", {}, train, False),
        ("15e", "zamba2-1.2b", {}, train, True),
        ("15e no remat", "zamba2-1.2b", {}, train, False),
        ("15g", "mixtral-8x7b", {"n_layers": MIX_TRAIN_LAYERS}, mix, True),
        ("decode", "qwen3-0.6b", {}, ShapeConfig("served", BUCKET, 1, "decode"), True),
    ]


def phase_dryrun_traces(device: str = "cuda") -> dict:
    """Phase 20, host side (in the second process: it allocates nothing on
    the card): ``repro_torch.launch.dryrun``'s whole-program trace of each
    step of ``dryrun_steps`` on ``device``, its launches by kernel and its
    eager-lifetime peak with the largest buffers there, written to
    ``DRYRUN_FILE`` for the main process."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    out = {}
    t_all = time.perf_counter()
    for key, arch, kw, shape, remat in dryrun_steps():
        cfg = dataclasses.replace(get_config(arch), **kw)
        whole, _ = dryrun.trace_cell(cfg, shape, device, remat=remat)
        cost, live = whole["cost"], whole["liveness"]
        out[key] = dict(launches=cost["launches"], n_nodes=cost["n_nodes"],
                        trace_s=whole["trace_seconds"], analysis_s=whole["analysis_seconds"],
                        peak=live["peak_bytes"], peak_op=live["peak_op"],
                        top=live["top_buffers"], argument_bytes=live["argument_bytes"])
        print(f"[phase 20] traced {key} ({arch} {kw or ''} {shape.global_batch} x "
              f"{shape.seq_len} {shape.kind}{'' if remat or shape.kind != 'train' else ', no remat'}) "
              f"on {device}: {cost['n_nodes']} nodes in {whole['trace_seconds']:.1f} s, analysis "
              f"{whole['analysis_seconds']:.1f} s; launches {cost['launches']}; peak "
              f"{live['peak_bytes'] / 1e9:.3f} GB, arguments {live['argument_bytes'] / 1e9:.3f} GB",
              flush=True)
    with open(os.path.join(BESIDE_DIR, DRYRUN_FILE), "w") as f:
        json.dump(out, f)
    print(f"[phase 20] traces: {time.perf_counter() - t_all:.1f} s")
    return out


def measure_decode_step(library, dev, by_path) -> dict:
    """One qwen3-0.6b ``decode_step`` at phase 3's served shape (batch 1, a
    cache of ``BUCKET``), after a first call that builds, with the launch
    counts and the peak read around it."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(cfg, 0, dev)
    cache = lm.init_cache(cfg, 1, BUCKET, dev)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(PROMPT_LEN, dtype=torch.int32, device=dev)
    lm.decode_step(params, tok, cache, pos, cfg)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated() - tensor_bytes(params, cache, tok, pos)
    torch.cuda.reset_peak_memory_stats()
    label = "phase 20 qwen3-0.6b decode_step"

    def step():
        out = lm.decode_step(params, tok, cache, pos, cfg)
        torch.cuda.synchronize()
        return out

    out, by_path[label] = run_path(library, label, ("rmsnorm", "decode_attention"), step)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(out[0]).all()), "phase 20: the decode step's logits are not finite")
    del out, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches={k: float(n) for k, n in by_path[label].items() if n}, peak=peak,
                other=other)


def top_lines(buffers) -> str:
    return "; ".join(f"{b['name']} {tuple(b['shape'])} {b['dtype']} {b['bytes'] / 1e9:.3f} GB"
                     for b in buffers)


def phase_dryrun_check(library, dev, by_path, measured: dict) -> None:
    """Phase 20, card side: each step's launches by kernel from its trace
    equal the launches a step the card made, exactly, and the predicted
    peak (the eager-lifetime peak, the arguments live throughout, plus what
    was allocated before the step and is not its argument) is within
    ``DRYRUN_PEAK_TOL`` of ``torch.cuda.max_memory_allocated()``; the
    largest buffers at the predicted peak are printed for 15e and 15g."""
    with open(os.path.join(BESIDE_DIR, DRYRUN_FILE)) as f:
        pred = json.load(f)
    measured = dict(measured, decode=measure_decode_step(library, dev, by_path))
    for key, *_ in dryrun_steps():
        p, m = pred[key], measured[key]
        want = {k: float(n) for k, n in p["launches"].items()}
        predicted = p["peak"] + m["other"]
        miss = predicted / m["peak"] - 1
        print(f"[phase 20] {key}: launches a step traced {want}, on the card {m['launches']} "
              f"(equal: {want == m['launches']}); peak predicted {predicted / 1e9:.3f} GB "
              f"(traced {p['peak'] / 1e9:.3f} + allocated before {m['other'] / 1e9:.3f}; "
              f"at {p['peak_op']}), measured {m['peak'] / 1e9:.3f} GB: {miss:+.4%}")
        check(want == m["launches"], f"phase 20 {key}: traced launches {want} != measured "
                                     f"{m['launches']}")
        check(abs(miss) <= DRYRUN_PEAK_TOL,
              f"phase 20 {key}: predicted peak {predicted} vs measured {m['peak']} ({miss:+.2%})")
        if key in DRYRUN_TOP:
            print(f"[phase 20] {key} largest buffers at the predicted peak: "
                  f"{top_lines(p['top'])}")


# phases 7-9, 16-17, 18b and 19 run in a second process on the card (``BESIDE``), started
# once phase 2's kernel timings are done and joined before phase 15: the
# served paths are host-bound (the card idle 67-92% of a replayed step), so
# two processes share its idle time
BESIDE = "--phases-8-9"
BESIDE_DIR = os.path.join(ROOT, "build", "phases_8_9")


def setup():
    """The kernel library and the card, with TF32 and reduced-precision
    bf16 sums off; fails where no CUDA device is present."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    from repro_torch.kernels import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return library, torch.device("cuda")


def start_beside():
    """Start phases 7-9, 16-17, 18b and 19 (and phase 20's traces) in a
    second process on the card, its output in a file that ``join_beside``
    prints; the process is killed if this one exits first."""
    import atexit

    os.makedirs(BESIDE_DIR, exist_ok=True)
    log = open(os.path.join(BESIDE_DIR, "log.txt"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), BESIDE, str(os.getpid())],
                            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, log, time.perf_counter()


def join_beside(beside) -> dict:
    """Wait for the process of phases 7-9, 16-17, 18b and 19, print its output and return
    its launches by path; fail if it failed."""
    proc, log, t_start = beside
    t0 = time.perf_counter()
    rc = proc.wait()
    log.close()
    with open(log.name) as f:
        print(f.read(), end="")
    print(f"[phases 7-9, 16-17, 18b, 19] in a second process beside phases 3-6, 10-14 and 18a: exit {rc}; joined "
          f"{t0 - t_start:.1f} s after its start, then waited {time.perf_counter() - t0:.1f} s")
    check(rc == 0, "phases 7-9, 16-17, 18b and 19 failed (their output above)")
    with open(os.path.join(BESIDE_DIR, "launches.json")) as f:
        out = json.load(f)
    return out["by_path"], out["batched_rows"]


def beside_main(parent: int) -> None:
    """The second process: phases 7-9, 16-17, 18b and 19, their launches by path written
    for ``join_beside``, then phase 20's traces (host only) written for
    ``phase_dryrun_check``.  It ends with the run that started it."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGTERM)   # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        fail("the run that started phases 7-9, 16-17, 18b and 19 has ended")
    library, dev = setup()
    by_path, batched_rows = phases_8_9(library, dev)
    with open(os.path.join(BESIDE_DIR, "launches.json"), "w") as f:
        json.dump({"by_path": by_path, "batched_rows": batched_rows}, f)
    phase_dryrun_traces()


def main() -> None:
    if BESIDE in sys.argv[1:]:
        return beside_main(int(sys.argv[sys.argv.index(BESIDE) + 1]))
    library, dev = setup()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    paths = library.build_all(verbose=True)
    hgmma = sass_count(str(paths["flash_attention"]), "HGMMA")
    print(f"flash_attention SASS: {hgmma} HGMMA instructions (the bf16 route's wgmma)")
    check(hgmma > 0, "flash_attention's library has no HGMMA: the tensor cores are not used")
    for name in ("ssm_scan", "flash_attention_backward", "ssm_scan_backward"):
        hmma = sass_count(str(paths[name]), "HMMA")
        print(f"{name} SASS: {hmma} HMMA instructions (the bf16 route's mma.sync)")
        check(hmma > 0, f"{name}'s library has no HMMA: the tensor cores are not used")
    for name, marker in (("flash_attention_backward", "dq_mma_kernel"),
                         ("ssm_scan_backward", "dbc_mma_kernel")):
        lines = library.PTXAS.get(name, [])
        spills = [line for line in lines if "mma_kernel" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        check(any(marker in line for line in lines) and not spills,
              f"{name}'s mma kernels spill or are missing: {spills}")
    print(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows, extra_rows = phase_kernels(dev)
    phase_small_reference(dev)
    check(not MISMATCHES, f"{len(MISMATCHES)} kernel checks disagreed with the plain versions")
    print(f"[phase 2] kernels vs plain versions: ok ({time.perf_counter() - t0:.1f} s)")
    if "--kernels-only" in sys.argv[1:]:
        print("--kernels-only: stopping before the served paths")
        sys.exit(0)
    beside = start_beside()

    by_path = {}
    attn = ("rmsnorm", "decode_attention", "flash_attention")
    m, by_path["qwen3-0.6b"] = run_path(
        library, "phase 3 qwen3-0.6b stateful", attn,
        lambda: phase_main_path(dev, "qwen3-0.6b", PROMPT_LEN, NEW_TOKENS, BUCKET))
    check_main_path(m)
    q_step = measure_replay_step(m, dev)
    check_prefill_vs_decode(m, dev, LOGIT_REL_TOL)
    q_cfg, q_params, q_prompt, q_dev_tokens = m["cfg"], m["params"], m["prompt"], m["r_dev"].tokens
    t10 = time.perf_counter()
    seg_a, by_path["phase 10a qwen3-0.6b segments"] = run_path(
        library, "phase 10a qwen3-0.6b segments", ("rmsnorm", "decode_attention"),
        lambda: split_segments_qwen(library, m, dev))
    del m
    torch.cuda.empty_cache()
    split, by_path["phase 10b qwen3-0.6b split served"] = run_path(
        library, "phase 10b qwen3-0.6b split served", ("rmsnorm", "decode_attention"),
        lambda: split_served_qwen(dev, q_cfg, q_params, q_prompt, q_dev_tokens, BUCKET))
    time_split_token(split, dev)
    del split
    t10 = time.perf_counter() - t10
    torch.cuda.empty_cache()
    t11, q_migrated = phase_fault_qwen(library, dev, q_cfg, q_params, q_prompt, q_dev_tokens, BUCKET,
                                       by_path)
    torch.cuda.empty_cache()

    m, by_path["zamba2-1.2b"] = run_path(
        library, "phase 4 zamba2-1.2b stateful", attn + ("ssm_scan",),
        lambda: phase_main_path(dev, "zamba2-1.2b", Z_PROMPT, Z_NEW, Z_BUCKET))
    check_main_path(m)
    measure_replay_step(m, dev, profile=True)
    check_prefill_vs_decode(m, dev, HYBRID_LOGIT_REL_TOL)
    params = m["params"]
    del m

    m, by_path["zamba2-1.2b stateless"] = run_path(
        library, "phase 5 zamba2-1.2b stateless", ("rmsnorm", "flash_attention", "ssm_scan"),
        lambda: phase_main_path(dev, "zamba2-1.2b", Z_PROMPT, Z_NEW, Z_STATELESS_BUCKET,
                                stateful=False, params=params))
    check_main_path(m, {"ssm_scan": m["cfg"].n_layers})
    measure_replay_step(m, dev, profile=True)
    t0 = time.perf_counter()
    seg_c, by_path["phase 10c zamba2-1.2b stateless segments"] = run_path(
        library, "phase 10c zamba2-1.2b stateless segments",
        ("rmsnorm", "flash_attention", "ssm_scan"), lambda: split_segments_zamba(library, m, dev))
    t10 += time.perf_counter() - t0
    z_verify = dict(calls=m["sess"].client._ios_calls, plans=seg_c["plans"],
                    min_repeats=m["sess"].client.min_repeats)
    t0 = time.perf_counter()
    _, by_path["phase 11b zamba2-1.2b stateless outage"] = run_path(
        library, "phase 11b zamba2-1.2b stateless outage", ("rmsnorm", "flash_attention", "ssm_scan"),
        lambda: phase_fault_zamba(dev, m["cfg"], params, m["prompt"], m["r_dev"].tokens,
                                  Z_STATELESS_BUCKET))
    t11 += time.perf_counter() - t0
    z_cfg, z_prompt, z_dev_tokens = m["cfg"], m["prompt"], m["r_dev"].tokens
    del m
    torch.cuda.empty_cache()

    # phase 6 runs cuDNN convolutions: deterministic algorithms, no TF32, no
    # autotuning, so rrto's replay and device_only make the same calls
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"cudnn: allow_tf32 {torch.backends.cudnn.allow_tf32}, deterministic "
          f"{torch.backends.cudnn.deterministic}, benchmark {torch.backends.cudnn.benchmark}; "
          f"matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    k, by_path["kapao"] = run_path(library, "phase 6 kapao", (), lambda: phase_kapao(dev))
    check_kapao(k, dev)
    rrto, timer = k["runs"]["rrto"]
    measure_cnn_step("kapao", rrto, timer, k["model"].example_inputs, dev, profile=True)
    kapao_verify = dict(calls=rrto.client._ios_calls, client_device=rrto.client_device,
                        server_device=rrto.server_device, min_repeats=rrto.client.min_repeats)
    del k, rrto, timer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_zoo(dev)
    print(f"[phase 6 zoo] ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    _, by_path["phase 10d sensor models split"] = run_path(
        library, "phase 10d sensor models split", (), lambda: split_sensor_models(dev))
    t10 += time.perf_counter() - t0
    print(f"[phase 10] split and pipelined replay: {t10:.1f} s over parts a-d")
    t0 = time.perf_counter()
    _, by_path["phase 11c sensor encoder outage"] = run_path(
        library, "phase 11c sensor encoder outage", (), lambda: phase_fault_sensor(dev))
    t11 += time.perf_counter() - t0
    print(f"[phase 11] fault tolerance: {t11:.1f} s over parts a-c")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    zamba = ("rmsnorm", "flash_attention", "ssm_scan")
    over, by_path["phase 12a zamba2-1.2b stateless overload"] = run_path(
        library, "phase 12a zamba2-1.2b stateless overload", zamba,
        lambda: phase_overload(dev, z_cfg, params, z_prompt, z_dev_tokens, Z_STATELESS_BUCKET))
    _, by_path["phase 12b zamba2-1.2b round formation"] = run_path(
        library, "phase 12b zamba2-1.2b round formation", zamba,
        lambda: phase_round_formation(library, over))
    t12 = time.perf_counter() - t0
    phase_obs(library, dev, by_path,
              dict(cfg=z_cfg, params=params, prompt=z_prompt, dev_tokens=z_dev_tokens),
              dict(cfg=q_cfg, params=q_params, prompt=q_prompt, migrated=q_migrated,
                   graph=seg_a["graph"]), over)
    qa_plans = seg_a["plans"]
    del over, params, seg_a, q_migrated
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    q_shed, by_path["phase 12c qwen3-0.6b stateful shed"] = run_path(
        library, "phase 12c qwen3-0.6b stateful shed", ("rmsnorm", "decode_attention"),
        lambda: phase_overload_stateful(dev, q_cfg, q_params, q_prompt, q_dev_tokens, BUCKET))
    del q_params
    torch.cuda.empty_cache()
    _, by_path["phase 12d sensor encoder degraded split"] = run_path(
        library, "phase 12d sensor encoder degraded split", (), lambda: phase_overload_split(dev))
    print(f"[phase 12] admission and overload: {t12 + time.perf_counter() - t0:.1f} s over parts a-d")

    t0 = time.perf_counter()
    v_secs, by_path["phase 14 replay soundness verifier"] = run_path(
        library, "phase 14 replay soundness verifier", (),
        lambda: phase_verifier(dev, dict(q_shed, plans=qa_plans), z_verify, kapao_verify))
    del q_shed, z_verify, kapao_verify
    torch.cuda.empty_cache()
    print(f"[phase 14] replay soundness verifier: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in v_secs.items())})")

    t0 = time.perf_counter()
    phase_qwen3_int8(library, dev, by_path, q_step)
    print(f"[phase 18a] ({time.perf_counter() - t0:.1f} s)")

    beside_paths, batched_rows = join_beside(beside)
    by_path.update(beside_paths)

    t0 = time.perf_counter()
    with PlainOnCard():
        _, by_path["phase 15a reduced train steps"] = run_path(
            library, "phase 15a reduced train steps",
            TRAIN_KERNELS + ("ssm_scan", "ssm_scan_backward"), lambda: phase_train_small(dev))
        phase_train_small_resume(library, by_path)
        phase_train_moe_resume(library, dev, by_path)
    phase_scan_backward_in_model(dev)
    print(f"[15a] ({time.perf_counter() - t0:.1f} s)")
    trained = phase_train_full(library, dev, by_path)
    t1 = time.perf_counter()
    witness_rounding_calls(dev, trained["losses"])
    print(f"[15d] rounding witness ({time.perf_counter() - t1:.1f} s)")
    measured = dict(trained["measured"])
    t1 = time.perf_counter()
    measured.update(phase_train_zamba(library, dev, by_path)["measured"])
    print(f"[15e] ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    phase_train_xlstm(library, dev, by_path)
    print(f"[15f] ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    measured.update(phase_train_mixtral(library, dev, by_path))
    print(f"[15g] ({time.perf_counter() - t1:.1f} s)")
    print(f"[phase 15] training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dryrun_check(library, dev, by_path, measured)
    print(f"[phase 20] the dry run against the card: {time.perf_counter() - t0:.1f} s")
    print(f"launches by path: {by_path}")

    kernels = []
    for name in library.KERNELS:
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=os.path.relpath(library.source_path(name), ROOT),
            replaces=REPLACES[name],
            launches=sum(counts[name] for counts in by_path.values()),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"],
            launches_by_path={path: counts[name] for path, counts in by_path.items()},
            batched=batched_rows.get(name),
            more=[{k: v for k, v in r.items() if k != "name"} for r in extra_rows
                  if r["name"] == name],
        ))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
