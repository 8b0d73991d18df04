#!/usr/bin/env python3
"""Drive the PyTorch port's serve path, its LM backend, its training
path and its kernels once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and count, and ``nvidia-smi``'s name and
   power limit (also printed raw on a line of its own);
2. build — builds the CUDA kernels (``ingest.cu``, ``hist.cu``,
   ``flash.cu``) from ``src/`` with nvcc (``repro_torch.kernels.build``),
   one process per library, started together;
3. kernel — the CUDA ``ingest_batch`` against its plain PyTorch version
   on the card at the serve shape (8 cameras x 8 frames of 720x1280, two
   colors): bg_valid=True, and bg_valid=False with the bounding box;
   errors, differing count units, two calls bit-identical, a call's and
   the kernel's device milliseconds beside the plain version's and the
   bound, achieved GB/s (also as if the background lane had gone through
   HBM on every frame), a streaming ``rgb.sum()`` as a yardstick of the
   reachable HBM rate, the work plan, the kernel's ptxas registers and
   spills and its device launches a call; then ``kernel_barrier``, what
   a frame costs beyond its pixels at the full resident grid;
4. serve — ``open_session`` on the card, ``fit`` on PFs from
   ``session.ingest`` of a training clip, then per step
   ``report_backend_latency`` -> ``step(frames)`` -> ``next_frames``;
   the kernel's launch counter must rise on every step, and the card's
   utilities (read back from the CDF ring they were pushed to) replayed
   into a ``device="cpu"`` session started from the same state must give
   bit-identical decisions, evictions, rates, pops and queue lanes;
5. profile — a profiled window of serve steps (the ingest kernel's
   device time and launches a step; a window with device events but no
   ingest kernel fails), then the control plane alone;
5a. fleet — camera-sharded serving (``repro_torch.core.fleet``): 16
   cameras x 8 frames of 720x1280 a step (the serve cell's seeded scenes
   and 8 more, the serve phase's model); 10 ticked ``step(frames)``
   calls of an unsharded card session, then of sessions on 4 and on 2
   shards of the card (``fleet_mesh(S, device=card)``), each with the
   ingest launch counter at 0, S launches a step, and every step held
   bit for bit to the unsharded one (decisions, evictions, rates, every
   gathered lane with ``bg`` and ``gain``, ``next_frames``); their
   ``last_fleet_stats``/``fleet_stats()`` against NumPy over the gathered
   lanes; the 4-shard session checkpointed after step 5 and restored
   into a 2-shard card, an unsharded card and a CPU session (replaying
   the card's utilities), all equal to the live session in steps 6–10;
   step medians, a profiled window per session (device ms, kernels and
   ingest launches a step), peak memory; the control plane at the
   reference bench's fleet scale (1024 cameras, W 512, T 8, 8 shards) 4
   steps bit-identical, timed unsharded, sharded and as one shard's
   program; a mesh of distinct cards where the machine has more than one;
5b. cascade — the two-stage semantic cascade (``repro_torch.cascade``)
   at the serve shape: ``fit_scorer`` on the card over three seeded
   training scenes of 48 frames (bboxes from the fused ingest's bbox
   instantiation), the scorer's checkpoint round trip, the card scorer
   against the same weights on the CPU over 64 frames at
   ``CASC_SCORE_TOL``; then a cascade session (``MLPScorer`` at its
   defaults, ``gate_fraction`` 0.5) for 10 ticked ``step(frames)`` calls
   (each launching the ingest kernel's bbox instantiation), held bit for
   bit to a CPU session replaying the card's utilities and stage-2
   scores; a checkpoint after step 5 restored into a card session
   (stepping the same frames) and a CPU session (replaying), both
   bit-identical to the live session; both gates must shed; the step's
   median beside the single-stage serve step's, and its parts (the
   ingest call and its device time, phase A with the survivors' index,
   the scorer cropping from the batch, phase B with the tick); a
   profiled window of three steps (reported per step) must show the
   ingest kernel;
6. hist — the CUDA ``hsv_hist_batch`` against its plain version at the
   serve shape (64 frames of 720x1280, two colors) in five cases
   (``hist_weights``): the foreground mask of ``data/background.py``'s
   ``batch_foreground`` (5.7 % foreground) as a bool mask and as float
   0/1 weights (both exact), an all-true mask (exact), seeded uniform
   (0, 1] weights (within ``HIST_FLOAT_RTOL``) and seeded dyadic weights
   k/8 (exact: their sums are exact in float32); float cases called twice
   and bit-identical; per case a call's ms, the kernel's device ms and
   device launches a call (``torch.profiler``; one expected), the plain
   version's ms, ``bound_ms`` from the bytes these weights need
   (``kernel.hist_bytes_read``: the weights, the RGB sectors under
   non-zero weights, the outputs) beside ``dense_bound_ms`` (every pixel
   read, ``hist_bytes_moved``), achieved GB/s against both, and the
   kernel's ptxas registers and spills; then the staged entry point
   ``batch_pf`` over those frames (one kernel call) against the plain
   path;
7. service — ``ServeService.run`` (virtual clock, seeded mock backend,
   the launcher's coalescer settings) over a card session fitted as
   ``repro_torch.launch.serve`` fits one, 8 cameras x 48 frames of
   720x1280 through the fused ``step(frames=...)`` dispatch, timed per
   dispatch; the same arrivals with the card's precomputed utilities and
   no frames, served through ``offer_batch`` by a ``device="cpu"``
   session started from the same state, must keep the same frames on the
   same timeline with the same counters;
8. lm — smollm-135m at full width (30 layers, d 576, 9/3 heads, vocab
   49152; weights from a seeded generator): the card's float32
   ``lm_forward`` at B=1, S=128 against the same forward on the CPU: at
   the first ``LM_CUT_LAYERS`` layers within 1e-4, and at full depth both
   held to the CPU's float64 forward (the card must be as close to it as
   the CPU's float32 is, within ``LM_F32_SLACK``); the
   bf16 forward timed at the backend's shape (1 x 64) and at 4 x 2048
   with its peak memory, then ``python -m repro_torch.launch.serve
   --real-backend`` (``main``) on the card: the service with
   ``make_lm_backend()`` as its backend must admit and send frames;
8a. decode — token-by-token serving of that smollm (``held_decode``):
   2 layers deep in float32, 128 seeded tokens prefilled into 256 slots
   on the card and the CPU (first logits within 1e-4, ``pos`` exact, k/v
   within a bf16 ulp), then 16 teacher-forced steps on both from the
   card's cache copied to the CPU, with a bf16 and with an int8 cache:
   the card's cache updated in place, ``pos`` equal, each step's logits
   no farther from the CPU's than the CPU's decode is from the float32
   forward, differing cache entries counted; decode vs forward at full
   depth on the card within ``LM_F32_SLACK`` x the CPU's; bf16
   ``make_prefill_step`` at 1 x 128 and 8 x 1024, greedy
   ``make_decode_step`` with 2048 slots at B = 1 and 8, bf16 and int8
   caches (``timed_decode``: ms a token, tokens/s, cache and peak bytes,
   one profiled step); then decode_ring: gemma3-12b at full width, one
   pattern period (6 of 48 layers) in float32, 1000 tokens prefilled on
   the card, 40 steps on both past the 1024-token window, every ring's
   ``pos`` holding positions 16..1039;
8b. moe — granite-moe-1b-a400m at full width: layer 0's MoE input (1 x
   128, float32, from the CPU) through ``_route``/``moe_apply`` on both:
   routing flips counted with the CPU's k-th/(k+1)-th probability gap,
   outputs of identically routed tokens within 1e-4, the card's aux with
   the CPU's routing within 1e-5; scatter vs one-hot on the card, both
   timed; bf16 forwards at 1 x 64 and 4 x 2048 (ms, peak, one profiled
   forward each) and greedy decode at B = 1;
8c. ssm — the recurrent, hybrid and encoder-decoder LMs at full width,
   weights drawn on the card, one line each: xlstm-125m (9 mLSTM + 3
   sLSTM blocks) — its first pattern period card vs CPU at
   ``LM_CUT_TOL``, the full depth held to a CPU float64 forward as the lm
   phase holds smollm, 128 tokens prefilled and 16 teacher-forced steps
   on both (first period; float32 state leaves within ``LM_CUT_TOL`` of
   their largest value), decode vs forward at full depth; zamba2-2.7b
   (45 Mamba2 blocks, one shared attention + MLP block used 9 times) —
   one pattern period (6 of 54 layers, ``reduced``) copied to the CPU:
   the float32 forward over whole 256-token chunks held to float64, 512
   tokens prefilled on the card and 16 steps on both; whisper-tiny (4 +
   4 layers, 1500 seeded audio frames) — encoder output, cross K/V and
   logits held to float64 at full depth, 128 tokens prefilled and 16
   steps on both, ``cross_kv`` unchanged by them; then for each bf16
   forwards (1 x 64 and, but for whisper, 4 x 2048: ms, peak bytes, one
   profiled 1 x 64 forward), xlstm's and zamba2's mixers alone at 4 x
   2048, zamba2's prefill 1 x 512, and greedy decode (xlstm at B = 1 and
   8, the others at B = 1: ms a token, one profiled step);
8d. train — the training path, one line a part: (a) smollm-135m at full
   width, 2 layers, float32: one ``make_train_step`` card vs CPU, both
   held to a float64 step (``held_train_step``); (b)
   ``launch.train.main`` at full depth (40 steps of 8 x 256, bf16
   compute, a fault injected at step 25, checkpoints every 10 steps):
   one restart, the last checkpoint at step 40, the loss falling; ms a
   step, tokens/s, peak bytes, checkpoint save and restore seconds, one
   profiled step; (c) remat "block" against "none" at full depth, loss
   and gradients bit for bit, and the peak bytes of each; (d)
   ``make_dp_compressed_train_step`` over 4 pods of the card, int8 and
   top-k, 3 steps held to the CPU, the error-feedback sums exact to
   1e-5; (e) ``make_pp_loss`` over 3 stages of the card, 30 layers in
   float32, 6 microbatches, within 1e-5 of the unpipelined loss over
   the same microbatches, every stage with a gradient; (f) granite-moe,
   xlstm, zamba2 and whisper at full width, one pattern period deep:
   one float32 step held as (a), one step in their own dtype;
8e. mesh — the sharding layer on DTensor, one line a part: (a)
   ``launch.train.build(data_axis=2, model_axis=2)`` clamps to a
   ``(1, 1)`` mesh on one card (a one-rank NCCL group) and runs a first
   and MESH_STEPS timed steps of smollm-135m at full width (B 8 x S 256)
   bit for bit equal to the plain ``build()``'s; the same steps on a ``(1, 1)`` DTensor
   mesh (``launch.train.shard_training``), DTensor's dispatch cost; ms a
   step for each; (b) ``python -m repro_torch.launch.dryrun`` of
   smollm-135m ``train_4k`` on 16 x 16 and 2 x 16 x 16 and ``decode_32k``
   on 16 x 16, of xlstm-125m ``prefill_32k`` on 16 x 16 (its sLSTM
   recorded one step deep and counted 32,768 times), of
   granite-moe-1b-a400m ``train_4k`` on 16 x 16 (no allocation holds the
   whole MoE dispatch buffer: each rank scatters into its own batch
   rows), of internlm2-20b ``train_4k`` on 16 x 16 with ``--opt
   seq_shard --opt attn_remat`` (the record names both), of
   chameleon-34b ``train_4k`` with the same levers (it fits 80 GB, and
   no allocation at its peak holds all 64 query heads: each rank attends
   its own against its 8 whole KV heads), of zamba2-2.7b
   ``decode_32k`` (its Mamba2 mixers split over their heads; the line
   gives its collective bytes) and of zamba2-2.7b ``long_500k`` on 16 x
   16 and 2 x 16 x 16 (its shared attention's 524,288-slot cache split
   along the slots and the KV heads stays split: fewer than
   ``MESH_LONG_COLLECTIVE_GB`` of collectives a token; the line gives
   the peak, the collective bytes and the dominant roofline term), each
   in a
   subprocess started once (a) has ended (so
   that (a)'s host-bound steps have the host to themselves), over a
   fake world (no device touched): peak bytes a device against 80 GB
   and the largest allocations live at that peak, FLOPs, collective
   bytes by kind, roofline terms, seconds; (c) with more
   than one card, 2 NCCL ranks (``torch.distributed.run``, this script's
   ``--mesh-worker``) on a ``data=2`` mesh held to the one-card step
   (``mesh_worker``), a ring prefill of gemma3-12b's local layer at full
   width into a cache split along its slots over ``model=2`` held to
   one card, and ``TokenPipeline(shardings=)`` batches held to the
   unsharded pipeline's; on one card a skip line;
9. flash — the CUDA ``flash_attention`` through its entry points, with
   the launch counter at 0, on (a) layer 0's q, k, v of that full-width
   smollm at 4 x 2048 (projected and roped as ``attend_full`` does,
   through ``flash_attention_bsnh``), (b) gemma3-12b's local-layer widths
   (1 x 4096, 16/8 heads of 256, window 1024), (c) 512 queries at the
   tail of 2048 keys and a padded S=2000, each in float32 and bf16, and
   (a) in float32 with q scaled by 1/8; then each held to
   ``attention_ref`` at 2e-6 / 2e-2 (case (a) in float32 to the float64
   answer, see ``FLASH_F64_HELD``) and timed (kernel, plain version, and
   ``scaled_dot_product_attention`` as a yardstick) beside its bound;
   ``ms`` is one entry-point call (the wrapper's host work and the
   padded case's copies included), ``kernel_device_ms`` the kernel's own
   device time and ``library_device_ms`` SDPA's, from ``torch.profiler``
   (each of their kernels launches once a call; null where three
   profiler sessions in a row delivered no device event); each line
   names the kernel that ran (``cuda_core_fp32``, the CUDA-core kernel,
   with its split count ``n_split`` and ``f32_bound_share``, the share of
   its float32 CUDA-core bound that its device time reaches; or
   ``mma_bf16``, the tensor-core kernel), each with its registers and
   spills from the build log, and a bf16 line its speed-up over the same
   case in float32;
10. the ``kernels`` line, then the final ``{"ok": true, ...}`` line.

Frames are seeded synthetic traffic scenes (``data/synthetic.py``) at
90x160, upsampled x8 by nearest neighbour to 720x1280. Any failure raises
and exits non-zero; there is no CPU path.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
C, T, H, W, UP = 8, 8, 90, 160, 8          # 720x1280 after upsampling
TRAIN, STEPS, K_SEND = 16, 10, 40
SVC_CAMS, SVC_FRAMES, SVC_TRAIN = 8, 48, 3   # service phase: the launcher's
SVC_FPS, SVC_BOUND = 30.0, 0.5               # query, fps and coalescer
SVC_MAX_BATCH, SVC_MAX_WAIT = 8, 0.05
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, data sheet
F32_OPS_PER_S = 67e12                       # float32 outside tensor cores
BF16_OPS_PER_S = 989e12                     # bf16 tensor cores, dense
LM_ARCH = "smollm-135m"
LM_CHECK_SHAPE, LM_SHAPES = (1, 128), ((1, 64), (4, 2048))
# The full-width forward on random weights amplifies rounding ~1.7x a
# layer (measured on the CPU against float64 at depths 2, 5 and 10), so
# after 30 layers two float32 runs differ by ~1e-2. The card must be as
# close to the float64 logits as the CPU's float32 forward is, within
# this factor.
LM_F32_SLACK = 4.0
# Where rounding has not grown yet (the same weights, the first 2
# layers: float32 is ~2e-5 from float64 there on the CPU), the card's
# float32 logits must match the CPU's at 1e-4 (atol and rtol, the CPU
# tests' float32 tolerance against the reference).
LM_CUT_LAYERS, LM_CUT_TOL = 2, 1e-4
LM_SVC_ARGS = ["--real-backend", "--cams", "4", "--frames", "60"]
# decode phase: the lm phase's smollm weights, LM_CUT_LAYERS deep in
# float32, prefilled with DECODE_PREFILL seeded tokens into DECODE_MAX_SEQ
# slots, then DECODE_STEPS teacher-forced steps held to the CPU's; the
# bf16 serving steps timed with DECODE_TIMED_MAX_SEQ slots, prefill at
# DECODE_PREFILL_SHAPES and greedy decode (the median of
# DECODE_TIMED_STEPS steps) at DECODE_BATCHES
DECODE_PREFILL, DECODE_STEPS, DECODE_MAX_SEQ = 128, 16, 256
DECODE_TIMED_MAX_SEQ, DECODE_TIMED_STEPS = 2048, 32
DECODE_PREFILL_SHAPES, DECODE_BATCHES = ((1, 128), (8, 1024)), (1, 8)
# gemma3-12b at full width and one pattern period (5 local + 1 global of
# its 48 layers), float32: RING_PREFILL tokens, then RING_STEPS decoded
# past its 1024-token window
RING_ARCH, RING_LAYERS, RING_PREFILL, RING_STEPS = "gemma3-12b", 6, 1000, 40
# moe phase: granite's layer-0 MoE on MOE_CHECK_SHAPE tokens, card vs CPU
MOE_ARCH, MOE_CHECK_SHAPE, MOE_OUT_TOL, MOE_AUX_TOL = (
    "granite-moe-1b-a400m", (1, 128), 1e-4, 1e-5)
# ssm phase: xlstm-125m, zamba2-2.7b and whisper-tiny at full width,
# SSM_PREFILL[arch] seeded tokens prefilled (zamba2: two 256-token
# chunks), then SSM_STEPS teacher-forced steps on card and CPU; xlstm's
# first pattern period and whisper at full depth hold the CPU's prefill
# too, whisper's self-attention k/v within a bf16 ulp or SSM_KV_FLOOR of
# the leaf's largest value (4 + 4 layers deep, not 2)
SSM_XLSTM, SSM_ZAMBA, SSM_WHISPER = "xlstm-125m", "zamba2-2.7b", \
    "whisper-tiny"
SSM_PREFILL = {SSM_XLSTM: 128, SSM_ZAMBA: 512, SSM_WHISPER: 128}
SSM_STEPS, SSM_KV_FLOOR = 16, 1e-4
# train phase: smollm-135m at full width. (a) LM_CUT_LAYERS deep in
# float32, one step at TRAIN_CHECK_SHAPE card vs CPU, both against a
# float64 step (``held_train_step``: the card within LM_F32_SLACK x the
# CPU's distance or TRAIN_TOL of a leaf's scale; new parameters within
# TRAIN_UPDATE_TOL of AdamW's update from the card's moments); (b) the
# launcher at full depth (TRAIN_ARGV: a fault injected at
# TRAIN_FAULT_AT, checkpoints every TRAIN_CKPT_EVERY steps); (c) remat
# "block" vs "none" at full depth at TRAIN_REMAT_SHAPE; (d) DP
# compression over
# TRAIN_DP_PODS pods of the card, TRAIN_DP_STEPS steps at TRAIN_DP_SHAPE
# on the cut, the error-feedback sums within TRAIN_EF_TOL; (e) GPipe over
# TRAIN_PP_STAGES stages of the card, TRAIN_PP_MICRO microbatches at
# TRAIN_PP_SHAPE, full depth in float32, within TRAIN_PP_TOL of the
# unpipelined loss; (f) TRAIN_FAMILIES at full width, one pattern period
# deep, one step at TRAIN_FAMILY_SHAPE held as (a) and one bf16 step
TRAIN_CHECK_SHAPE, TRAIN_TOL, TRAIN_LR = (2, 128), 1e-4, 3e-4
TRAIN_STEPS, TRAIN_FAULT_AT, TRAIN_CKPT_EVERY = 40, 25, 10
TRAIN_ARGV = ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
              "8", "--seq", "256", "--ckpt-every", str(TRAIN_CKPT_EVERY),
              "--inject-fault-at", str(TRAIN_FAULT_AT)]
TRAIN_REMAT_SHAPE = (8, 256)
TRAIN_DP_PODS, TRAIN_DP_STEPS, TRAIN_DP_SHAPE, TRAIN_EF_TOL = 4, 3, (8, 64), \
    1e-5
TRAIN_PP_STAGES, TRAIN_PP_MICRO, TRAIN_PP_SHAPE, TRAIN_PP_TOL = 3, 6, \
    (6, 128), 1e-5
TRAIN_FAMILIES = ("granite-moe-1b-a400m", "xlstm-125m", "zamba2-2.7b",
                  "whisper-tiny")
TRAIN_FAMILY_SHAPE, TRAIN_UPDATE_TOL = (1, 64), 1e-6
# mesh phase: MESH_STEPS launcher steps of MESH_SHAPE on each path; the
# dry-run cells (arch, shape, --mesh, --opt levers), each a subprocess of
# at most MESH_DRYRUN_TIMEOUT s; (c) 2 ranks held to one card (loss
# within MESH_TOL, first moments through a float64 step, as the train
# phase)
MESH_STEPS, MESH_SHAPE, MESH_TOL = 3, (8, 256), 1e-5
MESH_LEVERS = ("seq_shard", "attn_remat")
MESH_DRYRUN = ((LM_ARCH, "train_4k", "single", ()),
               (LM_ARCH, "train_4k", "multi", ()),
               (LM_ARCH, "decode_32k", "single", ()),
               ("xlstm-125m", "prefill_32k", "single", ()),
               ("granite-moe-1b-a400m", "train_4k", "single", ()),
               ("internlm2-20b", "train_4k", "single", MESH_LEVERS),
               ("chameleon-34b", "train_4k", "single", MESH_LEVERS),
               ("zamba2-2.7b", "decode_32k", "single", ()),
               ("zamba2-2.7b", "long_500k", "single", ()),
               ("zamba2-2.7b", "long_500k", "multi", ()))
# a long_500k decode keeps its cache split along the slots and the heads:
# fewer collective GB a token than this (the cache gathered: 3.62)
MESH_LONG_COLLECTIVE_GB = 1.0
# (c) also: gemma3-12b's local layer 0 at full width prefilled with
# MESH_RING_PROMPT tokens (past its 1024 window) into a cache split along
# its slots, and TokenPipeline(shardings=) batches of MESH_SHAPE
MESH_RING_B, MESH_RING_PROMPT = 2, 1536
MESH_DRYRUN_TIMEOUT = 600
FLASH_A = (4, 2048)             # smollm layer 0: batch, sequence
FLASH_B = (1, 4096)             # gemma3-12b local layer: batch, sequence
FLASH_C_TAIL = (2, 512, 2048)   # batch, queries at the tail, keys
FLASH_C_PAD = (2, 2000)         # batch, sequence (pads to 2048)
# Layer 0 of the random full-width smollm gives scores of std ~9, where
# float32 rounding alone moves outputs by more than 2e-6: case (a) in
# float32, and only it, is held to the float64 answer instead (no farther
# than this factor times the plain version). The same q, scaled by 1/8
# (exact in float32) to scores of std ~1, is held to 2e-6 as every other
# case is.
FLASH_F64_HELD = {("a_smollm_layer0", "float32")}
FLASH_F32_SLACK = 2.0
# the ingest barrier probe: one 1024-pixel tile per resident block
BARRIER_N, BARRIER_FRAMES = 1024, 16
# cascade phase: the scorer is fit on CASC_SCENES seeded scenes of
# CASC_FRAMES frames (720x1280 after upsampling); the serve run's backend
# latencies make Eq. 19's rate 0.375-0.75, split at CASC_GATE between the
# color gate and the scorer, so both gates shed; the session is
# checkpointed after step CASC_CKPT_STEP; card scores are held to the
# CPU's at CASC_SCORE_TOL
CASC_SCENES, CASC_FRAMES, CASC_GATE = 3, 48, 0.5
CASC_LATENCY, CASC_CKPT_STEP, CASC_SCORE_TOL = (0.02, 0.05), 5, 1e-5
# fleet phase: FLEET_CAMS cameras (the serve cell's seeded scenes, and
# more of them) split over FLEET_MESHES shards of the one card, held to
# the unsharded card session; the 4-shard session is checkpointed after
# step FLEET_CKPT_STEP; fleet float sums are held to NumPy at
# FLEET_SUM_RTOL (the reference test's rtol); the control plane at the
# reference bench's fleet scale (benchmarks/bench_fleet.py:62-66):
# cameras, CDF window, frames a step, shards, steps held bit for bit
FLEET_CAMS, FLEET_MESHES, FLEET_CKPT_STEP = 16, (4, 2), 5
FLEET_SUM_RTOL = 1e-6
FLEET_CTRL_C, FLEET_CTRL_W, FLEET_CTRL_T, FLEET_CTRL_S = 1024, 512, 8, 8
FLEET_CTRL_STEPS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scenes(seed: int, n_frames: int, cams: int = C):
    """(cams, F, H, W, 3) float32 RGB and (cams, F) labels for a
    red-or-yellow query, one seeded scenario per camera."""
    from repro_torch.data.synthetic import combined_label, generate_scenario
    scs = [generate_scenario(seed + c, num_frames=n_frames, height=H,
                             width=W, vehicle_rate=0.12)
           for c in range(cams)]
    rgb = np.stack([sc.frames_rgb() for sc in scs]).astype(np.float32)
    labels = np.stack([combined_label(sc, ("red", "yellow"), "or")
                       for sc in scs])
    return rgb, labels


def upsampler(small):
    """``frames(t0, t1)``: frames t0..t1 of the (C, F, H, W, 3) card
    tensor ``small``, upsampled x UP by nearest neighbour."""
    def frames(t0: int, t1: int):
        x = small[:, t0:t1].repeat_interleave(UP, dim=2)
        return x.repeat_interleave(UP, dim=3).contiguous()
    return frames


def hist_inputs(dev, frames):
    """The hist phase's (F, N, 3) frames and (F, N) bool foreground mask.

    The mask is the foreground of the legacy host model (per-pixel EMA,
    median gain) over each camera's last 2T frames, computed at 90x160
    and upsampled like the frames: repeating every pixel UP*UP times
    changes neither a per-pixel comparison nor a median, so this is the
    mask of the 720x1280 frames."""
    import torch
    from repro_torch.core.colors import rgb_to_hsv_np
    from repro_torch.data.background import batch_foreground
    F, N = C * T, H * UP * W * UP
    rgb = frames(TRAIN, TRAIN + T).reshape(F, N, 3)
    small, _ = scenes(1000, TRAIN + T)
    masks = np.stack([batch_foreground(rgb_to_hsv_np(small[c, TRAIN - T:]))
                      [T:] for c in range(C)])                # (C, T, H, W)
    fg = torch.as_tensor(masks, device=dev).repeat_interleave(
        UP, dim=2).repeat_interleave(UP, dim=3).reshape(F, N).contiguous()
    return rgb, fg


def hist_weights(fg) -> dict:
    """The hist phase's five weight cases over mask ``fg``: the mask as
    bool and as float 0/1, an all-true mask, uniform (0, 1] weights, and
    dyadic weights k/8, k in 1..8 (both seeded, made on the card). Every
    sum of dyadic weights over a 720x1280 frame is a multiple of 1/8
    below 2**21, exact in float32 in any order: the case that holds each
    lane's own fractional weight to the counters exactly."""
    import torch
    gen = torch.Generator(device=fg.device).manual_seed(18)
    uniform = 1.0 - torch.rand(fg.shape, generator=gen, device=fg.device)
    dyadic = torch.randint(1, 9, fg.shape, generator=gen, device=fg.device,
                           dtype=torch.int32).to(torch.float32) / 8.0
    return {"bool": fg, "float": fg.to(torch.float32),
            "bool_dense": torch.ones_like(fg), "float_dense": uniform,
            "float_dyadic": dyadic}


def cuda_ms(fn, runs: int = 7, warmup: int = 2) -> float:
    """Median over ``runs`` of one call timed by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


EMPTY_PROFILER_SESSIONS = [0]    # sessions ``launch_ms`` had to try again
# torch.cuda._sleep's kernel, launched first in a profiled window whose
# kernels are counted: after several profiler sessions in one process
# the profiler can drop a window's first device launch (PERF.md §7), and
# this marker takes that place; its rows are left out of every count
MARKER = "spin_kernel"


def launch_ms(fn, runs: int = 5, sessions: int = 3,
              counts: dict = None) -> dict:
    """Mean device time of one launch of each kernel that ``fn`` launches,
    from ``torch.profiler`` over ``runs`` calls after one warm-up call: a
    kernel's total over its own launch count, so a launch the profiler
    missed does not lower it. The profiler now and then delivers no device
    event for a whole session; such a session is tried again, up to
    ``sessions`` in all, and ``{}`` means that none delivered any. Given
    ``counts``, it is filled with each kernel's launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        got = {e.key: e.self_device_time_total / 1e3 / e.count
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (e.self_device_time_total or 0) > 0}
        if got:
            if counts is not None:
                counts.update({e.key: e.count / runs
                               for e in prof.key_averages()
                               if e.key in got})
            return got
        EMPTY_PROFILER_SESSIONS[0] += 1
    return {}


class Upsampled:
    """A synthetic scenario whose ``frames_rgb`` are its frames upsampled
    x UP by nearest neighbour (720x1280 from 90x160); labels, objects and
    the rest are the scenario's own."""

    def __init__(self, sc):
        self._sc = sc

    def __getattr__(self, name):
        return getattr(self._sc, name)

    def frames_rgb(self) -> np.ndarray:
        x = self._sc.frames_rgb().astype(np.float32)
        return np.repeat(np.repeat(x, UP, axis=1), UP, axis=2)


class TimedSession:
    """The session as the service sees it, with ``step`` timed on the
    host clock up to ``torch.cuda.synchronize()`` (the copy of the
    window's frames to the card included) and the ingest kernel's launch
    counter read around every fused dispatch."""

    def __init__(self, sess, kernel):
        self._sess, self._kernel = sess, kernel
        self.step_ms, self.launches = [], []

    def __getattr__(self, name):
        return getattr(self._sess, name)

    def __len__(self):
        return len(self._sess)

    def step(self, *a, **k):
        import torch
        torch.cuda.synchronize()
        before = self._kernel.ingest_batch.launches
        t0 = time.perf_counter()
        res = self._sess.step(*a, **k)
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append(self._kernel.ingest_batch.launches - before)
        return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import Query, open_session
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.hsv_features import kernel, ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    kbuild.build()
    ptxas = [ln.strip() for ln in kbuild.BUILD.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(kbuild.BUILD.seconds, 3),
          "libraries": sorted(kbuild.BUILD.libs), "ptxas": ptxas})

    # -- inputs: seeded scenes, upsampled on the card ------------------------
    rgb_small, labels = scenes(1000, TRAIN + STEPS * T)
    frames = upsampler(torch.as_tensor(rgb_small, device=dev))

    q = Query.any_of("red", "yellow", latency_bound=1.0, fps=10.0)
    hr, nc, nb = q.hue_ranges, q.num_colors, q.bs * q.bv
    N = H * UP * W * UP

    # -- kernel vs plain at the serve shape ----------------------------------
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.uniform(0, 1, (nc, nb)).astype(np.float32),
                        device=dev)
    norm = torch.as_tensor(rng.uniform(0.3, 1.0, nc).astype(np.float32),
                           device=dev)
    rgb = frames(TRAIN, TRAIN + T).reshape(C, T, N, 3)
    prev = frames(TRAIN - 1, TRAIN).reshape(C, N, 3)
    bg0 = (prev.amax(dim=-1)
           + torch.as_tensor(rng.normal(0, 3, (C, N)).astype(np.float32),
                             device=dev)).contiguous()
    gain0 = torch.as_tensor(rng.uniform(0.9, 1.1, C).astype(np.float32),
                            device=dev)
    results = {}
    plan = kernel.work_plan(C, N, kernel.resident_blocks(dev))
    usage = [dict(u, entry=e) for e, u in kbuild.ptxas_usage(
        kbuild.BUILD.log).items() if "ingest_kernel" in e]
    # what a plain streaming read of the same RGB takes on this card (a
    # yardstick of the HBM rate within reach; used nowhere in the port)
    rgb_read_ms = cuda_ms(lambda: rgb.sum(), runs=10)
    for label, kw in (("bg_valid", dict(bg_valid=True, width=0)),
                      ("fresh_bbox", dict(bg_valid=False, width=W * UP))):
        args = (rgb, bg0, gain0, M, norm, hr)
        got = kernel.ingest_batch(*args, **kw)
        torch.cuda.synchronize()
        want = ref.ingest_batch_ref(*args, **kw)
        rep = kernel.compare_with_plain(got, want, M, norm)
        again = kernel.ingest_batch(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ingest ({label}): two calls differ")
        del got, want, again
        ms = cuda_ms(lambda: kernel.ingest_batch(*args, **kw), runs=20)
        on_card = launch_ms(lambda: kernel.ingest_batch(*args, **kw))
        mine = [t for k, t in on_card.items() if "ingest_kernel" in k]
        if on_card and len(mine) != 1:
            raise AssertionError(f"ingest ({label}): kernels on the card "
                                 f"{sorted(on_card)}")
        plain_ms = cuda_ms(lambda: ref.ingest_batch_ref(*args, **kw),
                           runs=3, warmup=1)
        nbytes = kernel.bytes_moved(C, T, N, nc, nb, kw["bg_valid"],
                                    kw["width"])
        ops = kernel.OPS_PER_PIXEL * C * T * N
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        # the background lane read and written on every frame instead of
        # once a call: the bytes if L2 did not keep it between frames
        lane_every_frame = nbytes + 2 * (T - 1) * C * N * 4
        dev_ms = mine[0] if mine else None
        results[label] = dict(
            rep, ms=ms, kernel_device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, ops=ops,
            achieved_gb_per_s=nbytes / ms / 1e6,
            device_achieved_gb_per_s=(nbytes / dev_ms / 1e6 if dev_ms
                                      else None),
            bytes_lane_every_frame=lane_every_frame,
            device_gb_per_s_lane_every_frame=(lane_every_frame / dev_ms / 1e6
                                              if dev_ms else None),
            rgb_sum_ms=rgb_read_ms,
            rgb_sum_gb_per_s=C * T * N * 12 / rgb_read_ms / 1e6,
            device_launches_per_call=kernel.DEVICE_LAUNCHES_PER_CALL,
            plan=dict(tile=plan.tile, tiles_per_camera=plan.ntiles,
                      grid=plan.grid,
                      resident_blocks=kernel.resident_blocks(dev)),
            ptxas=usage, empty_profiler_sessions=EMPTY_PROFILER_SESSIONS[0])
        emit({"phase": "kernel", "config": label, "shape": [C, T, N, 3],
              **results[label]})
    emit({"phase": "kernel_barrier", **barrier_cost(dev, kernel, hr, M,
                                                    norm)})
    del rgb, prev, bg0

    # -- the serve path ------------------------------------------------------
    sess = open_session(q, C, frame_shape=(H * UP, W * UP))
    pfs = [sess.ingest(frames(b, b + T)).pf for b in range(0, TRAIN, T)]
    pf = np.concatenate(pfs, axis=1).reshape(C * TRAIN, nc, q.bs, q.bv)
    sess.fit(pf, labels[:, :TRAIN].reshape(-1))
    replay = open_session(q, C, device="cpu", model=sess.model)
    replay.load_state(state_from_numpy(sess.state.as_dict(), "cpu"))
    Wc = sess.state.cdf_buf.shape[1]
    lat_rng = np.random.default_rng(1)
    step_ms, launches, admitted, shed, sent = [], [], 0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.ingest_batch.launches = 0
    for i in range(STEPS):
        batch = frames(TRAIN + i * T, TRAIN + (i + 1) * T)
        lat = float(lat_rng.uniform(0.01, 0.03))    # backend s per frame
        pos = sess.state.cdf_pos.cpu().numpy()
        torch.cuda.synchronize()
        before = kernel.ingest_batch.launches
        sess.report_backend_latency(lat)
        t0 = time.perf_counter()
        res = sess.step(batch, tick=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out = sess.next_frames(K_SEND)
        launches.append(kernel.ingest_batch.launches - before)
        if launches[-1] < 1:
            raise AssertionError(f"step {i}: the CUDA kernel did not launch")
        idx = (pos[:, None] + np.arange(T)[None, :]) % Wc
        util = np.take_along_axis(sess.state.cdf_buf.cpu().numpy(), idx, 1)
        if util.shape != (C, T) or not np.isfinite(util).all():
            raise AssertionError(f"step {i}: bad utilities {util}")
        if not set(np.unique(res.decisions).tolist()) <= {0, 1, 2}:
            raise AssertionError(f"step {i}: bad decision codes")
        replay.report_backend_latency(lat)
        rr = replay.step(utilities=util, tick=True)
        same = (np.array_equal(rr.decisions, res.decisions)
                and np.array_equal(rr.pushed_seq, res.pushed_seq)
                and np.array_equal(rr.target_drop_rate, res.target_drop_rate)
                and all(np.array_equal(a, b)
                        for a, b in zip(rr.evicted, res.evicted))
                and replay.next_frames(K_SEND) == out)
        if not same:
            raise AssertionError(f"step {i}: card and CPU control differ")
        admitted += int((res.decisions == 0).sum())
        shed += int((res.decisions > 0).sum())
        sent += len(out)
    main_launches = kernel.ingest_batch.launches
    peak = torch.cuda.max_memory_allocated(dev)
    dc, dr = sess.state.as_dict(), replay.state.as_dict()
    for leaf in ("threshold", "queue_cap", "q_util", "q_seq", "q_next_seq",
                 "cdf_buf", "cdf_counts", "proc_q"):
        if not np.array_equal(dc[leaf], dr[leaf]):
            raise AssertionError(f"state leaf {leaf}: card != CPU replay")
    emit({"phase": "serve", "cameras": C, "frames_per_step": T,
          "frame_shape": [H * UP, W * UP], "steps": STEPS,
          "step_ms": [round(x, 3) for x in step_ms],
          "step_ms_median": float(np.median(step_ms)),
          "kernel_launches_per_step": launches, "admitted": admitted,
          "shed": shed, "sent": sent, "queued_end": len(sess),
          "threshold_mean": float(dc["threshold"].mean()),
          "peak_device_bytes": int(peak), "cpu_replay_bit_identical": True})

    # -- where a step's time goes: a profiled window, then control alone ----
    from torch.profiler import ProfilerActivity, profile
    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            sess.report_backend_latency(0.02)
            sess.step(batch, tick=True)
            sess.next_frames(K_SEND)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []            # device-side events only: aten rows repeat them
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows)
    ingest_rows = [r for r in rows if "ingest_kernel" in r[1]]
    ours = sum(r[0] for r in ingest_rows)
    if rows and not ours:
        raise AssertionError(f"profile: device events but no ingest kernel "
                             f"({[r[1][:40] for r in rows[:12]]})")
    ingest_launches = sum(r[2] for r in ingest_rows)
    if ingest_launches > reps * kernel.DEVICE_LAUNCHES_PER_CALL:
        raise AssertionError(f"profile: {ingest_launches} ingest launches "
                             f"in {reps} steps")
    control = []
    for _ in range(10):
        t0 = time.perf_counter()
        sess.step(utilities=util, tick=True)
        torch.cuda.synchronize()
        control.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "profile", "steps": reps,
          "wall_ms_per_step_profiled": wall * 1e3 / reps,
          "device_ms_per_step": dev_us / 1e3 / reps,
          "ingest_kernel_device_ms_per_step": ours / 1e3 / reps,
          "ingest_kernel_launches_per_step": ingest_launches / reps,
          "device_busy_share": dev_us / 1e6 / wall if dev_us else None,
          "device_kernels_per_step": sum(r[2] for r in rows) / reps,
          "top": [[k[:70], us / 1e3 / reps, n / reps]
                  for us, k, n in rows[:12]],
          "control_only_step_ms": sorted(control)})

    model = sess.model
    del sess, replay
    fleet = fleet_phase(dev, kernel, q, model)
    casc = cascade_phase(dev, kernel, q, frames, labels,
                         float(np.median(step_ms)))
    hist = hist_phase(dev, frames, hr, nc, nb, N, kernel, ref)
    service_phase(dev, kernel, state_from_numpy)
    params = lm_phase(dev)
    decode_phase(dev, params)
    moe_phase(dev)
    ssm_phase(dev, smi)
    train_phase(dev, smi)
    mesh_phase(dev, smi)
    flash = flash_phase(dev, params)
    del params

    main = results["bg_valid"]
    emit({"kernels": [{
        "name": "ingest_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/hsv_features/csrc/ingest.cu",
        "replaces": "src/repro/kernels/hsv_features/kernel.py:360",
        "launches": main_launches, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "launches_by_path": {"serve": main_launches,
                             "cascade": casc["ingest_launches_on_path"],
                             "fleet": fleet["ingest_launches_on_path"]},
        "library_ms": None}, {
        "name": "hsv_hist", "route": "cuda",
        "source": "src/repro_torch/kernels/hsv_features/csrc/hist.cu",
        "replaces": "src/repro/kernels/hsv_features/kernel.py:146",
        "launches": hist["launches"], "max_abs_err": hist["max_abs_err"],
        "ms": hist["ms"], "plain_ms": hist["plain_ms"],
        "bound_ms": hist["bound_ms"], "bound_by": hist["bound_by"],
        "bound_of": "kernel.hist_bytes_read: the weights, the RGB sectors "
                    "under non-zero weights, the outputs",
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:113",
        "launches": flash["launches"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def barrier_cost(dev, kernel, hr, M, norm) -> dict:
    """What a frame costs the persistent ingest kernel beyond its pixels
    at the main path's grid: one camera of ``BARRIER_N`` pixels for each
    resident block (one 1024-pixel tile a block), timed at T=1 and at
    T=1+16 frames. The difference over 16 is one grid barrier, the gain
    reduction over all the camera's tiles and one near-empty tile a
    block (the finalize pass does not grow with T here): an upper bound
    on the barrier's cost. A timing probe only: its uniform-noise frames
    put many pixels within rounding of the foreground threshold, so the
    gain's summation order flips some of them (held to the plain version
    in the kernel phase and the card tests, not here)."""
    import torch
    blocks = kernel.resident_blocks(dev)
    n = blocks * BARRIER_N
    rng = np.random.default_rng(6)
    bg0 = torch.as_tensor(rng.uniform(0, 255, (1, n)).astype(np.float32),
                          device=dev)
    gain0 = torch.ones(1, device=dev)
    ms, dev_ms = {}, {}
    for t in (1, 1 + BARRIER_FRAMES):
        rgb = torch.as_tensor(rng.uniform(0, 255, (1, t, n, 3))
                              .astype(np.float32), device=dev)
        args = (rgb, bg0, gain0, M, norm, hr)
        ms[t] = cuda_ms(lambda: kernel.ingest_batch(*args), runs=20)
        on_card = launch_ms(lambda: kernel.ingest_batch(*args))
        dev_ms[t] = next((v for k, v in on_card.items()
                          if "ingest_kernel" in k), None)
        del rgb, args
    d1, dn = dev_ms[1], dev_ms[1 + BARRIER_FRAMES]
    return {"cameras": 1, "pixels": n,
            "grid": kernel.work_plan(1, n, blocks).grid,
            "ms_t1": ms[1], "ms_t17": ms[1 + BARRIER_FRAMES],
            "device_ms_t1": d1, "device_ms_t17": dn,
            "us_per_frame": (ms[1 + BARRIER_FRAMES] - ms[1])
            / BARRIER_FRAMES * 1e3,
            "device_us_per_frame": ((dn - d1) / BARRIER_FRAMES * 1e3
                                    if d1 and dn else None)}


def hist_phase(dev, frames, hr, nc, nb, N, kernel, ref) -> dict:
    """The histogram kernel against its plain version at the serve shape
    in the five cases of ``hist_weights``, then ``batch_pf`` (its path:
    one kernel call for all frames) against the plain path."""
    import torch
    from repro_torch.core.colors import COLORS
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.hsv_features.ops import batch_pf
    from repro_torch.kernels.hsv_features.ref import pf_from_counts

    F = C * T
    rgb, fg = hist_inputs(dev, frames)
    usage = {("float" if "ILb1E" in e else "bool"): u
             for e, u in kbuild.ptxas_usage(kbuild.BUILD.log).items()
             if "hist_kernel" in e}
    out = {}
    for label, w in hist_weights(fg).items():
        got = kernel.hsv_hist_batch(rgb, w, hr)
        torch.cuda.synchronize()
        want = ref.hsv_hist_ref(rgb, w, hr)
        rep = kernel.compare_hist_with_plain(got, want, w)
        if label != "float_dense" and rep["count_units_differing"] != 0:
            raise AssertionError(f"hsv_hist ({label}): "
                                 f"{rep['count_units_differing']} count "
                                 "units differ from the plain version")
        if w.dtype == torch.float32:
            again = kernel.hsv_hist_batch(rgb, w, hr)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"hsv_hist ({label}): two calls differ")
            del again
        ms = cuda_ms(lambda: kernel.hsv_hist_batch(rgb, w, hr), runs=20)
        per_call = {}
        on_card = launch_ms(lambda: kernel.hsv_hist_batch(rgb, w, hr),
                            counts=per_call)
        mine = [t for k, t in on_card.items() if "hist_kernel" in k]
        launches = sum(per_call.values()) if on_card else None
        if on_card and (len(on_card) != 1 or len(mine) != 1
                        or launches > kernel.HIST_DEVICE_LAUNCHES_PER_CALL):
            raise AssertionError(f"hsv_hist ({label}): kernels on the card "
                                 f"{per_call}")
        dev_ms = mine[0] if mine else None
        plain_ms = cuda_ms(lambda: ref.hsv_hist_ref(rgb, w, hr), runs=3,
                           warmup=1)
        nnz = int((w != 0).sum())
        read = kernel.hist_bytes_read(w, nc, nb, rgb.data_ptr() % 32)
        dense = kernel.hist_bytes_moved(F, N, nc, nb, w.element_size())
        ops_ms = kernel.HIST_OPS_PER_PIXEL * nnz / F32_OPS_PER_S * 1e3
        dense_ops_ms = kernel.HIST_OPS_PER_PIXEL * F * N / F32_OPS_PER_S * 1e3
        bytes_ms = read / HBM_BYTES_PER_S * 1e3
        dense_ms = dense / HBM_BYTES_PER_S * 1e3
        out[label] = dict(
            rep, ms=ms, device_ms=dev_ms, device_launches_per_call=launches,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            dense_bound_ms=max(dense_ms, dense_ops_ms),
            bytes_read=read, bytes_dense=dense,
            ops=kernel.HIST_OPS_PER_PIXEL * nnz,
            achieved_gb_per_s=read / ms / 1e6,
            dense_equivalent_gb_per_s=dense / ms / 1e6,
            device_gb_per_s=read / dev_ms / 1e6 if dev_ms else None,
            device_dense_equivalent_gb_per_s=(dense / dev_ms / 1e6
                                              if dev_ms else None),
            foreground_share=nnz / (F * N),
            ptxas=usage.get("float" if w.dtype == torch.float32 else "bool"),
            empty_profiler_sessions=EMPTY_PROFILER_SESSIONS[0])
        if label == "bool":
            want_counts, want_totals, want_fgtot = want
        del got, want
    # the staged entry point, driven once with the counter at 0
    colors = [COLORS["red"], COLORS["yellow"]]
    rgb_hw = rgb.reshape(F, H * UP, W * UP, 3)
    fg_hw = fg.reshape(F, H * UP, W * UP)
    kernel.hsv_hist_batch.launches = 0
    pf, hf = batch_pf(rgb_hw, fg_hw, colors)
    torch.cuda.synchronize()
    launches = kernel.hsv_hist_batch.launches
    if launches < 1:
        raise AssertionError("batch_pf did not launch the hsv_hist kernel")
    pf_plain = pf_from_counts(want_counts, want_totals)
    hf_plain = want_totals / torch.clamp_min(want_fgtot, 1.0)[:, None]
    pf_err = float((pf - pf_plain).abs().max())
    hf_err = float((hf - hf_plain).abs().max())
    if not (pf_err <= 1e-6 and hf_err <= 1e-6):
        raise AssertionError(f"batch_pf vs plain: pf {pf_err}, hf {hf_err}")
    if not (torch.isfinite(pf).all() and pf.shape == (F, 2, 8, 8)):
        raise AssertionError("batch_pf: bad PF matrices")
    emit({"phase": "hist", "shape": [F, N, 3],
          "plan": {"blocks_per_frame": kernel.hist_plan(
              F, N, kernel.resident_blocks(dev, "hist")).blocks_per_frame,
              "resident_blocks": kernel.resident_blocks(dev, "hist")}, **{
        f"{label}_{k}": v for label, r in out.items() for k, v in r.items()},
        "batch_pf_launches": launches, "batch_pf_pf_err": pf_err,
        "batch_pf_hf_err": hf_err})
    return dict(out["bool"], launches=launches)


def service_phase(dev, kernel, state_from_numpy) -> None:
    """``ServeService.run`` over a card session with raw 720x1280 frames,
    held to a CPU replay of the same arrivals through ``offer_batch``."""
    import torch
    from repro_torch.core import RED, Query, open_session, overall_qor
    from repro_torch.data.pipeline import (
        camera_array_records,
        scenario_records,
    )
    from repro_torch.data.synthetic import generate_dataset
    from repro_torch.serve import Arrival, MockBackend, ServeService, \
        VirtualClock

    h, w = H * UP, W * UP
    q = Query.single(RED, latency_bound=SVC_BOUND, fps=SVC_FPS)
    # the serve phase's vehicle rate: at the default 0.05 the 3 training
    # clips of 48 frames hold no positive label to fit the query on
    scs = [Upsampled(sc) for sc in generate_dataset(
        range(2000, 2000 + SVC_CAMS + SVC_TRAIN), num_frames=SVC_FRAMES,
        height=H, width=W, vehicle_rate=0.12)]
    train, test = scs[:SVC_TRAIN], scs[SVC_TRAIN:]
    sess = open_session(q, num_cameras=SVC_CAMS, frame_shape=(h, w))
    recs = [r for i, sc in enumerate(train)
            for r in scenario_records(sc, i, list(q.colors), fps=SVC_FPS)]
    model = sess.fit(np.stack([r.pf for r in recs]),
                     np.array([r.label for r in recs]))
    replay = open_session(q, SVC_CAMS, device="cpu", model=model)
    replay.load_state(state_from_numpy(sess.state.as_dict(), "cpu"))
    streams = camera_array_records(test, list(q.colors), model=model,
                                   fps=SVC_FPS)
    fused, scored = [], []
    for c, stream in enumerate(streams):
        rgb = test[c].frames_rgb()
        for t, r in enumerate(stream):
            fused.append(Arrival(t=r.t_gen, cam=r.cam_id, record=r,
                                 frame=rgb[t]))
            scored.append(Arrival(t=r.t_gen, cam=r.cam_id, record=r,
                                  utility=float(r.utility)))
    for a in (fused, scored):
        a.sort(key=lambda x: x.t)
    if not all(np.isfinite(a.utility) for a in scored):
        raise AssertionError("service: non-finite utilities")

    def service(s):
        return ServeService(s, MockBackend(seed=0), clock=VirtualClock(),
                            max_batch=SVC_MAX_BATCH, max_wait=SVC_MAX_WAIT)

    timed = TimedSession(sess, kernel)
    torch.cuda.synchronize()
    kernel.ingest_batch.launches = 0
    t0 = time.perf_counter()
    res = service(timed).run(fused)
    wall = time.perf_counter() - t0
    launches = kernel.ingest_batch.launches
    cnt = res.metrics["counters"]
    n_fused = cnt.get("dispatch.fused", 0)
    if n_fused < 1 or n_fused != len(timed.step_ms):
        raise AssertionError(f"service: {n_fused} fused dispatches, "
                             f"{len(timed.step_ms)} timed steps")
    if cnt.get("dispatch.batched", 0) or cnt.get("dispatch.sequential", 0):
        raise AssertionError("service: a window left the fused path")
    if min(timed.launches) < 1:
        raise AssertionError("service: a fused dispatch launched no kernel")
    cpu = service(replay).run(scored)

    def timeline(r):
        return [(p.record.cam_id, p.record.frame_idx, p.t_sent, p.t_done,
                 p.backend_latency) for p in r.processed]

    if res.kept_mask != cpu.kept_mask or timeline(res) != timeline(cpu):
        raise AssertionError("service: card run and CPU offer_batch replay "
                             "kept different frames")
    if sess.stats.__dict__ != replay.stats.__dict__:
        raise AssertionError(f"service: counters differ {sess.stats} vs "
                             f"{replay.stats}")
    for k in ("shed.admission", "shed.queue", "sender.sent",
              "sender.expired", "backend.done"):
        if cnt.get(k, 0) != cpu.metrics["counters"].get(k, 0):
            raise AssertionError(f"service: counter {k} differs")
    lat = res.e2e_latencies()
    d = res.metrics["derived"]
    emit({"phase": "service", "cameras": SVC_CAMS, "frames": SVC_FRAMES,
          "frame_shape": [h, w], "fps": SVC_FPS,
          "max_batch": SVC_MAX_BATCH, "max_wait_s": SVC_MAX_WAIT,
          "dispatch_fused": int(n_fused),
          "train_positive_labels": int(sum(r.label for r in recs)),
          "window_frames": res.metrics["histograms"][
              "coalescer.batch_frames"],
          "dispatch_ms": [round(x, 3) for x in timed.step_ms],
          "dispatch_ms_median": float(np.median(timed.step_ms)),
          "ingest_launches_per_dispatch": sorted(set(timed.launches)),
          "ingest_launches": launches, "run_wall_s": wall,
          "offered": d["offered"], "processed": d["processed"],
          "shed_rate": d["shed_rate"],
          "qor": overall_qor([r.objects for r in res.offered],
                             res.kept_mask),
          "violations": res.violations,
          "e2e_virtual_p50_s": float(np.percentile(lat, 50)),
          "e2e_virtual_p99_s": float(np.percentile(lat, 99)),
          "cpu_offer_batch_replay_equal": True})


def fleet_phase(dev, kernel, q, model) -> dict:
    """Camera-sharded fleet serving (``repro_torch.core.fleet``) on the
    card. (a) FLEET_CAMS cameras x T frames of 720x1280 a step (the serve
    cell's seeded scenes and more, the serve phase's model): 10 ticked
    ``step(frames)`` calls of an unsharded card session, then of sessions
    on ``fleet_mesh(S, device=card)`` for S in FLEET_MESHES, each held bit
    for bit to the unsharded one (decisions, evictions, rates, every
    gathered lane with ``bg`` and ``gain``, ``next_frames(K_SEND)``), S
    ingest launches a step; (b) their ``last_fleet_stats`` and
    ``fleet_stats()`` against NumPy over the gathered lanes; (c) the
    4-shard session checkpointed after step FLEET_CKPT_STEP, restored
    into a 2-shard and an unsharded card session (stepping the frames)
    and a CPU session (replaying the card's utilities), all equal to the
    live session in the later steps; (d) the control plane at the
    reference bench's fleet scale, sharded and not, timed beside one
    shard's program; (e) with more than one card, (a) on a mesh of
    distinct cards. Returns the phase's line."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Query, open_session
    from repro_torch.core.fleet import fleet_mesh

    Cf, h, w = FLEET_CAMS, H * UP, W * UP
    small, _ = scenes(1000, TRAIN + STEPS * T, cams=Cf)
    fl_frames = upsampler(torch.as_tensor(small[:, TRAIN:], device=dev))
    del small
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def session(device=dev, mesh=None, **kw):
        return open_session(q, Cf, frame_shape=(h, w), device=device,
                            model=model, mesh=mesh, **kw)

    def check_step(label, i, got, want):
        if not (np.array_equal(got.decisions, want.decisions)
                and np.array_equal(got.pushed_seq, want.pushed_seq)
                and np.array_equal(got.target_drop_rate,
                                   want.target_drop_rate)
                and all(np.array_equal(x, y)
                        for x, y in zip(got.evicted, want.evicted))):
            raise AssertionError(f"fleet {label} step {i}: the step differs "
                                 "from the unsharded session's")

    def check_lanes(label, i, sess, want, skip=()):
        got = sess.state.as_dict()
        for k, v in want.items():
            if k not in skip and not np.array_equal(got[k], v):
                raise AssertionError(f"fleet {label} step {i}: lane {k} "
                                     "differs from the unsharded session's")

    def check_aggregates(label, i, sess, res, lanes):
        got = sess.last_fleet_stats
        fin = np.isfinite(lanes["threshold"])
        exact = {"queue_depth": int((lanes["q_seq"] >= 0).sum()),
                 "cdf_fill": int(lanes["cdf_len"].sum()),
                 "offered": int((res.decisions >= 0).sum()),
                 "admitted": int((res.decisions == 0).sum()),
                 "shed": int((res.decisions > 0).sum())}
        means = {"proc_q_mean": lanes["proc_q"].mean(),
                 "fps_obs_mean": lanes["fps_obs"].mean(),
                 "threshold_mean": (lanes["threshold"][fin].mean()
                                    if fin.any() else -np.inf)}
        bad = [k for k, v in exact.items() if got[k] != v]
        bad += [k for k, v in means.items()
                if not np.isclose(got[k], v, rtol=FLEET_SUM_RTOL, atol=0)]
        if bad:
            raise AssertionError(f"fleet {label} step {i}: aggregates {bad} "
                                 f"differ from NumPy ({got}, {exact}, "
                                 f"{means})")

    lat_rng = np.random.default_rng(3)
    lats = [float(lat_rng.uniform(0.01, 0.03)) for _ in range(STEPS)]

    def timed_step(sess, batch, lat):
        sess.report_backend_latency(lat)
        torch.cuda.synchronize()
        before = kernel.ingest_batch.launches
        t0 = time.perf_counter()
        res = sess.step(batch, tick=True)
        torch.cuda.synchronize()
        return (res, (time.perf_counter() - t0) * 1e3,
                kernel.ingest_batch.launches - before)

    # (a) the unsharded card session: the record every mesh is held to
    ref = session()
    Wc = ref.state.cdf_buf.shape[1]
    rec, ref_ms = [], []
    for i in range(STEPS):
        pos = ref.state.cdf_pos.cpu().numpy()
        res, ms, _ = timed_step(ref, fl_frames(i * T, (i + 1) * T), lats[i])
        ref_ms.append(ms)
        lanes = ref.state.as_dict()
        idx = (pos[:, None] + np.arange(T)[None, :]) % Wc
        util = np.take_along_axis(lanes["cdf_buf"], idx, 1)
        if not np.isfinite(util).all():
            raise AssertionError(f"fleet step {i}: bad utilities")
        pops = ref.next_frames(K_SEND)
        rec.append(dict(res=res, util=util, pops=pops,
                        lanes=ref.state.as_dict()))

    def run_mesh(label, mesh, on_step=None):
        """10 steps of a session on ``mesh`` held to the record, with the
        ingest launch counter set to 0 just before and read just after."""
        S = mesh.size
        sess = session(mesh=mesh, fleet_aggregate=True)
        ms, launches = [], []
        kernel.ingest_batch.launches = 0
        for i in range(STEPS):
            res, t, n = timed_step(sess, fl_frames(i * T, (i + 1) * T),
                                   lats[i])
            ms.append(t)
            launches.append(n)
            if n != S:
                raise AssertionError(f"fleet {label} step {i}: {n} ingest "
                                     f"launches, expected {S}")
            check_step(label, i, res, rec[i]["res"])
            lanes = sess.state.as_dict()
            check_aggregates(label, i, sess, res, lanes)
            if sess.next_frames(K_SEND) != rec[i]["pops"]:
                raise AssertionError(f"fleet {label} step {i}: pops differ")
            check_lanes(label, i, sess, rec[i]["lanes"])
            if on_step is not None:
                on_step(i, sess)
        path = kernel.ingest_batch.launches
        lanes = sess.state.as_dict()
        fs = sess.fleet_stats()
        if not (fs["queue_depth"] == int((lanes["q_seq"] >= 0).sum())
                and fs["cdf_fill"] == int(lanes["cdf_len"].sum())
                and np.isclose(fs["proc_q_mean"], lanes["proc_q"].mean(),
                               rtol=FLEET_SUM_RTOL, atol=0)):
            raise AssertionError(f"fleet {label}: fleet_stats() {fs} "
                                 "differs from NumPy")
        return sess, dict(shards=S, devices=[str(d) for d in mesh.devices],
                          step_ms=[round(x, 3) for x in ms],
                          step_ms_median=float(np.median(ms)),
                          ingest_launches_per_step=launches,
                          ingest_launches_on_path=path,
                          last_fleet_stats=sess.last_fleet_stats,
                          fleet_stats=fs)

    # (a) + (b) + (c): the 4-shard session, checkpointed after step 5
    ckpt_dir = Path(tmp.name) / "fleet"

    def checkpoint(i, sess):
        if i == FLEET_CKPT_STEP - 1:
            sess.checkpoint(ckpt_dir, step=i + 1)

    meshes = {}
    live = {}
    for S in FLEET_MESHES:
        sess, meshes[f"s{S}"] = run_mesh(
            f"S={S}", fleet_mesh(S, device=dev),
            checkpoint if S == FLEET_MESHES[0] else None)
        live[S] = sess

    # (c) elastic restore into a 2-shard card, an unsharded card and a CPU
    # session, each then equal to the live session in the later steps
    restored = {"card_s2": session(mesh=fleet_mesh(2, device=dev)),
                "card": session(), "cpu": session(device="cpu")}
    for r in restored.values():
        if r.restore(ckpt_dir)[0] != FLEET_CKPT_STEP:
            raise AssertionError("fleet: restored the wrong step")
    for i in range(FLEET_CKPT_STEP, STEPS):
        pops = {}
        for name, r in restored.items():
            r.report_backend_latency(lats[i])
            got = (r.step(utilities=rec[i]["util"], tick=True)
                   if name == "cpu"
                   else r.step(fl_frames(i * T, (i + 1) * T), tick=True))
            check_step(f"restored {name}", i, got, rec[i]["res"])
            pops[name] = r.next_frames(K_SEND)
            check_lanes(f"restored {name}", i, r, rec[i]["lanes"],
                        skip=("bg", "gain", "bg_valid") if name == "cpu"
                        else ())
        if not pops["card_s2"] == pops["card"] == pops["cpu"]:
            raise AssertionError(f"fleet step {i}: restored pops differ")
    del restored
    peak = torch.cuda.max_memory_allocated(dev)

    # device time a step of each session: a profiled window of `reps`
    # steps on the last batch, opened by the MARKER (per step; S ingest
    # launches a step expected)
    def profiled(sess, S, reps=2):
        batch = fl_frames((STEPS - 1) * T, STEPS * T)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                sess.step(batch, tick=True)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (e.self_device_time_total or 0) > 0
                and MARKER not in e.key]
        ing = [x for x in rows if "ingest_kernel" in x[0]]
        n_ing = sum(x[1] for x in ing)
        if rows and not 0 < n_ing <= reps * S:
            raise AssertionError(f"fleet profile: {n_ing} ingest launches "
                                 f"in {reps} steps of {S} shards")
        dev_us = sum(x[2] for x in rows)
        return {"wall_ms_per_step_profiled": wall / reps,
                "device_ms_per_step": dev_us / 1e3 / reps,
                "device_kernels_per_step": sum(x[1] for x in rows) / reps,
                "ingest_device_ms_per_step": sum(x[2] for x in ing)
                / 1e3 / reps,
                "ingest_launches_per_step": n_ing / reps,
                "device_busy_share": (dev_us / 1e3 / wall if wall else None)}

    profiles = {"unsharded": profiled(ref, 1)}
    for S in FLEET_MESHES:
        profiles[f"s{S}"] = profiled(live[S], S)
    del live, ref

    # (e) a mesh of distinct cards, when the machine has them
    ndev = torch.cuda.device_count()
    if ndev > 1:       # the most cards, of FLEET_MESHES, that there are
        _, meshes["distinct"] = run_mesh(
            "distinct", fleet_mesh(max(S for S in FLEET_MESHES if S <= ndev)))
        distinct = "ran"
    else:
        distinct = "skipped: one card"
    del fl_frames
    torch.cuda.empty_cache()

    # (d) the control plane at the reference bench's fleet scale
    Cc, Sc = FLEET_CTRL_C, FLEET_CTRL_S
    rng = np.random.default_rng(0)
    hist = rng.uniform(0, 1, 2000).astype(np.float32)
    qc = Query.single("red", latency_bound=1.0, fps=10.0)

    def ctrl(C, mesh=None):
        s = open_session(qc, C, train_utilities=hist, queue_size=4,
                         queue_capacity=16, cdf_window=FLEET_CTRL_W,
                         device=dev, mesh=mesh)
        s.report_backend_latency(1.0 / (Cc * 10.0))
        return s

    single, sharded = ctrl(Cc), ctrl(Cc, fleet_mesh(Sc, device=dev))
    shard = ctrl(Cc // Sc)
    for i in range(FLEET_CTRL_STEPS):
        u = rng.uniform(0, 1, (Cc, FLEET_CTRL_T)).astype(np.float32)
        a, b = (single.step(utilities=u, tick=True),
                sharded.step(utilities=u, tick=True))
        check_step("control", i, b, a)
        check_lanes("control", i, sharded, single.state.as_dict())
    u = rng.uniform(0, 1, (Cc, FLEET_CTRL_T)).astype(np.float32)

    def host_ms(fn, runs=10):
        fn()
        ts = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    control = {
        "cameras": Cc, "cdf_window": FLEET_CTRL_W, "frames_per_step": T,
        "shards": Sc, "steps_bit_identical": FLEET_CTRL_STEPS,
        "unsharded_step_ms": host_ms(
            lambda: single.step(utilities=u, tick=True)),
        "sharded_step_ms": host_ms(
            lambda: sharded.step(utilities=u, tick=True)),
        "shard_program_ms": host_ms(
            lambda: shard.step(utilities=u[:Cc // Sc], tick=True))}
    result = {
        "phase": "fleet", "cameras": Cf, "frames_per_step": T,
        "frame_shape": [h, w], "steps": STEPS,
        "frames_bytes_per_step": Cf * T * h * w * 3 * 4,
        "unsharded_step_ms": [round(x, 3) for x in ref_ms],
        "unsharded_step_ms_median": float(np.median(ref_ms)),
        "meshes": meshes, "profiled_step": profiles,
        "peak_device_bytes": int(peak),
        "bit_identical_to_unsharded": True, "aggregates_match_numpy": True,
        "checkpoint_at_step": FLEET_CKPT_STEP,
        "restored_s2_card_cpu_bit_identical": True,
        "distinct_devices": distinct, "control": control,
        "ingest_launches_on_path": sum(
            meshes[f"s{S}"]["ingest_launches_on_path"]
            for S in FLEET_MESHES)}
    emit(result)
    tmp.cleanup()
    return result


def cascade_phase(dev, kernel, q, frames, labels, serve_ms: float) -> dict:
    """The two-stage semantic cascade on the card at the serve shape:
    ``fit_scorer`` on three upsampled training scenes, a scorer
    checkpoint round trip, the card scorer against the same weights on
    the CPU, ten ticked ``step(frames)`` calls of a cascade session held
    to a CPU replay given the card's utilities and stage-2 scores, a
    checkpoint after step 5 restored into a card and a CPU session that
    must continue bit-identically, and the step's times and parts."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cascade import Cascade, FrameRows, MLPScorer, fit_scorer
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import open_session
    from repro_torch.core import session as S
    from repro_torch.data.synthetic import generate_scenario
    from repro_torch.kernels.hsv_features.ops import ingest_pipeline

    h, w = H * UP, W * UP
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("cascade: float32 products must stay float32")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cascade_")
    # 1. fit on the card, then the scorer's checkpoint round trip
    train = [Upsampled(generate_scenario(3000 + s, num_frames=CASC_FRAMES,
                                         height=H, width=W,
                                         vehicle_rate=0.12))
             for s in range(CASC_SCENES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer, metrics = fit_scorer(train, q.colors, op=q.op, device=dev,
                                 checkpoint_dir=Path(tmp.name) / "scorer")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    del train
    back = MLPScorer.from_checkpoint(Path(tmp.name) / "scorer", device=dev)
    if not all(torch.equal(back.params[k], scorer.params[k])
               for k in scorer.params):
        raise AssertionError("cascade: scorer checkpoint round trip differs")
    if not metrics["loss_final"] < metrics["loss_first"]:
        raise AssertionError(f"cascade: the fit did not learn {metrics}")
    scorer = back
    cpu_scorer = MLPScorer(params={k: v.cpu() for k, v in
                                   scorer.params.items()},
                           roi_size=scorer.roi_size)

    # 2. card scorer vs the same weights on the CPU, 64 frames
    batch = frames(TRAIN, TRAIN + T)
    bbox = ingest_pipeline(batch, q.colors, None, with_bbox=True)[4]
    flat, fbox = batch.reshape(C * T, h, w, 3), bbox.reshape(C * T, 4)
    on_card = scorer.score(flat, fbox).cpu()
    on_cpu = cpu_scorer.score(flat.cpu(), fbox.cpu())
    scorer_err = float((on_card - on_cpu).abs().max())
    if not scorer_err <= CASC_SCORE_TOL:
        raise AssertionError(f"cascade: card scorer off the CPU's by "
                             f"{scorer_err}")
    del flat, on_card, on_cpu

    # 3. serve: a card cascade session, a CPU replay, a checkpoint
    def session(device, model=None, scr=scorer):
        return open_session(q, C, frame_shape=(h, w), device=device,
                            model=model,
                            cascade=Cascade(scr, gate_fraction=CASC_GATE))

    sess = session(dev)
    pfs = [sess.ingest(frames(b, b + T)).pf for b in range(0, TRAIN, T)]
    pf = np.concatenate(pfs, axis=1).reshape(C * TRAIN, q.num_colors, q.bs,
                                             q.bv)
    sess.fit(pf, labels[:, :TRAIN].reshape(-1))
    replay = session("cpu", sess.model, cpu_scorer)
    replay.load_state(state_from_numpy(sess.state.as_dict(), "cpu"))
    restored = {}
    Wc = sess.state.cdf_buf.shape[1]
    lat_rng = np.random.default_rng(2)
    step_ms, launches = [], []

    def same(a, b):
        return (np.array_equal(a.decisions, b.decisions)
                and np.array_equal(a.pushed_seq, b.pushed_seq)
                and np.array_equal(a.target_drop_rate, b.target_drop_rate)
                and all(np.array_equal(x, y)
                        for x, y in zip(a.evicted, b.evicted)))

    def lanes(s):
        return [s.state.as_dict()[k] for k in ("threshold", "s2_threshold",
                                               "q_util", "q_seq")]

    kernel.ingest_batch.launches = 0
    for i in range(STEPS):
        batch = frames(TRAIN + i * T, TRAIN + (i + 1) * T)
        lat = float(lat_rng.uniform(*CASC_LATENCY))
        pos = sess.state.cdf_pos.cpu().numpy()
        torch.cuda.synchronize()
        before = kernel.ingest_batch.launches
        t0 = time.perf_counter()
        sess.report_backend_latency(lat)
        res = sess.step(batch, tick=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(kernel.ingest_batch.launches - before)
        if launches[-1] < 1:
            raise AssertionError(f"cascade step {i}: no ingest launch")
        idx = (pos[:, None] + np.arange(T)[None, :]) % Wc
        util = np.take_along_axis(sess.state.cdf_buf.cpu().numpy(), idx, 1)
        s2 = res.s2_scores
        if not (np.isfinite(util).all() and np.isfinite(s2).all()
                and s2.shape == (C, T)):
            raise AssertionError(f"cascade step {i}: bad utilities/scores")
        replay.report_backend_latency(lat)
        rr = replay.step(utilities=util, s2_utilities=s2, tick=True)
        if not (same(rr, res) and all(np.array_equal(a, b) for a, b in
                                      zip(lanes(replay), lanes(sess)))):
            raise AssertionError(f"cascade step {i}: card and CPU replay "
                                 "differ")
        for name, r in restored.items():
            r.report_backend_latency(lat)
            got = (r.step(batch, tick=True) if name == "card" else
                   r.step(utilities=util, s2_utilities=s2, tick=True))
            if not (same(got, res) and all(
                    np.array_equal(a, b) for a, b in zip(lanes(r),
                                                         lanes(sess)))):
                raise AssertionError(f"cascade step {i}: the {name} session "
                                     "restored at step 5 differs")
            if name == "card" and not np.array_equal(got.s2_scores, s2):
                raise AssertionError(f"cascade step {i}: restored card "
                                     "scores differ")
        out = sess.next_frames(K_SEND)
        if replay.next_frames(K_SEND) != out:
            raise AssertionError(f"cascade step {i}: pops differ")
        if restored and (restored["card"].next_frames(K_SEND)
                         != restored["cpu"].next_frames(K_SEND)):
            raise AssertionError(f"cascade step {i}: restored pops differ")
        if i == CASC_CKPT_STEP - 1:
            sess.checkpoint(Path(tmp.name) / "session", step=i + 1)
            for name, device in (("card", dev), ("cpu", "cpu")):
                r = session(device, scr=scorer if device == dev
                            else cpu_scorer)
                r.restore(Path(tmp.name) / "session")
                restored[name] = r
    path_launches = kernel.ingest_batch.launches
    counts = dict(offered=sess.stats.offered,
                  shed_color=sess.stats.dropped_admission,
                  shed_semantic=sess.stats.dropped_cascade,
                  shed_queue=sess.stats.dropped_queue, sent=sess.stats.sent)
    if not (counts["shed_color"] and counts["shed_semantic"]):
        raise AssertionError(f"cascade: a gate shed nothing {counts}")

    # 4. where a step's time goes: its parts, one at a time
    st = sess.state
    M_pos, norm, op = sess._model_constants()
    rgb = batch.reshape(C, T, h * w, 3)

    def ingest():
        return kernel.ingest_batch(rgb, st.bg, st.gain, M_pos, norm,
                                   q.hue_ranges, op=op, width=w)

    ingest_ms = cuda_ms(ingest, runs=10)
    ingest_dev = [v for k, v in launch_ms(ingest).items()
                  if "ingest_kernel" in k]
    out = ingest()
    util_t, bbox = out[3], out[6]
    del out
    ones = torch.ones((C, T), dtype=torch.bool, device=dev)
    _, pass1 = S._cascade_admit(st, util_t, ones, update_cdf=True,
                                tick_cfg=sess._tick_cfg)
    r, t = torch.nonzero(pass1, as_tuple=True)
    scorer_ms = cuda_ms(lambda: scorer.score(FrameRows(batch, r, t),
                                             bbox[r, t]), runs=10)
    s2_t = torch.zeros((C, T), device=dev)
    kw = dict(do_tick=True, min_proc=sess.min_proc, budget=sess._budget,
              gate_fraction=sess._gate_fraction,
              num_total=sess.num_active, tick_cfg=sess._tick_cfg)

    def host_ms(fn, runs=10):
        fn()
        ts = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    admit_ms = host_ms(lambda: torch.nonzero(S._cascade_admit(
        st, util_t, ones, update_cdf=True, tick_cfg=sess._tick_cfg)[1]))
    finish_ms = host_ms(lambda: S._cascade_finish_core(
        st, s2_t, ones, pass1, **kw)[1]["decisions"].cpu())
    # profiled steps (per step below): the ingest kernel must be among
    # their device events; the profiler can drop a launch of a window, so
    # the window holds several steps
    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)                       # the MARKER
        for _ in range(reps):
            sess.step(batch, tick=True)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (e.self_device_time_total or 0) > 0
            and MARKER not in e.key]
    ing = [x for x in rows if "ingest_kernel" in x[0]]
    if rows and not ing:
        raise AssertionError(f"cascade profile: device events but no ingest "
                             f"kernel ({[x[0][:40] for x in rows[:12]]})")
    result = {
        "phase": "cascade", "cameras": C, "frames_per_step": T,
        "frame_shape": [h, w], "steps": STEPS,
        "gate_fraction": CASC_GATE, "roi_size": scorer.roi_size,
        "hidden": int(scorer.params["b1"].shape[0]),
        "fit_seconds": fit_s, "fit": metrics,
        "scorer_card_vs_cpu_max_abs": scorer_err,
        "scorer_tol": CASC_SCORE_TOL, **counts,
        "step_ms": [round(x, 3) for x in step_ms],
        "step_ms_median": float(np.median(step_ms)),
        "serve_step_ms_median": serve_ms,
        "ingest_launches_per_step": launches,
        "ingest_launches_on_path": path_launches,
        "parts_ms": {
            "ingest_bbox_call": ingest_ms,
            "ingest_bbox_device": ingest_dev[0] if ingest_dev else None,
            "admit_and_survivor_index": admit_ms,
            "scorer": scorer_ms,
            "finish_and_tick": finish_ms},
        "survivors": int(r.numel()),
        "profiled_step": {
            "steps": reps,
            "device_ms": sum(x[2] for x in rows) / 1e3 / reps,
            "device_kernels": sum(x[1] for x in rows) / reps,
            "ingest_device_ms": sum(x[2] for x in ing) / 1e3 / reps,
            "ingest_launches": sum(x[1] for x in ing) / reps},
        "cpu_replay_bit_identical": True,
        "checkpoint_at_step": CASC_CKPT_STEP,
        "restored_card_and_cpu_bit_identical": True}
    emit(result)
    tmp.cleanup()
    return result


def lm_phase(dev):
    """smollm-135m at full width on the card: float32 logits against the
    CPU's, bf16 forwards timed, and the launcher's LM backend serving.
    Returns the float32 weights on the card (for the flash phase)."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm_forward, lm_specs, padded_vocab
    from repro_torch.sharding.api import materialize, num_params, tree_map

    cfg = get_config(LM_ARCH)
    specs = lm_specs(cfg)
    t0 = time.perf_counter()
    cpu_params = materialize(specs, torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda t: t.to(dev), cpu_params,
                      is_leaf=torch.is_tensor)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)

    def tokens(B, S, device):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               device=device)

    f32 = scaled(cfg, dtype="float32")
    cut = scaled(f32, num_layers=LM_CUT_LAYERS)
    toks = tokens(*LM_CHECK_SHAPE, "cpu")
    with torch.inference_mode():
        exact = lm_forward(scaled(cfg, dtype="float64"), cpu_params,
                           {"tokens": toks})[0]
        want = lm_forward(f32, cpu_params, {"tokens": toks})[0]
        got = lm_forward(f32, params, {"tokens": toks.to(dev)})[0].cpu()
        cut_want = lm_forward(cut, cpu_params, {"tokens": toks})[0]
        cut_got = lm_forward(cut, params, {"tokens": toks.to(dev)})[0].cpu()
    del cpu_params
    real = slice(0, cfg.vocab_size)
    if not (got.shape == want.shape == (*LM_CHECK_SHAPE, padded_vocab(cfg))
            and torch.isfinite(got[..., real]).all()):
        raise AssertionError(f"lm: bad logits {tuple(got.shape)}")

    def errs(a, b):
        """Max abs difference, and it relative to b's largest logit."""
        d = float((a[..., real].double() - b[..., real].double()).abs().max())
        return d, d / float(b[..., real].abs().max())

    cut_vs_cpu = errs(cut_got, cut_want)
    if not torch.allclose(cut_got[..., real], cut_want[..., real],
                          atol=LM_CUT_TOL, rtol=LM_CUT_TOL):
        raise AssertionError(
            f"lm: card float32 logits after {LM_CUT_LAYERS} layers differ "
            f"from the CPU's by {cut_vs_cpu[0]}, past {LM_CUT_TOL}")
    card_vs_cpu = errs(got, want)
    card_vs_f64, cpu_vs_f64 = errs(got, exact), errs(want, exact)
    if not card_vs_f64[0] <= LM_F32_SLACK * cpu_vs_f64[0] + 1e-6:
        raise AssertionError(
            f"lm: card float32 logits {card_vs_f64[0]} from float64, more "
            f"than {LM_F32_SLACK} x the CPU float32's {cpu_vs_f64[0]}")
    timed = {}
    for B, S in LM_SHAPES:
        toks = tokens(B, S, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: lm_forward(cfg, params,
                                              {"tokens": toks}), runs=5)
            logits = lm_forward(cfg, params, {"tokens": toks})[0]
        peak = torch.cuda.max_memory_allocated(dev)
        if not (logits.dtype == torch.bfloat16
                and torch.isfinite(logits[..., real]).all()):
            raise AssertionError(f"lm: bad bf16 logits at {B}x{S}")
        del logits
        timed[f"{B}x{S}"] = {"ms": ms, "peak_bytes": int(peak),
                             "peak_above_weights_bytes": int(peak - base)}
    # where a backend-shaped forward's time goes: one profiled forward
    toks = tokens(*LM_SHAPES[0], dev)
    profiled = dict(shape=list(LM_SHAPES[0]), **profiled_call(
        lambda: lm_forward(cfg, params, {"tokens": toks})))
    emit({"phase": "lm", "arch": LM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                            cfg.num_kv_heads],
          "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
          "params": num_params(specs), "init_s": init_s,
          "f32_check_shape": list(LM_CHECK_SHAPE),
          "f32_cut_layers": LM_CUT_LAYERS, "f32_cut_tol": LM_CUT_TOL,
          "f32_cut_card_vs_cpu_max_abs_rel": cut_vs_cpu,
          "f32_card_vs_cpu_max_abs_rel": card_vs_cpu,
          "f32_card_vs_cpu_f64_max_abs_rel": card_vs_f64,
          "f32_cpu_vs_cpu_f64_max_abs_rel": cpu_vs_f64,
          "slack": LM_F32_SLACK,
          "max_abs_logit": float(exact[..., real].abs().max()),
          "bf16_forward": timed, "profiled_forward": profiled})

    out = ROOT / "results" / "serve" / "lm_metrics.json"
    t0 = time.perf_counter()
    res = launch.main(LM_SVC_ARGS + ["--metrics-out", str(out)])
    wall = time.perf_counter() - t0
    cnt = res.metrics["counters"]
    if cnt.get("sender.sent", 0) < 1 or cnt.get("backend.done", 0) < 1:
        raise AssertionError(f"lm service: nothing sent ({cnt})")
    if cnt["ingest.offered"] - cnt.get("shed.admission", 0) < 1:
        raise AssertionError("lm service: nothing admitted")
    emit({"phase": "lm_service", "argv": LM_SVC_ARGS, "run_wall_s": wall,
          "counters": {k: v for k, v in cnt.items()
                       if k.split(".")[0] in ("dispatch", "sender",
                                              "backend", "shed", "ingest")},
          "backend_latency_s": res.metrics["histograms"][
              "backend.latency_s"],
          "shed_rate": res.metrics["derived"]["shed_rate"],
          "violations": res.violations})
    return params


def profiled_call(fn, grad: bool = False) -> dict:
    """One call of ``fn`` under ``torch.profiler``, opened by the MARKER:
    its wall time up to a synchronisation, device time, device kernels,
    the device's busy share and the top CPU and device rows. Inference
    mode unless ``grad`` (a training step)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    mode = contextlib.nullcontext() if grad else torch.inference_mode()
    with mode, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)                       # the MARKER
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_rows, cpu_rows = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and MARKER not in e.key):
            dev_rows.append((us, e.key, e.count))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            cpu_rows.append((e.self_cpu_time_total, e.key, e.count))
    dev_us = sum(r[0] for r in dev_rows)
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "device_busy_share": dev_us / 1e6 / wall,
            "device_kernels": sum(r[2] for r in dev_rows),
            "top_cpu_self_ms": [[k[:60], us / 1e3, n] for us, k, n in
                                sorted(cpu_rows, reverse=True)[:10]],
            "top_device_ms": [[k[:60], us / 1e3, n] for us, k, n in
                              sorted(dev_rows, reverse=True)[:6]]}


def _cache_leaves(caches):
    return [t for b in caches["blocks"] for _, t in sorted(b.items())]


def held_decode(cfg, params, cpu_params, toks, n_prefill, max_seq,
                prefill_on_cpu=True, extra=None, fwd_toks=None, floor=0.0,
                kv_floor=1e-5, state_rtol=None) -> dict:
    """Prefill ``toks[:, :n_prefill]`` on the card, copy its caches to the
    CPU, then decode the rest of ``toks`` (teacher-forced) on both. In a
    float32 config a decode step still rounds to bf16 (the cache, the
    attention probabilities, its output and ``wo`` run in bf16, the
    reference's dtype flow), so one float32 last bit can move a rounding
    to the other neighbour on one side: each step's logits are held no
    farther from the CPU's than the CPU's decode is from the full float32
    forward over the same tokens (the whole bf16 path's effect). ``pos``
    lanes must be equal at every step; the cache entries that differ are
    counted. With ``prefill_on_cpu`` the CPU's own prefill is held too:
    first logits at ``LM_CUT_TOL``, ``pos`` exact, k/v and scales within
    one bf16 ulp (no tighter than 1e-5 of the leaf's largest value), and
    the count of differing entries and their largest difference
    reported. ``extra`` adds CPU batch entries to the prefill and the
    forward (whisper's ``audio_embed``); ``fwd_toks`` (which start with
    ``toks``) is what the forward runs over where ``toks`` is not a
    multiple of the SSM chunk; ``floor`` is the least bound a step is held
    to, ``kv_floor`` the least k/v tolerance as a share of the leaf's
    largest value, and with ``state_rtol`` the float32 recurrent state
    leaves of the two prefills are held within it of the leaf's largest
    value."""
    import torch
    from repro_torch.models import lm_decode_step, lm_forward, lm_prefill
    from repro_torch.sharding.api import tree_map
    dev = params["embed"].device
    real = slice(0, cfg.vocab_size)
    P, T = n_prefill, toks.shape[1]
    out = {"prefill": P, "steps": T - P, "max_seq": max_seq}
    extra = extra or {}

    def batch(t, device):
        return {"tokens": t.to(device),
                **{k: v.to(device) for k, v in extra.items()}}

    def to_cpu(tree):
        return tree_map(lambda t: t.cpu(), tree, is_leaf=torch.is_tensor)

    def differing(a, b):
        """(entries that differ, their largest difference) over k/v and
        scales; pos lanes must be equal."""
        n, most = 0, 0.0
        for x, y in zip(_cache_leaves(a), _cache_leaves(b)):
            if x.dtype == torch.int32:
                if not torch.equal(x, y):
                    raise AssertionError("decode: pos lanes differ")
                continue
            d = (x.float() - y.float()).abs()
            n += int((d > 0).sum())
            most = max(most, float(d.max()))
        return n, most

    with torch.inference_mode():
        card, first = lm_prefill(cfg, params, batch(toks[:, :P], dev),
                                 max_seq=max_seq)
        if prefill_on_cpu:
            cpu_own, cpu_first = lm_prefill(
                cfg, cpu_params, batch(toks[:, :P], "cpu"), max_seq=max_seq)
            first = first[:, real].cpu()
            if not torch.allclose(first, cpu_first[:, real], atol=LM_CUT_TOL,
                                  rtol=LM_CUT_TOL):
                raise AssertionError("decode: prefill logits differ")
            copied = to_cpu(card)
            n, most = differing(copied, cpu_own)
            for x, y in zip(_cache_leaves(copied), _cache_leaves(cpu_own)):
                if x.dtype == torch.bfloat16:
                    # one bf16 ulp, no tighter than 1e-5 of the leaf's
                    # largest value (the float32 error of a key near 0)
                    y = y.float()
                    ulp = torch.exp2(torch.floor(torch.log2(
                        y.abs().clamp_min(2.0 ** -126))) - 7)
                    tol = ulp.clamp_min(kv_floor * float(y.abs().max()))
                    if not ((x.float() - y).abs() <= tol).all():
                        raise AssertionError("decode: prefill k/v differ "
                                             "by more than a bf16 ulp")
                elif state_rtol is not None and x.dtype == torch.float32:
                    d = float((x - y).abs().max())
                    if d > state_rtol * float(y.abs().max()):
                        raise AssertionError(f"decode: prefill state leaf "
                                             f"differs by {d}")
            out.update(prefill_first_max_abs=float(
                (first - cpu_first[:, real]).abs().max()),
                prefill_cache_entries_differing=n,
                prefill_cache_max_diff=most)
            del cpu_own, copied
        # the float32 forward on the card (the lm phase holds it to the
        # CPU's), rows P..T-1
        fwd = lm_forward(cfg, params, batch(
            toks if fwd_toks is None else fwd_toks, dev))[0]
        fwd = fwd[0, P:T, real].cpu()
        cpu = to_cpu(card)
        errs, bounds, flips = [], [], []
        for p in range(P, T):
            t = toks[:, p:p + 1]
            same, got = lm_decode_step(cfg, params, card, t.to(dev), p)
            if same is not card:
                raise AssertionError("decode: the card's cache was copied")
            _, want = lm_decode_step(cfg, cpu_params, cpu, t, p)
            got, want = got[:, real].cpu().double(), want[:, real].double()
            n, most = differing(to_cpu(card), cpu)
            err = float((got - want).abs().max())
            bound = float((want[0] - fwd[p - P].double()).abs().max())
            if not err <= max(bound, floor):
                raise AssertionError(
                    f"decode: step at {p}: card vs CPU {err}, caches differ "
                    f"in {n} entries, bound {bound}")
            errs.append(err)
            bounds.append(bound)
            flips.append(n)
    out.update(card_vs_cpu_max_abs=errs, cpu_decode_vs_forward_max_abs=bounds,
               floor=floor,
               cache_entries_differing=flips,
               cache_max_diff=differing(to_cpu(card), cpu)[1],
               max_abs_logit=float(fwd.abs().max()))
    out["caches"] = (card, cpu)
    return out


def timed_decode(cfg, params, B, prefill_len, max_seq, steps,
                 profile_step=False, extra=None) -> dict:
    """``make_prefill_step`` on B seeded prompts (with ``extra``'s batch
    entries, on the card), then ``steps`` greedy ``make_decode_step``
    calls, each timed on the host clock up to a synchronisation: the
    median ms a step, tokens/s, the caches' bytes and the peak device
    memory while decoding."""
    import torch
    from repro_torch.train.step import make_decode_step, make_prefill_step
    dev = params["embed"].device
    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, prefill_len)), device=dev)
    times = []
    with torch.inference_mode():
        caches, logits = prefill(params, {"tokens": toks, **(extra or {})})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(steps):
            t0 = time.perf_counter()
            caches, tok, _ = decode(params, caches, tok, prefill_len + i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        if not ((0 <= tok).all() and (tok < cfg.vocab_size).all()):
            raise AssertionError(f"decode: bad greedy tokens {tok}")
        out = {"batch": B, "prefill": prefill_len, "max_seq": max_seq,
               "steps": steps, "ms_per_token": float(np.median(times)),
               "ms_min": min(times), "ms_max": max(times),
               "tokens_per_s": B / float(np.median(times)) * 1e3,
               "cache_bytes": sum(t.nbytes for t in _cache_leaves(caches)),
               "peak_bytes": int(peak)}
        if profile_step:
            pos = prefill_len + steps
            out["profiled_step"] = profiled_call(
                lambda: decode(params, caches, tok, pos))
    return out


def decode_phase(dev, params) -> None:
    """Token-by-token serving of smollm-135m at full width (the lm
    phase's weights) and of gemma3-12b's sliding-window rings at full
    width, one pattern period deep: card decode held to the CPU's, the
    bf16 serving steps timed."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.configs.base import LOCAL_ATTN
    from repro_torch.models import lm_specs
    from repro_torch.sharding.api import materialize, num_params, tree_map
    from repro_torch.train.step import make_prefill_step

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cpu_params = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                             "cpu")
    f32 = scaled(cfg, dtype="float32")
    cut = scaled(f32, num_layers=LM_CUT_LAYERS)
    T = DECODE_PREFILL + DECODE_STEPS
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, T)))
    # (i) card vs CPU, LM_CUT_LAYERS deep, bf16 and int8 caches
    held = {}
    for label, c in (("bf16_cache", cut),
                     ("int8_cache", scaled(cut, opt_kv_int8=True))):
        res = held_decode(c, params, cpu_params, toks, DECODE_PREFILL,
                          DECODE_MAX_SEQ)
        res.pop("caches")
        held[label] = res
    # (ii) full depth, float32: decode at position T-1 against the full
    # forward over the same T tokens, on the card and on the CPU
    to_fwd = decode_vs_forward(f32, params, cpu_params, toks, DECODE_PREFILL,
                               1e-6)
    del cpu_params
    # (iii) bf16 serving steps
    prefill_ms = {}
    prefill = make_prefill_step(cfg, DECODE_TIMED_MAX_SEQ)
    for B, S in DECODE_PREFILL_SHAPES:
        pt = torch.as_tensor(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B, S)), device=dev)
        with torch.inference_mode():
            prefill_ms[f"{B}x{S}"] = cuda_ms(
                lambda: prefill(params, {"tokens": pt}), runs=5)
    timed = {}
    for label, c in (("bf16_cache", cfg),
                     ("int8_cache", scaled(cfg, opt_kv_int8=True))):
        for B in DECODE_BATCHES:
            timed[f"{label}_B{B}"] = timed_decode(
                c, params, B, DECODE_PREFILL, DECODE_TIMED_MAX_SEQ,
                DECODE_TIMED_STEPS,
                profile_step=(label == "bf16_cache" and B == 1))
    emit({"phase": "decode", "arch": LM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "vocab": cfg.vocab_size, "f32_cut_layers": LM_CUT_LAYERS,
          "tol": LM_CUT_TOL, "held": held,
          "f32_full_depth_decode_vs_forward_max_abs": to_fwd,
          "slack": LM_F32_SLACK, "bf16_prefill_ms": prefill_ms,
          "bf16_decode": timed, "seconds": time.perf_counter() - t_phase})

    # (iv) gemma3-12b's rings at full width, one pattern period deep
    t_ring = time.perf_counter()
    gcfg = get_config(RING_ARCH)
    ring = scaled(gcfg, num_layers=RING_LAYERS, dtype="float32")
    specs = lm_specs(ring)
    gparams = materialize(specs, torch.Generator(device=dev).manual_seed(5),
                          dev)                  # drawn on the card: fast
    gcpu = tree_map(lambda t: t.cpu(), gparams, is_leaf=torch.is_tensor)
    init_s = time.perf_counter() - t_ring
    T = RING_PREFILL + RING_STEPS
    gtoks = torch.as_tensor(np.random.default_rng(9).integers(
        0, ring.vocab_size, (1, T)))
    res = held_decode(ring, gparams, gcpu, gtoks, RING_PREFILL, T,
                      prefill_on_cpu=False)
    card, cpu = res.pop("caches")
    W = ring.sliding_window
    rings = [i for i, kind in enumerate(ring.block_pattern)
             if kind == LOCAL_ATTN]
    for i in rings:
        for c in (card, cpu):
            if sorted(c["blocks"][i]["pos"][0].tolist()) != list(
                    range(T - W, T)):
                raise AssertionError(f"ring {i}: pos is not {T - W}..{T - 1}")
    emit({"phase": "decode_ring", "arch": RING_ARCH, "layers": RING_LAYERS,
          "reduced": {"num_layers": [gcfg.num_layers, RING_LAYERS],
                      "dtype": [gcfg.dtype, "float32"]},
          "d_model": ring.d_model, "heads": [ring.num_heads,
                                             ring.num_kv_heads],
          "head_dim": ring.resolved_head_dim, "window": W,
          "vocab": ring.vocab_size, "params": num_params(specs),
          "init_s": init_s, **res,
          "rings_hold": [T - W, T - 1], "local_blocks": rings,
          "seconds": time.perf_counter() - t_ring})
    del gparams, gcpu, card, cpu
    torch.cuda.empty_cache()


def moe_phase(dev) -> None:
    """granite-moe-1b-a400m at full width: its layer-0 MoE on the card
    against the CPU (routing, outputs, aux), the scatter dispatch against
    the one-hot one, bf16 forwards and greedy decode timed."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.models import lm_forward, lm_specs, padded_vocab
    from repro_torch.models import moe as M
    from repro_torch.models.attention import attend_full
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.lm import embed_tokens
    from repro_torch.sharding.api import materialize, num_params, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    f32 = scaled(cfg, dtype="float32")
    specs = lm_specs(cfg)
    params = materialize(specs, torch.Generator(device=dev).manual_seed(6),
                         dev)
    E, k = cfg.num_experts, cfg.top_k
    B, S = MOE_CHECK_SHAPE
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.inference_mode():
        # (i) layer 0's MoE input, computed on the CPU
        prm = tree_map(lambda t: t[0].cpu(), params["blocks"][0],
                       is_leaf=torch.is_tensor)
        pos = torch.arange(S, dtype=torch.int32)
        x = embed_tokens(f32, {"embed": params["embed"].cpu()}, toks, pos)
        out, _ = attend_full(prm["attn"], f32,
                             rmsnorm(x, prm["norm1"], f32.norm_eps), pos)
        x_cpu = rmsnorm(x + out, prm["norm2"], f32.norm_eps)
        x_card = x_cpu.to(dev)
        moe_cpu = prm["moe"]
        moe_card = tree_map(lambda t: t[0], params["blocks"][0]["moe"],
                            is_leaf=torch.is_tensor)
        C = M.capacity(f32, S)
        ti_c, _, aux_c = M._route(moe_cpu, f32, x_cpu)
        ti_g, _, aux_g = M._route(moe_card, f32, x_card)
        ti_g = ti_g.cpu()
        keep_c = M._positions_in_expert(ti_c, E) < C
        keep_g = M._positions_in_expert(ti_g, E) < C
        agree = (ti_g == ti_c).all(-1) & (keep_g == keep_c).all(-1)
        probs_c = torch.softmax(torch.matmul(
            x_cpu, moe_cpu["router"]).float(), dim=-1)
        probs_g = torch.softmax(torch.matmul(
            x_card, moe_card["router"]).float(), dim=-1).cpu()
        top = torch.sort(probs_c, dim=-1, descending=True).values
        flipped = (ti_g != ti_c).any(-1)
        gaps = (top[..., k - 1] - top[..., k])[flipped].tolist()
        # the card's aux with the CPU's routing: the aux held apart from
        # the routing flips
        frac_tokens = torch.nn.functional.one_hot(ti_c, E).float().sum(
            2).mean((0, 1)) / k
        aux_held = float(E * torch.sum(frac_tokens * probs_g.mean((0, 1))))
        if abs(aux_held - float(aux_c)) > MOE_AUX_TOL:
            raise AssertionError(f"moe: aux {aux_held} vs CPU {float(aux_c)}")
        y_c, _ = M.moe_apply(moe_cpu, f32, x_cpu)
        y_g = M.moe_apply(moe_card, f32, x_card)[0].cpu()
        if not torch.allclose(y_g[agree], y_c[agree], atol=MOE_OUT_TOL,
                              rtol=MOE_OUT_TOL):
            raise AssertionError("moe: outputs of agreeing tokens differ")
        if int(agree.sum()) < S * B // 2:
            raise AssertionError(f"moe: routing agrees on {int(agree.sum())}")
        y_s = M.moe_scatter(moe_card, f32, x_card)[0]
        y_o = M.moe_onehot(moe_card, f32, x_card)[0]
        if not torch.allclose(y_s, y_o, atol=1e-5, rtol=1e-5):
            raise AssertionError("moe: scatter and one-hot differ")
        scatter_ms = cuda_ms(lambda: M.moe_scatter(moe_card, f32, x_card))
        onehot_ms = cuda_ms(lambda: M.moe_onehot(moe_card, f32, x_card))
        layer = {
            "shape": [B, S], "capacity": C,
            "tokens_routed_alike": int(agree.sum()),
            "tokens_flipped": int(flipped.sum()),
            "flipped_kth_gap_cpu": gaps,
            "dropped_slots_cpu": int((~keep_c).sum()),
            "out_max_abs_agreeing": float(
                (y_g[agree] - y_c[agree]).abs().max()),
            "aux_cpu": float(aux_c), "aux_card": float(aux_g),
            "aux_card_cpu_routing_diff": abs(aux_held - float(aux_c)),
            "scatter_vs_onehot_max_abs": float((y_s - y_o).abs().max()),
            "scatter_ms": scatter_ms, "onehot_ms": onehot_ms}
        del prm, moe_cpu, x, out
        # (ii) bf16 forwards
        real = slice(0, cfg.vocab_size)
        forwards = {}
        for Bf, Sf in LM_SHAPES:
            ft = torch.as_tensor(np.random.default_rng(11).integers(
                0, cfg.vocab_size, (Bf, Sf)), device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ms = cuda_ms(lambda: lm_forward(cfg, params, {"tokens": ft}),
                         runs=5)
            logits, _, aux = lm_forward(cfg, params, {"tokens": ft})
            peak = torch.cuda.max_memory_allocated(dev)
            if not (logits.shape == (Bf, Sf, padded_vocab(cfg))
                    and torch.isfinite(logits[..., real]).all()
                    and torch.isfinite(aux)):
                raise AssertionError(f"moe: bad bf16 forward at {Bf}x{Sf}")
            del logits
            forwards[f"{Bf}x{Sf}"] = {
                "ms": ms, "peak_bytes": int(peak),
                "peak_above_weights_bytes": int(peak - base),
                "profiled": profiled_call(
                    lambda: lm_forward(cfg, params, {"tokens": ft}))}
    # (iii) bf16 prefill, then greedy decode
    decode = timed_decode(cfg, params, 1, MOE_CHECK_SHAPE[1],
                          DECODE_TIMED_MAX_SEQ, DECODE_TIMED_STEPS,
                          profile_step=True)
    emit({"phase": "moe", "arch": MOE_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "experts": E, "top_k": k, "d_ff": cfg.d_ff,
          "params": num_params(specs), "tol": MOE_OUT_TOL,
          "aux_tol": MOE_AUX_TOL, "layer0": layer, "bf16_forward": forwards,
          "bf16_decode_B1": decode, "seconds": time.perf_counter() - t_phase})
    del params
    torch.cuda.empty_cache()


def f64_held(fn, cfg, params, cpu_params, batch) -> dict:
    """``fn(cfg, params, batch)`` (a float32 tensor) on the card and on the
    CPU, both against the CPU's float64 run of it, as the lm phase holds
    its logits: the card no farther from float64 than ``LM_F32_SLACK``
    times the CPU's float32 distance (+1e-6). Returns the three max abs
    distances and the float64 result's largest magnitude."""
    import torch
    from repro_torch.configs import scaled
    f32 = scaled(cfg, dtype="float32")
    dev = params["embed"].device
    with torch.inference_mode():
        exact = fn(scaled(cfg, dtype="float64"), cpu_params,
                   batch).double()
        want = fn(f32, cpu_params, batch).double()
        got = fn(f32, params, {k: v.to(dev) for k, v in batch.items()}
                 ).cpu().double()
    if not (got.shape == want.shape and torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name}: bad card output {got.shape}")
    out = {"card_vs_cpu": float((got - want).abs().max()),
           "card_vs_f64": float((got - exact).abs().max()),
           "cpu_vs_f64": float((want - exact).abs().max()),
           "max_abs_f64": float(exact.abs().max())}
    if not out["card_vs_f64"] <= LM_F32_SLACK * out["cpu_vs_f64"] + 1e-6:
        raise AssertionError(f"{cfg.name}: card float32 {out}")
    return out


def bf16_forwards(cfg, params, shapes, extra=None) -> dict:
    """bf16 ``lm_forward`` at each (B, S) of ``shapes``: ms (median of
    CUDA-event calls), peak bytes, finite logits; with ``extra(B)`` the
    batch's other entries (on the card)."""
    import torch
    from repro_torch.models import lm_forward, padded_vocab
    dev = params["embed"].device
    out = {}
    for B, S in shapes:
        b = {"tokens": torch.as_tensor(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (B, S)), device=dev),
             **(extra(B) if extra else {})}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: lm_forward(cfg, params, b),
                         runs=3 if B * S > 4096 else 5, warmup=1)
            logits = lm_forward(cfg, params, b)[0]
        peak = torch.cuda.max_memory_allocated(dev)
        if not (logits.shape == (B, S, padded_vocab(cfg))
                and torch.isfinite(logits[..., :cfg.vocab_size]).all()):
            raise AssertionError(f"{cfg.name}: bad bf16 forward {B}x{S}")
        del logits
        out[f"{B}x{S}"] = {"ms": ms, "peak_bytes": int(peak),
                           "peak_above_weights_bytes": int(peak - base)}
    B, S = shapes[0]
    b = {"tokens": torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S)), device=dev),
         **(extra(B) if extra else {})}
    out["profiled"] = dict(shape=[B, S], **profiled_call(
        lambda: lm_forward(cfg, params, b)))
    return out


def mixer_ms(cfg, params, kinds, B, S) -> dict:
    """Where a bf16 forward's time goes: one block of each kind in
    ``kinds`` (its first repetition's weights) alone at B x S on seeded
    inputs, ms a call (CUDA events)."""
    import torch
    from repro_torch.models.blocks import block_apply_full
    dev = params["embed"].device
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (B, S, cfg.d_model)), dtype=torch.bfloat16, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    out = {}
    with torch.inference_mode():
        for p_idx, kind in enumerate(cfg.block_pattern):
            if kind not in kinds or kind in out:
                continue
            prm = (params["shared"] if kind == "shared" else
                   _rep0(params["blocks"][p_idx]))
            out[kind] = cuda_ms(lambda: block_apply_full(cfg, kind, prm, x,
                                                         pos), runs=3,
                                warmup=1)
    return out


def _rep0(tree):
    import torch
    from repro_torch.sharding.api import tree_map
    return tree_map(lambda t: t[0], tree, is_leaf=torch.is_tensor)


def _cut(params, reps):
    """The first ``reps`` pattern repetitions of stacked LM weights (views;
    every other tree whole)."""
    import torch
    from repro_torch.sharding.api import tree_map
    return {**params, "blocks": tuple(
        tree_map(lambda t: t[:reps], b, is_leaf=torch.is_tensor)
        for b in params["blocks"])}


def ssm_phase(dev, smi) -> None:
    """The recurrent, hybrid and encoder-decoder LMs at full width:
    xlstm-125m, zamba2-2.7b and whisper-tiny, card against CPU in float32,
    then bf16 forwards and greedy decode timed; one line each."""
    import torch
    for check in (ssm_xlstm, ssm_zamba, ssm_whisper):
        t0 = time.perf_counter()
        line = check(dev)
        emit({"phase": "ssm", "card": smi, **line,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()


def _draw(cfg, dev, seed):
    """Seeded full-width weights drawn on the card: (params, count, s)."""
    import torch
    from repro_torch.models import lm_specs
    from repro_torch.sharding.api import materialize, num_params
    t0 = time.perf_counter()
    specs = lm_specs(cfg)
    params = materialize(specs, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    return params, num_params(specs), time.perf_counter() - t0


def _to_cpu(tree):
    import torch
    from repro_torch.sharding.api import tree_map
    return tree_map(lambda t: t.cpu(), tree, is_leaf=torch.is_tensor)


def _tokens(cfg, B, S, seed):
    import torch
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)))


def _logits(cfg, p, b):
    from repro_torch.models import lm_forward
    return lm_forward(cfg, p, b)[0][..., :cfg.vocab_size]


def ssm_xlstm(dev) -> dict:
    """xlstm-125m (9 mLSTM + 3 sLSTM blocks): its first pattern period card
    vs CPU at LM_CUT_TOL, the full depth against float64, the first
    period's prefill and decode held (a step in float32 throughout: held
    to its decode-phase bound or LM_CUT_TOL), decode vs forward at full
    depth; bf16 forwards, each mixer alone at 4 x 2048, greedy decode."""
    import torch
    from repro_torch.configs import get_config, scaled
    cfg = get_config(SSM_XLSTM)
    f32 = scaled(cfg, dtype="float32")
    params, n_params, init_s = _draw(cfg, dev, 13)
    cpu_params = _to_cpu(params)
    P = SSM_PREFILL[SSM_XLSTM]
    toks = _tokens(cfg, 1, P + SSM_STEPS, 14)
    period = len(cfg.block_pattern)
    cut = scaled(f32, num_layers=period)
    with torch.inference_mode():
        cut_got = _logits(cut, params, {"tokens": toks[:, :P].to(dev)}).cpu()
        cut_want = _logits(cut, cpu_params, {"tokens": toks[:, :P]})
    cut_err = float((cut_got - cut_want).abs().max())
    if not torch.allclose(cut_got, cut_want, atol=LM_CUT_TOL,
                          rtol=LM_CUT_TOL):
        raise AssertionError(f"xlstm: first period card vs CPU {cut_err}")
    full = f64_held(_logits, cfg, params, cpu_params,
                    {"tokens": toks[:, :P]})
    held = held_decode(cut, params, cpu_params, toks, P, P + SSM_STEPS,
                       floor=LM_CUT_TOL, state_rtol=LM_CUT_TOL)
    held.pop("caches")
    to_fwd = decode_vs_forward(f32, params, cpu_params, toks, P, LM_CUT_TOL)
    del cpu_params
    timed = bf16_forwards(cfg, params, LM_SHAPES)
    timed["mixers_4x2048_ms"] = mixer_ms(cfg, params, ("mlstm", "slstm"),
                                         *LM_SHAPES[1])
    decode = {f"B{B}": timed_decode(cfg, params, B, P, P + DECODE_TIMED_STEPS,
                                    DECODE_TIMED_STEPS, profile_step=B == 1)
              for B in DECODE_BATCHES}
    return {"arch": SSM_XLSTM, "layers": cfg.num_layers,
            "pattern": list(cfg.block_pattern), "d_model": cfg.d_model,
            "heads": cfg.num_heads, "vocab": cfg.vocab_size,
            "params": n_params, "init_s": init_s,
            "f32_first_period": {"layers": period, "tol": LM_CUT_TOL,
                                 "card_vs_cpu_max_abs": cut_err},
            "f32_full_depth_forward": full, "slack": LM_F32_SLACK,
            "f32_first_period_decode": held,
            "f32_full_depth_decode_vs_forward_max_abs": to_fwd,
            "bf16_forward": timed, "bf16_decode": decode}


def ssm_zamba(dev) -> dict:
    """zamba2-2.7b (45 Mamba2 blocks, one shared attention + MLP block used
    9 times): one pattern period card vs CPU in float32 (the forward over
    whole chunks against float64, prefill 1 x 512 and decode held); bf16
    at full depth: forwards, each mixer alone at 4 x 2048, prefill 1 x
    512, greedy decode."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.train.step import make_prefill_step
    cfg = get_config(SSM_ZAMBA)
    params, n_params, init_s = _draw(cfg, dev, 15)
    period = len(cfg.block_pattern)
    cut = scaled(cfg, num_layers=period, dtype="float32")
    card_cut = _cut(params, 1)
    cpu_cut = _to_cpu(card_cut)
    P, Q = SSM_PREFILL[SSM_ZAMBA], cfg.ssm_chunk
    T = P + SSM_STEPS
    fwd_toks = _tokens(cfg, 1, -(-T // Q) * Q, 16)     # whole chunks
    toks = fwd_toks[:, :T]
    fwd = f64_held(_logits, cut, card_cut, cpu_cut, {"tokens": fwd_toks})
    held = held_decode(cut, card_cut, cpu_cut, toks, P, T,
                       prefill_on_cpu=False, fwd_toks=fwd_toks)
    held.pop("caches")
    del cpu_cut, card_cut
    timed = bf16_forwards(cfg, params, LM_SHAPES)
    timed["mixers_4x2048_ms"] = mixer_ms(cfg, params, ("mamba2", "shared"),
                                         *LM_SHAPES[1])
    pt = _tokens(cfg, 1, P, 17).to(dev)
    prefill = make_prefill_step(cfg, DECODE_TIMED_MAX_SEQ)
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": pt}), runs=5)
    decode = timed_decode(cfg, params, 1, P, DECODE_TIMED_MAX_SEQ,
                          DECODE_TIMED_STEPS, profile_step=True)
    return {"arch": SSM_ZAMBA, "layers": cfg.num_layers,
            "pattern": list(cfg.block_pattern), "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "ssm_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
            "ssm_state": cfg.ssm_state, "d_ff": cfg.d_ff, "chunk": Q,
            "vocab": cfg.vocab_size, "params": n_params, "init_s": init_s,
            "reduced": {"f32_card_vs_cpu_num_layers": [cfg.num_layers,
                                                       period]},
            "f32_forward": dict(fwd, tokens=int(fwd_toks.shape[1])),
            "slack": LM_F32_SLACK, "f32_decode": held,
            "bf16_forward": timed, "bf16_prefill_ms": {f"1x{P}": prefill_ms},
            "bf16_decode_B1": decode}


def ssm_whisper(dev) -> dict:
    """whisper-tiny (4 encoder + 4 decoder layers, 1500 stub audio frames):
    encoder output, cross K/V and logits at full depth, card and CPU
    against float64; prefill and decode held, ``cross_kv`` unchanged by
    the steps; bf16 forward and greedy decode timed."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.models.lm import _cross_kv, encode
    cfg = get_config(SSM_WHISPER)
    f32 = scaled(cfg, dtype="float32")
    params, n_params, init_s = _draw(cfg, dev, 18)
    cpu_params = _to_cpu(params)
    P = SSM_PREFILL[SSM_WHISPER]
    toks = _tokens(cfg, 1, P + SSM_STEPS, 19)

    def audio(B, device="cpu"):
        return torch.as_tensor(np.random.default_rng(20).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32,
            device=device)

    def enc(c, p, b):
        return encode(c, p, b["audio_embed"])

    def cross(c, p, b):
        kv = _cross_kv(c, p["cross"], encode(c, p, b["audio_embed"]))
        return torch.stack([kv["k"], kv["v"]])

    ae = audio(1)
    checks = {name: f64_held(fn, cfg, params, cpu_params,
                             {"tokens": toks[:, :P], "audio_embed": ae})
              for name, fn in (("encoder_out", enc), ("cross_kv", cross),
                               ("logits", _logits))}
    held = held_decode(f32, params, cpu_params, toks, P, P + SSM_STEPS,
                       extra={"audio_embed": ae}, kv_floor=SSM_KV_FLOOR)
    card, cpu = held.pop("caches")
    if not (card["cross_kv"]["k"].dtype == torch.float32
            and torch.equal(card["cross_kv"]["k"].cpu(),
                            cpu["cross_kv"]["k"])):
        raise AssertionError("whisper: cross_kv changed while decoding")
    del cpu_params, card, cpu
    timed = bf16_forwards(cfg, params, LM_SHAPES[:1],
                          extra=lambda B: {"audio_embed": audio(B, dev)})
    decode = timed_decode(cfg, params, 1, LM_SHAPES[0][1],
                          DECODE_TIMED_MAX_SEQ // 4, DECODE_TIMED_STEPS,
                          profile_step=True,
                          extra={"audio_embed": audio(1, dev)})
    return {"arch": SSM_WHISPER,
            "layers": [cfg.encoder_layers, cfg.num_layers],
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "encoder_seq": cfg.encoder_seq, "vocab": cfg.vocab_size,
            "params": n_params, "init_s": init_s,
            "f32_full_depth": checks, "slack": LM_F32_SLACK,
            "f32_decode": held, "bf16_forward": timed,
            "bf16_decode_B1": decode}


def decode_vs_forward(cfg, params, cpu_params, toks, P, floor) -> dict:
    """Prefill ``P`` tokens, decode the rest, and the last step's logits
    against the full forward over ``toks``, on the card and on the CPU;
    the card within ``LM_F32_SLACK`` times the CPU's distance plus
    ``floor``."""
    import torch
    from repro_torch.models import lm_decode_step, lm_forward, lm_prefill
    out = {}
    real = slice(0, cfg.vocab_size)
    with torch.inference_mode():
        for side, p in (("card", params), ("cpu", cpu_params)):
            d = p["embed"].device
            caches, _ = lm_prefill(cfg, p, {"tokens": toks[:, :P].to(d)},
                                   max_seq=toks.shape[1])
            for pos in range(P, toks.shape[1]):
                caches, last = lm_decode_step(cfg, p, caches,
                                              toks[:, pos:pos + 1].to(d), pos)
            full = lm_forward(cfg, p, {"tokens": toks.to(d)})[0][:, -1]
            out[side] = float((last[:, real].double()
                               - full[:, real].double()).abs().max())
    if not out["card"] <= LM_F32_SLACK * out["cpu"] + floor:
        raise AssertionError(f"{cfg.name}: decode vs forward {out}")
    return out


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def train_phase(dev, smi) -> None:
    """The training path on the card, one line a part: (a) one float32
    step card vs CPU, (b) ``launch.train.main`` at full depth with an
    injected fault, (c) remat, (d) DP compression, (e) pipeline
    parallelism, (f) the other families. Every part prints its numbers
    first; the phase then raises if any check failed."""
    import torch
    failures = []
    for part in (train_card_vs_cpu, train_launcher, train_remat, train_dp,
                 train_pp, train_families):
        t0 = time.perf_counter()
        line = part(dev, failures)
        emit({"phase": "train", "card": smi, **line,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"train: {failures}")


def _on(tree, d):
    import torch
    from repro_torch.sharding.api import tree_map
    return tree_map(lambda t: t.to(d), tree, is_leaf=torch.is_tensor)


def _bigram(cfg, B, S, seed, device):
    """A ``BigramStream`` batch as the launcher makes it: tokens and
    labels (B, S) on ``device``."""
    import torch
    from repro_torch.data.pipeline import BigramStream
    toks = BigramStream(cfg.vocab_size, seed=0).sample(
        np.random.default_rng(seed), B, S)
    return {"tokens": torch.as_tensor(toks[:, :-1], device=device),
            "labels": torch.as_tensor(toks[:, 1:], device=device)}


def _dist(x, ref, scale=None) -> float:
    """max |x - ref| / (scale or max |ref|), on the CPU in float64."""
    ref = ref.double()
    d = float((x.cpu().double() - ref).abs().max())
    return d / (scale or max(float(ref.abs().max()), 1e-30))


def adamw_from_moments(opt, p, m, v, step: int = 1):
    """AdamW's new parameter from its new moments, in the optimizer's own
    float32 arithmetic (``repro_torch.train.optimizer.AdamW.update``)."""
    import torch
    sf = torch.tensor(float(step))
    bc1 = 1 - torch.pow(torch.tensor(opt.b1), sf)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2), sf)
    lr = opt.lr(torch.tensor(step, dtype=torch.int32))
    return p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
                     + opt.weight_decay * p)


def held_train_step(cfg, params, cpu_params, batch, failures, name):
    """One ``make_train_step`` (the launcher's AdamW schedule) from the
    same weights and batch in float32 on the card and on the CPU, and in
    float64 on the CPU. Random full-width weights amplify rounding, so the
    two float32 steps are compared through the float64 one, as the lm
    phase compares logits: the card's loss, grad_norm and every m and v
    leaf no farther from float64 than LM_F32_SLACK x the CPU's (or
    TRAIN_TOL of the leaf's scale). AdamW moves every entry by about lr,
    so an entry whose gradient is at the rounding level may move either
    way: the card's new parameters are held instead to AdamW's update
    recomputed on the CPU from the card's own m and v, within
    TRAIN_UPDATE_TOL of the leaf's scale."""
    import torch
    from repro_torch.configs import scaled
    from repro_torch.sharding.api import tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, 10, TRAIN_STEPS))
    dev = next(iter(batch.values())).device
    cpu_batch = _on(batch, "cpu")
    step = make_train_step(cfg, opt)
    p_g, s_g, m_g = step(params, opt.init(params), batch)
    _, s_c, m_c = step(cpu_params, opt.init(cpu_params), cpu_batch)
    p64 = tree_map(lambda t: t.double(), cpu_params, is_leaf=torch.is_tensor)
    _, s_x, m_x = make_train_step(scaled(cfg, dtype="float64"), opt)(
        p64, opt.init(p64), cpu_batch)
    del p64
    worst = {}

    def held(key, card, cpu, exact, scale=None):
        d_card, d_cpu = _dist(card, exact, scale), _dist(cpu, exact, scale)
        ratio = d_card / max(LM_F32_SLACK * d_cpu, TRAIN_TOL)
        if key not in worst or ratio > worst[key][0]:
            worst[key] = (ratio, d_card, d_cpu)

    for k in ("loss", "grad_norm"):
        held(k, m_g[k], m_c[k], m_x[k])
    for k in ("m", "v"):
        for g, c, x in zip(tree_leaves(s_g[k]), tree_leaves(s_c[k]),
                           tree_leaves(s_x[k]), strict=True):
            held(k, g, c, x)
    update = max(_dist(pg, adamw_from_moments(opt, p, mg.cpu(), vg.cpu()))
                 for pg, p, mg, vg in zip(
                     tree_leaves(p_g), tree_leaves(cpu_params),
                     tree_leaves(s_g["m"]), tree_leaves(s_g["v"]),
                     strict=True))
    out = {"loss": float(m_c["loss"]), "grad_norm": float(m_c["grad_norm"]),
           "lr": float(m_c["lr"]), "slack": LM_F32_SLACK, "floor": TRAIN_TOL,
           "vs_f64": {k: {"worst_ratio": r, "card": dc, "cpu": dp}
                      for k, (r, dc, dp) in worst.items()},
           "params_vs_update_from_card_moments": update,
           "update_tol": TRAIN_UPDATE_TOL}
    bad = [k for k, (r, _, _) in worst.items() if not r <= 1.0]
    if not update <= TRAIN_UPDATE_TOL:
        bad.append("params")
    if not (int(s_g["step"]) == 1 and str(p_g["embed"].device) == str(dev)
            and float(m_g["lr"]) == float(m_c["lr"])):
        bad.append("step/lr/device")
    if bad:
        failures.append(f"{name}: card vs CPU {bad} {out}")
    return out


def train_card_vs_cpu(dev, failures) -> dict:
    """(a) smollm-135m at full width, LM_CUT_LAYERS deep, float32: one
    step at TRAIN_CHECK_SHAPE card vs CPU from the same weights and
    ``BigramStream`` batch."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.models import lm_specs
    from repro_torch.sharding.api import materialize
    cfg = scaled(get_config(LM_ARCH), num_layers=LM_CUT_LAYERS,
                 dtype="float32")
    cpu = materialize(lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = _bigram(cfg, *TRAIN_CHECK_SHAPE, 1000, dev)
    held = held_train_step(cfg, _on(cpu, dev), cpu, batch, failures, "a")
    return {"part": "a_card_vs_cpu", "arch": LM_ARCH,
            "layers": LM_CUT_LAYERS, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "shape": list(TRAIN_CHECK_SHAPE),
            "reduced": {"num_layers": [get_config(LM_ARCH).num_layers,
                                       LM_CUT_LAYERS]}, "f32_step": held}


def train_launcher(dev, failures) -> dict:
    """(b) ``launch.train.main(TRAIN_ARGV)`` on the card at full depth
    (bf16 compute, float32 weights): one restart, the last checkpoint at
    the last step, the loss falling; ms a step (median, leaving out the
    first 2 steps and each step after a checkpoint), tokens/s, peak bytes,
    checkpoint save and restore seconds, one profiled step."""
    import tempfile
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt
    B, S = int(TRAIN_ARGV[TRAIN_ARGV.index("--batch") + 1]), \
        int(TRAIN_ARGV[TRAIN_ARGV.index("--seq") + 1])
    seen = []
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        rep = launch.main(TRAIN_ARGV + ["--ckpt-dir", d],
                          metrics_cb=lambda i, m, dt: seen.append(
                              (i, m["loss"], dt)))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        last = ckpt.latest_step(d)
        cfg, params, opt_state, step, _ = launch.build(
            LM_ARCH, False, B, S, TRAIN_STEPS, lr=TRAIN_LR, device=dev)
        t0 = time.perf_counter()
        state, _, _ = ckpt.restore(d, {"params": params,
                                       "opt_state": opt_state}, device=dev)
        restore_s = time.perf_counter() - t0
        del params, opt_state
        t0 = time.perf_counter()
        ckpt.save(d, TRAIN_STEPS + 1, state)
        save_s = time.perf_counter() - t0
    loss = {i: l for i, l, _ in seen}             # a replayed step's last
    kept = [dt for n, (i, _, dt) in enumerate(seen)
            if n >= 2 and i % TRAIN_CKPT_EVERY != 0]
    ms = float(np.median(kept)) * 1e3
    first = float(np.mean([loss[i] for i in range(5)]))
    final = float(np.mean([loss[i] for i in range(TRAIN_STEPS - 5,
                                                  TRAIN_STEPS)]))
    batch = _bigram(cfg, B, S, 1000 + TRAIN_STEPS, dev)
    profiled = profiled_call(lambda: step(state["params"],
                                          state["opt_state"], batch),
                             grad=True)
    out = {"part": "b_launcher", "argv": TRAIN_ARGV, "layers": cfg.num_layers,
           "dtype": cfg.dtype, "restarts": rep.restarts,
           "steps_run": rep.steps_run, "stragglers": rep.stragglers,
           "latest_checkpoint": last, "mean_loss_first5": first,
           "mean_loss_last5": final, "ln_vocab": float(np.log(
               cfg.vocab_size)), "ms_per_step_median": ms,
           "ms_per_step_all": [dt * 1e3 for _, _, dt in seen],
           "tokens_per_s": B * S / (ms / 1e3), "peak_bytes": int(peak),
           "peak_above_start_bytes": int(peak - base),
           "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
           "run_wall_s": wall, "profiled_step": profiled}
    if not (rep.restarts == 1 and last == TRAIN_STEPS and final < first
            and len(loss) == TRAIN_STEPS):
        failures.append(f"b: restarts {rep.restarts}, checkpoint {last}, "
                        f"loss {first} -> {final}, steps {sorted(loss)}")
    return out


def _grads(cfg, params, batch):
    """(loss, gradient leaves) of ``lm_loss``, and the peak bytes the call
    allocated above what was allocated before it."""
    import torch
    from repro_torch.models import lm_loss
    from repro_torch.sharding.api import tree_leaves
    from repro_torch.train.step import value_and_grad
    dev = params["embed"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (loss, _), g = value_and_grad(lambda p: lm_loss(cfg, p, batch), params)
    torch.cuda.synchronize()
    return (loss, tree_leaves(g),
            int(torch.cuda.max_memory_allocated(dev) - base))


def _bit_equal(a, b) -> bool:
    import torch
    return (torch.equal(a[0], b[0])
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1],
                                                      strict=True)))


def train_remat(dev, failures) -> dict:
    """(c) smollm-135m at full depth: ``lm_loss`` and its gradients with
    remat "block" and "none" from the same weights and batch, bit for
    bit, and the peak bytes of each. "none" runs twice: if the card's
    kernels are not bit-stable from run to run (atomic sums), the two
    settings are held under ``torch.use_deterministic_algorithms``."""
    import torch
    from repro_torch.configs import get_config, scaled
    cfg = get_config(LM_ARCH)
    params, _, _ = _draw(cfg, dev, 22)
    batch = _bigram(cfg, *TRAIN_REMAT_SHAPE, 2000, dev)
    block = _grads(scaled(cfg, remat="block"), params, batch)
    none = _grads(scaled(cfg, remat="none"), params, batch)
    again = _grads(scaled(cfg, remat="none"), params, batch)
    out = {"part": "c_remat", "shape": list(TRAIN_REMAT_SHAPE),
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "peak_above_start_bytes": {"block": block[2], "none": none[2]},
           "none_run_to_run_bit_equal": _bit_equal(none, again),
           "block_vs_none_bit_equal": _bit_equal(block, none)}
    if not out["none_run_to_run_bit_equal"]:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            block = _grads(scaled(cfg, remat="block"), params, batch)
            none = _grads(scaled(cfg, remat="none"), params, batch)
        finally:
            torch.use_deterministic_algorithms(False)
        out["deterministic_block_vs_none_bit_equal"] = _bit_equal(block,
                                                                  none)
        ok = out["deterministic_block_vs_none_bit_equal"]
    else:
        ok = out["block_vs_none_bit_equal"]
    if not ok:
        failures.append(f"c: remat changed the loss or gradients {out}")
    return out


def train_dp(dev, failures) -> dict:
    """(d) ``make_dp_compressed_train_step`` over ``fleet_mesh(TRAIN_DP_PODS,
    "pod")`` of the card, int8 and top-k, TRAIN_DP_STEPS steps on the
    LM_CUT_LAYERS cut in float32, held to the same steps on the CPU (loss
    and grad_norm at TRAIN_TOL); the error-feedback invariant: the sum of
    the reduced gradients times the pod count plus the pods' residuals
    equals the sum of the pods' true gradients, within TRAIN_EF_TOL of
    each leaf's scale. ms a step on the card."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.core.fleet import fleet_mesh
    from repro_torch.models import lm_loss, lm_specs
    from repro_torch.sharding.api import materialize, tree_leaves
    from repro_torch.train.compression import make_dp_compressed_train_step
    from repro_torch.train.optimizer import AdamW, constant_lr
    from repro_torch.train.step import value_and_grad
    cfg = scaled(get_config(LM_ARCH), num_layers=LM_CUT_LAYERS,
                 dtype="float32")
    cpu = materialize(lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")

    def loss_fn(p, b):
        return lm_loss(cfg, p, b)

    class Recording(AdamW):
        """AdamW that keeps the (reduced) gradient it is given."""
        def update(self, grads, state, params):
            self.seen = grads
            return super().update(grads, state, params)

    n, rows = TRAIN_DP_PODS, TRAIN_DP_SHAPE[0] // TRAIN_DP_PODS
    out = {"part": "d_dp_compression", "pods": n, "layers": LM_CUT_LAYERS,
           "shape": list(TRAIN_DP_SHAPE), "steps": TRAIN_DP_STEPS}
    for method in ("int8", "topk"):
        runs = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            opt = Recording(lr=constant_lr(1e-3))
            step, init_ef = make_dp_compressed_train_step(
                loss_fn, opt, fleet_mesh(n, "pod", device=d), "pod", method)
            params = _on(cpu, d)
            state, ef = opt.init(params), init_ef(params)
            red_sum = true_sum = None
            losses, norms, times = [], [], []
            for i in range(TRAIN_DP_STEPS):
                batch = _bigram(cfg, *TRAIN_DP_SHAPE, 3000 + i, d)
                true = [tree_leaves(value_and_grad(
                    loss_fn, params, {k: v[j * rows:(j + 1) * rows]
                                      for k, v in batch.items()})[1])
                        for j in range(n)]
                if d.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, ef, m = step(params, state, ef, batch)
                if d.type == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                red = [g * n for g in tree_leaves(opt.seen)]
                tsum = [sum(g[k] for g in true) for k in range(len(red))]
                red_sum = red if red_sum is None else [
                    a + b for a, b in zip(red_sum, red)]
                true_sum = tsum if true_sum is None else [
                    a + b for a, b in zip(true_sum, tsum)]
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            ef_err = max(float((r + e.sum(0) - t).abs().max())
                         / max(float(t.abs().max()), 1e-30)
                         for r, e, t in zip(red_sum, tree_leaves(ef),
                                            true_sum))
            runs[where] = {"losses": losses, "grad_norms": norms,
                           "ms_per_step": times, "ef_invariant_rel": ef_err}
        card, cpu_run = runs["card"], runs["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(card["losses"], cpu_run["losses"]))
        norm_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(card["grad_norms"], cpu_run["grad_norms"]))
        out[method] = {"card": card, "cpu_losses": cpu_run["losses"],
                       "cpu_ef_invariant_rel": cpu_run["ef_invariant_rel"],
                       "loss_rel": loss_rel, "grad_norm_rel": norm_rel}
        if not (loss_rel <= TRAIN_TOL and norm_rel <= TRAIN_TOL
                and card["ef_invariant_rel"] <= TRAIN_EF_TOL
                and cpu_run["ef_invariant_rel"] <= TRAIN_EF_TOL):
            failures.append(f"d {method}: {out[method]}")
    return out


def train_pp(dev, failures) -> dict:
    """(e) ``make_pp_loss`` over ``fleet_mesh(TRAIN_PP_STAGES, "stage")``
    of the card, smollm-135m at full depth and width in float32,
    TRAIN_PP_MICRO microbatches: the loss and every gradient leaf within
    TRAIN_PP_TOL (relative to the leaf's scale) of the unpipelined
    ``lm_loss`` over the same microbatches (the same operations on the
    same rows, so the float32 rounding that 30 random layers amplify is
    the same on both); every stage's blocks get a non-zero gradient. The
    distance to one ``lm_loss`` over the whole batch is printed beside
    it (other row counts, so other summation orders in the products)."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.core.fleet import fleet_mesh
    from repro_torch.models import lm_loss
    from repro_torch.sharding.api import tree_flatten_with_path, tree_leaves
    from repro_torch.train.pipeline_parallel import make_pp_loss
    from repro_torch.train.step import value_and_grad
    cfg = scaled(get_config(LM_ARCH), dtype="float32")
    params, _, _ = _draw(cfg, dev, 23)
    batch = _bigram(cfg, *TRAIN_PP_SHAPE, 4000, dev)
    M, mb = TRAIN_PP_MICRO, TRAIN_PP_SHAPE[0] // TRAIN_PP_MICRO
    pp = make_pp_loss(cfg, fleet_mesh(TRAIN_PP_STAGES, "stage", device=dev),
                      M)

    def per_micro(p):
        return torch.stack([lm_loss(cfg, p, {k: v[i * mb:(i + 1) * mb]
                                             for k, v in batch.items()})[0]
                            for i in range(M)]).mean(), {}

    def timed(fn):
        """(loss, gradient leaves, ms of the second of two calls)."""
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss, _), g = value_and_grad(fn, params)
            torch.cuda.synchronize()
        return loss, tree_leaves(g), (time.perf_counter() - t0) * 1e3

    got = timed(lambda p: (pp(p, batch), {}))
    want = timed(per_micro)
    whole = timed(lambda p: lm_loss(cfg, p, batch))

    def dist(a, b):
        return {"loss_rel": abs(float(a[0]) - float(b[0])) / abs(float(b[0])),
                "grad_rel": max(float((x - y).abs().max())
                                / max(float(y.abs().max()), 1e-30)
                                for x, y in zip(a[1], b[1], strict=True))}

    out = {"part": "e_pipeline", "stages": TRAIN_PP_STAGES,
           "microbatches": M, "shape": list(TRAIN_PP_SHAPE),
           "layers": cfg.num_layers, "loss": float(got[0]),
           "vs_unpipelined_microbatches": dist(got, want),
           "vs_unpipelined_whole_batch": dist(got, whole),
           "ms": {"pipelined": got[2], "unpipelined_microbatches": want[2],
                  "unpipelined_whole_batch": whole[2]}}
    blocks = [g for g, (path, _) in zip(got[1], tree_flatten_with_path(
        params, is_leaf=torch.is_tensor)) if path[0] == "blocks"]
    out["every_stage_nonzero_grad"] = len(blocks) > 0 and all(
        bool((g.reshape(TRAIN_PP_STAGES, -1).abs().sum(1) > 0).all())
        for g in blocks)
    d = out["vs_unpipelined_microbatches"]
    if not (d["loss_rel"] <= TRAIN_PP_TOL and d["grad_rel"] <= TRAIN_PP_TOL
            and out["every_stage_nonzero_grad"]):
        failures.append(f"e: {out}")
    return out


def train_families(dev, failures) -> dict:
    """(f) TRAIN_FAMILIES at full width, one pattern period deep (whisper:
    one decoder and one encoder layer): weights drawn on the card and
    copied to the CPU, one float32 step at TRAIN_FAMILY_SHAPE card vs CPU
    (``held_train_step``; the MoE's ``index_add_`` sums with atomics on
    the card, so granite is held by tolerance, never bit for bit), then
    one step in the config's own dtype on the card: finite loss,
    grad_norm > 0, ms a step."""
    import torch
    from repro_torch.configs import get_config, scaled
    from repro_torch.models import lm_specs
    from repro_torch.sharding.api import materialize, num_params
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step
    out = {"part": "f_families", "shape": list(TRAIN_FAMILY_SHAPE)}
    B, S = TRAIN_FAMILY_SHAPE
    for seed, arch in enumerate(TRAIN_FAMILIES, 30):
        full = get_config(arch)
        cut = {"num_layers": len(full.block_pattern)}
        if full.is_encoder_decoder:
            cut["encoder_layers"] = 1
        cfg = scaled(full, **cut)
        f32 = scaled(cfg, dtype="float32")
        params = materialize(lm_specs(cfg),
                             torch.Generator(device=dev).manual_seed(seed),
                             dev)
        rng = np.random.default_rng(seed)
        batch = _bigram(cfg, B, S, 5000 + seed, dev)
        if cfg.is_encoder_decoder:
            batch["audio_embed"] = torch.as_tensor(rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32,
                device=dev)
        held = held_train_step(f32, params, _to_cpu(params), batch,
                               failures, f"f {arch}")
        opt = AdamW(lr=warmup_cosine(TRAIN_LR, 10, TRAIN_STEPS))
        step = make_train_step(cfg, opt)
        state = opt.init(params)
        _, _, m = step(params, state, batch)
        ms = cuda_ms(lambda: step(params, state, batch), runs=3, warmup=1)
        own = {"dtype": cfg.dtype, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "ms": ms}
        if not (np.isfinite(own["loss"]) and own["grad_norm"] > 0):
            failures.append(f"f {arch} {cfg.dtype} step: {own}")
        out[arch] = {"layers": cfg.num_layers, "pattern": list(
            cfg.block_pattern), "d_model": cfg.d_model,
            "params": num_params(lm_specs(cfg)),
            "reduced": {k: [getattr(full, k), v] for k, v in cut.items()},
            "f32_step": held, "own_dtype_step": own}
        del params, state
        torch.cuda.empty_cache()
    return out


def mesh_phase(dev, smi) -> None:
    """The sharding layer on DTensor, one line a part: (a) the launcher on
    a mesh that clamps to one card, and DTensor's cost on it, (b) the dry
    runs, (c) two ranks on two cards where there are two. Every part
    prints its numbers first; the phase then raises if a check failed."""
    import tempfile
    failures = []
    t0 = time.perf_counter()     # (a) first, with the host to itself
    emit({"phase": "mesh", "card": smi, **mesh_launcher(dev, failures),
          "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as out:
        dry = [(cell, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--mesh", cell[2], "--out", out]
            + [a for o in cell[3] for a in ("--opt", o)],
            env=dict(os.environ, PYTHONPATH=str(SRC)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cell in MESH_DRYRUN]
        for line in mesh_dryruns(dry, out, failures):
            emit({"phase": "mesh", "card": smi, **line})
    t0 = time.perf_counter()
    emit({"phase": "mesh", "card": smi, **mesh_ranks(failures),
          "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"mesh: {failures}")


def _timed_steps(step, params, opt_state, batches):
    """Run ``step`` over ``batches``; (params, opt_state, metrics list, ms
    of each step, synchronised)."""
    import torch
    ms, seen = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        seen.append(m)
    return params, opt_state, seen, ms


def mesh_launcher(dev, failures) -> dict:
    """(a) ``build(data_axis=2, model_axis=2)`` on one card against
    ``build()``, then the same steps on a ``(1, 1)`` DTensor mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm_specs
    from repro_torch.sharding.api import tree_leaves
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step
    B, S = MESH_SHAPE
    args = (LM_ARCH, False, B, S, 100)
    runs = {}
    for name in ("plain", "build_2x2", "dtensor_1x1"):
        if name == "dtensor_1x1":
            cfg, params, _, step, _ = launch.build(*args, device=dev)
            mesh = make_host_mesh(1, 1, device=dev)
            opt = AdamW(lr=warmup_cosine(3e-4, 10, 100))   # build()'s
            params, opt_state, step = launch.shard_training(
                mesh, lm_specs(cfg), params, opt, make_train_step(cfg, opt))
        else:
            kw = {"data_axis": 2, "model_axis": 2} if name != "plain" else {}
            cfg, params, opt_state, step, _ = launch.build(*args, device=dev,
                                                           **kw)
        batches = [_bigram(cfg, B, S, 1000 + i, dev)
                   for i in range(MESH_STEPS + 1)]
        params, opt_state, seen, ms = _timed_steps(step, params, opt_state,
                                                   batches)
        leaves = [x.full_tensor() if hasattr(x, "full_tensor") else x
                  for x in tree_leaves(params)]
        runs[name] = {"leaves": leaves, "loss": [float(m["loss"])
                                                 for m in seen], "ms": ms,
                      "dtensor": hasattr(tree_leaves(params)[0],
                                         "full_tensor")}
        del params, opt_state, step
        torch.cuda.empty_cache()
    group = {"backend": dist.get_backend(),
             "world": dist.get_world_size()} if dist.is_initialized() else None
    mesh_shape = list(make_host_mesh(2, 2, device=dev).shape)
    dist.destroy_process_group()
    ref = runs["plain"]

    def bit_equal(run):
        return run["loss"] == ref["loss"] and all(
            torch.equal(x, y) for x, y in zip(ref["leaves"], run["leaves"],
                                              strict=True))

    def rel(run):
        return max(float((x - y).abs().max() / max(float(x.abs().max()),
                                                   1e-30))
                   for x, y in zip(ref["leaves"], run["leaves"]))
    out = {"part": "a_launcher", "arch": LM_ARCH, "shape": list(MESH_SHAPE),
           "steps": MESH_STEPS, "group": group,
           "build_2x2_mesh": mesh_shape}
    for name, run in runs.items():
        out[name] = {"dtensor": run["dtensor"], "loss": run["loss"],
                     "ms_per_step": run["ms"][1:],
                     "ms_per_step_median": float(np.median(run["ms"][1:])),
                     "first_step_ms": run["ms"][0]}
        if name != "plain":
            out[name].update(bit_equal=bit_equal(run),
                             max_rel_diff=rel(run))
    out["dtensor_over_plain"] = (out["dtensor_1x1"]["ms_per_step_median"]
                                 / out["plain"]["ms_per_step_median"])
    if not (mesh_shape == [1, 1] and out["build_2x2"]["bit_equal"]
            and not out["build_2x2"]["dtensor"]):
        failures.append(f"a: build(2, 2) on {mesh_shape}, bit equal "
                        f"{out['build_2x2']['bit_equal']}")
    if not (out["dtensor_1x1"]["dtensor"]
            and out["dtensor_1x1"]["max_rel_diff"] <= MESH_TOL):
        failures.append(f"a: (1, 1) DTensor steps "
                        f"{out['dtensor_1x1']['max_rel_diff']} from plain")
    return out


def moe_whole_buffers(arch, shape_name) -> set:
    """The shapes of the whole MoE dispatch buffer and token copies of a
    cell ((B*E*C, d), (B, E*C, d), (B, E, C, d), (B*S*k, d), (B, S*k,
    d)): a rank that scatters into its own batch rows allocates none."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.moe import capacity
    cfg, shape = get_config(arch), SHAPES[shape_name]
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    E, k, C = cfg.num_experts, cfg.top_k, capacity(cfg, shape.seq_len)
    return {(B * E * C, d), (B, E * C, d), (B, E, C, d), (B * S * k, d),
            (B, S * k, d)}


def whole_query_heads(arch, entries) -> list:
    """The allocations of ``entries`` that hold all of ``arch``'s query
    heads: scores (b, n_kv, g, Sq, Sk) with n_kv * g of them, or q-like
    (b, S, n_heads, head_dim). A rank that attends its own query heads
    (the KV heads whole where they do not divide "model") holds none."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return [e for e in entries if (len(e["shape"]) == 5 and e["shape"][1:3]
                                   == [nkv, nq // nkv]) or
            (len(e["shape"]) == 4 and e["shape"][2:] == [nq, hd])]


def mesh_dryruns(dry, out, failures) -> list:
    """(b) Wait for each dry-run subprocess and read its record; a MoE
    cell's allocations live at the peak must hold no whole dispatch
    buffer, a cell run with levers must name them, chameleon's lever
    cell must fit 80 GB with no allocation of all its query heads at the
    peak, and a ``long_500k`` decode must move fewer than
    ``MESH_LONG_COLLECTIVE_GB`` a token."""
    from repro_torch.configs import get_config
    lines = []
    for (arch, shape, mesh, opts), t0, proc in dry:
        try:
            log, _ = proc.communicate(timeout=max(
                1.0, MESH_DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        wall = time.perf_counter() - t0
        path = Path(out) / f"{arch}--{shape}--{mesh}.json"
        line = {"part": "b_dryrun", "arch": arch, "shape": shape,
                "mesh_kind": mesh, "opts": list(opts),
                "returncode": proc.returncode, "wall_s": wall}
        if proc.returncode != 0 or not path.exists():
            err = path.with_suffix(".error.json")
            line["error"] = (json.loads(err.read_text())["error"]
                             if err.exists() else log[-2000:])
            failures.append(f"b: {arch} {shape} {mesh}: {line['error']}")
        else:
            rec = json.loads(path.read_text())
            mem, r = rec["memory"], rec["roofline"]
            line.update(
                mesh=rec["mesh"], chips=rec["chips"],
                n_params=rec["n_params"], lower_s=rec["lower_s"],
                trace_s=rec["compile_s"], traced_ops=rec["traced_ops"],
                memory=mem, peak_gb=mem["peak_bytes_est"] / 1e9,
                fits_80gb=mem["fits"], cost=rec["cost"],
                collectives=rec["collectives"],
                collective_gb=rec["collectives"]["total"] / 1e9,
                model_flops_per_device=rec["model_flops_per_device"],
                useful_flops_ratio=rec["useful_flops_ratio"], roofline=r,
                dominant=r["dominant"], record_opts=rec["opts"])
            if rec["opts"] != list(opts):
                failures.append(f"b: {arch} {shape} {mesh}: record names "
                                f"{rec['opts']}, not {list(opts)}")
            if get_config(arch).num_experts:
                whole = moe_whole_buffers(arch, shape)
                held = [e for e in mem["temp_at_peak"]
                        if tuple(e["shape"]) in whole]
                line["moe_whole_buffers_at_peak"] = held
                if held:
                    failures.append(f"b: {arch} {shape} {mesh}: whole MoE "
                                    f"buffers at the peak: {held}")
            if (shape == "long_500k"
                    and line["collective_gb"] >= MESH_LONG_COLLECTIVE_GB):
                failures.append(f"b: {arch} {shape} {mesh}: "
                                f"{line['collective_gb']} GB of collectives "
                                f"a token")
            if arch == "chameleon-34b":
                held = whole_query_heads(arch, mem["temp_at_peak"])
                line["whole_query_heads_at_peak"] = held
                if held or not mem["fits"]:
                    failures.append(f"b: {arch} {shape} {mesh}: fits 80 GB "
                                    f"{mem['fits']}, all query heads at "
                                    f"the peak: {held}")
        lines.append(line)
    return lines


def mesh_ranks(failures) -> dict:
    """(c) Two NCCL ranks on a ``data=2`` mesh of two cards, each held to
    its own one-card step; a skip line on one card."""
    import torch
    if torch.cuda.device_count() < 2:
        return {"part": "c_two_ranks", "ran": "skipped: one card"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(ROOT / "chip_smoke.py"),
         "--mesh-worker"], env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=600)
    got = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not got:
        failures.append(f"c: rc {proc.returncode}: {proc.stderr[-2000:]}")
        return {"part": "c_two_ranks", "ran": "failed",
                "returncode": proc.returncode}
    res = json.loads(got[-1][len("RESULT "):])
    ring, tp = res["ring_prefill"], res["token_pipeline"]
    if not (res["loss_diff"] <= MESH_TOL
            and res["m_vs_f64_worst_ratio"] <= 1.0
            and res["params_vs_own_update"] <= TRAIN_UPDATE_TOL
            and ring["written_mismatches"] == 0 and ring["all_written"]
            and ring["pos_equal"] and ring["kv_rel"] <= 4 * 2.0 ** -7
            and ring["k_placements"] == ["R", "S(2)"]
            and tp["equal"] and tp["labels_plain"]
            and tp["tokens_placements"] == [["S(0)", "R"]]):
        failures.append(f"c: {res}")
    return {"part": "c_two_ranks", "ran": "ran", **res}


def mesh_worker(device=None) -> int:
    """One rank of (c), started by ``torch.distributed.run`` (``torchrun
    --nproc-per-node N chip_smoke.py --mesh-worker``, one rank a card):
    smollm-135m at full width, ``LM_CUT_LAYERS`` deep in float32, one
    step of ``MESH_SHAPE`` on an ``(N, 1)`` mesh held to the one-device
    step (loss within MESH_TOL, first moments held through a float64
    step, new parameters within TRAIN_UPDATE_TOL of AdamW's update from
    the mesh's own moments); rank 0 prints the result. ``--cpu``
    rehearses it over gloo."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, scaled
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm_specs
    from repro_torch.sharding.api import materialize, tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step
    rank = int(os.environ["LOCAL_RANK"])
    if device == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group("gloo")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl")
    cfg = scaled(get_config(LM_ARCH), dtype="float32",
                 num_layers=LM_CUT_LAYERS)
    specs = lm_specs(cfg)
    opt = AdamW(lr=warmup_cosine(3e-4, 10, 100))
    step = make_train_step(cfg, opt)
    params = materialize(specs, torch.Generator().manual_seed(0), dev)
    batch = _bigram(cfg, *MESH_SHAPE, 1000, dev)
    p1, o1, m1 = step(params, opt.init(params), batch)
    mesh = make_host_mesh(dist.get_world_size(), 1, device=dev)
    ps, os_, mstep = launch.shard_training(mesh, specs, params, opt, step)
    p2, o2, m2 = mstep(ps, os_, batch)

    def whole(tree):
        return [x.full_tensor() for x in tree_leaves(tree)]

    def rel(a, b):
        return max(float((x - y).abs().max() / max(float(x.abs().max()),
                                                   1e-30))
                   for x, y in zip(a, b))
    # the split batch sums its gradients in another order: the mesh's
    # first moments are held to a float64 step, within LM_F32_SLACK x the
    # one-device float32 step's distance (or MESH_TOL), as the train phase
    # holds the card to the CPU; new parameters to AdamW's update from
    # the mesh's own moments (a gradient at the rounding level flips an
    # entry's first step by 2 lr)
    p64 = tree_map(lambda t: t.double(), params, is_leaf=torch.is_tensor)
    _, o64, m64 = make_train_step(scaled(cfg, dtype="float64"), opt)(
        p64, opt.init(p64), batch)
    ratios = [_dist(y, x.cpu()) / max(LM_F32_SLACK * _dist(z, x.cpu()),
                                      MESH_TOL)
              for x, y, z in zip(tree_leaves(o64["m"]), whole(o2["m"]),
                                 tree_leaves(o1["m"]))]
    own = [adamw_from_moments(opt, x, m, v) for x, m, v in zip(
        tree_leaves(params), whole(o2["m"]), whole(o2["v"]))]
    res = {"mesh": list(mesh.shape), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "loss": [float(m1["loss"]),
                                                   float(m2["loss"])],
           "loss_f64": float(m64["loss"]),
           "loss_diff": abs(float(m1["loss"]) - float(m2["loss"])),
           "m_rel_diff": rel(tree_leaves(o1["m"]), whole(o2["m"])),
           "m_vs_f64_worst_ratio": max(ratios),
           "params_vs_own_update": rel(own, whole(p2)),
           "max_rel_diff": rel(tree_leaves(p1), whole(p2)),
           "ring_prefill": mesh_ring_prefill(dev),
           "token_pipeline": mesh_token_pipeline(cfg, mesh, dev)}
    if rank == 0:
        print("RESULT " + json.dumps(res), flush=True)
    dist.destroy_process_group()
    return 0


def mesh_ring_prefill(dev) -> dict:
    """(c) gemma3-12b's local layer 0 at full width (float32, window
    1024): k/v of MESH_RING_PROMPT tokens projected over heads split on
    "model" of a ``(1, N)`` mesh, prefilled into a ring placed by
    ``cache_shardings`` (its slots split over "model"), held to the plain
    ring on this rank's card: each rank's slots written where the plain
    ring's are, ``pos`` exact, k/v within the bf16 bound (4 x 2**-7 of
    scale) of a sum in another order."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.configs import get_config, scaled
    from repro_torch.configs.base import LOCAL_ATTN
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_caches
    from repro_torch.models.attention import attend_full, attention_specs, \
        prefill_into_cache
    from repro_torch.models.lm import _rep
    from repro_torch.sharding.api import NamedSharding, P, device_put, \
        distribute, materialize, spec_shardings, use_mesh
    from repro_torch.sharding.caches import cache_shardings
    cfg = scaled(get_config("gemma3-12b"), dtype="float32", num_layers=1,
                 block_pattern=(LOCAL_ATTN,))
    win, B, S = cfg.sliding_window, MESH_RING_B, MESH_RING_PROMPT
    mesh = make_host_mesh(1, dist.get_world_size(), device=dev)
    specs = attention_specs(cfg)
    params = materialize(specs, torch.Generator().manual_seed(7), dev)
    h = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(8)).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    plain = init_caches(cfg, B, 2 * S, device=dev)
    _, (k1, v1) = attend_full(params, cfg, h, pos, causal=True, window=win)
    prefill_into_cache(_rep(plain["blocks"][0], 0), k1, v1, pos, window=win)
    with use_mesh(mesh):
        placed = device_put(init_caches(cfg, B, 2 * S, device=dev),
                            cache_shardings(plain, mesh, B))
        _, (k2, v2) = attend_full(
            device_put(params, spec_shardings(specs, mesh)), cfg,
            distribute(h, NamedSharding(mesh, P())), pos, causal=True,
            window=win)
        prefill_into_cache(_rep(placed["blocks"][0], 0), k2, v2, pos,
                           window=win)
    bad, rel = 0, 0.0
    for name in ("k", "v"):
        dt = placed["blocks"][0][name]
        shape, offset = compute_local_shape_and_global_offset(
            dt.shape, dt.device_mesh, dt.placements)
        want = plain["blocks"][0][name][tuple(
            slice(o, o + n) for o, n in zip(offset, shape))].float()
        got = dt.to_local().float()
        bad += int(not torch.equal(got.abs().sum(dim=(0, 1, 3, 4)) > 0,
                                   want.abs().sum(dim=(0, 1, 3, 4)) > 0))
        rel = max(rel, float((got - want).abs().max()
                             / max(float(want.abs().max()), 1e-30)))
    t = torch.tensor([bad, rel], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    got_pos = placed["blocks"][0]["pos"].full_tensor()
    k_whole = placed["blocks"][0]["k"].full_tensor()[0]
    return {"mesh": list(mesh.shape), "window": win, "prompt": S,
            "k_placements": [str(p) for p in
                             placed["blocks"][0]["k"].placements],
            "written_mismatches": int(t[0]), "kv_rel": float(t[1]),
            "all_written": bool((k_whole.abs().sum(dim=(0, 2, 3)) > 0).all()),
            "pos_equal": bool(torch.equal(got_pos,
                                          plain["blocks"][0]["pos"]))}


def mesh_token_pipeline(cfg, mesh, dev) -> dict:
    """(c) ``TokenPipeline(shardings={"tokens": ("data", None)})`` on the
    ``(N, 1)`` mesh against the unsharded pipeline of the same seed: 3
    batches of MESH_SHAPE, tokens split along the batch, labels plain."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.sharding.api import NamedSharding, P
    B, S = MESH_SHAPE
    plain = TokenPipeline(cfg.vocab_size, B, S, seed=11, device=dev)
    placed = TokenPipeline(cfg.vocab_size, B, S, seed=11, device=dev,
                           shardings={"tokens": NamedSharding(
                               mesh, P("data", None))})
    try:
        pairs = [(next(plain), next(placed)) for _ in range(3)]
    finally:
        plain.close()
        placed.close()
    return {"batches": len(pairs),
            "equal": all(torch.equal(a["tokens"], b["tokens"].full_tensor())
                         and torch.equal(a["labels"], b["labels"])
                         for a, b in pairs),
            "tokens_placements": [list(p) for p in sorted({tuple(
                str(x) for x in b["tokens"].placements) for _, b in pairs})],
            "labels_plain": all(type(b["labels"]) is torch.Tensor
                                for _, b in pairs)}


def flash_phase(dev, params) -> dict:
    """The CUDA flash attention kernel through its entry points against
    ``attention_ref`` on the card, with kernel, plain and SDPA times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config, scaled
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention_bsnh
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import _project_kv, _project_q
    from repro_torch.models.common import apply_rope, rmsnorm
    from repro_torch.models.lm import embed_tokens

    mma_usage = fk.mma_kernel_usage(kbuild.BUILD.log)
    f32_usage = fk.f32_kernel_usage(kbuild.BUILD.log)
    cfg = get_config(LM_ARCH)
    B, S = FLASH_A
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)), device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    layer0 = {k: v[0] for k, v in params["blocks"][0]["attn"].items()}
    norm1 = params["blocks"][0]["norm1"][0]
    cases = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cfg_d = scaled(cfg, dtype=str(dtype).replace("torch.", ""))
            x = embed_tokens(cfg_d, params, toks, pos)
            h = rmsnorm(x, norm1, cfg.norm_eps)
            q = apply_rope(_project_q(layer0, h), pos, cfg.rope_theta)
            k, v = _project_kv(layer0, h)
            k = apply_rope(k, pos, cfg.rope_theta)
            cases[("a_smollm_layer0", dtype)] = dict(
                bsnh=(q, k, v), causal=True, window=None)
            if dtype == torch.float32:
                cases[("a_smollm_layer0_q_over_8", dtype)] = dict(
                    bsnh=(q * 0.125, k, v), causal=True, window=None)
        g = get_config("gemma3-12b")
        rng = np.random.default_rng(5)

        def rand(shape, dtype):
            return torch.as_tensor(rng.standard_normal(shape).astype(
                np.float32), device=dev).to(dtype)

        for dtype in (torch.float32, torch.bfloat16):
            hd, (gb, gs) = g.resolved_head_dim, FLASH_B
            cases[("b_gemma3_local", dtype)] = dict(
                bhsd=(rand((gb, g.num_heads, gs, hd), dtype),
                      rand((gb, g.num_kv_heads, gs, hd), dtype),
                      rand((gb, g.num_kv_heads, gs, hd), dtype)),
                causal=True, window=g.sliding_window)
            tb, tq, tk = FLASH_C_TAIL
            cases[("c_tail", dtype)] = dict(
                bhsd=(rand((tb, 9, tq, 64), dtype),
                      rand((tb, 3, tk, 64), dtype),
                      rand((tb, 3, tk, 64), dtype)),
                causal=True, window=None)
            pb, ps = FLASH_C_PAD
            cases[("c_padded", dtype)] = dict(
                bsnh=(rand((pb, ps, 9, 64), dtype),
                      rand((pb, ps, 3, 64), dtype),
                      rand((pb, ps, 3, 64), dtype)),
                causal=True, window=None)

        def entry(c):
            kw = dict(causal=c["causal"], window=c["window"])
            if "bsnh" in c:
                return lambda: flash_attention_bsnh(*c["bsnh"], **kw)
            q, k, v = c["bhsd"]
            bq = min(fk.DEFAULT_BLOCK_Q, q.shape[2])
            bk = min(fk.DEFAULT_BLOCK_K, k.shape[2])
            return lambda: fk.flash_attention(q, k, v, block_q=bq,
                                              block_k=bk, **kw)

        def bhsd(c):
            if "bhsd" in c:
                return c["bhsd"]
            return tuple(t.transpose(1, 2) for t in c["bsnh"])

        # the entry points' run: every case once, counter from 0
        torch.cuda.synchronize()
        fk.flash_attention.launches = 0
        outs = {key: entry(c)() for key, c in cases.items()}
        torch.cuda.synchronize()
        launches = fk.flash_attention.launches
        if launches != len(cases):
            raise AssertionError(f"flash: {launches} launches for "
                                 f"{len(cases)} entry-point calls")

        report = {}
        for key, c in cases.items():
            name, dtype = key
            q, k, v = bhsd(c)
            out = outs.pop(key)
            if "bsnh" in c:
                out = out.transpose(1, 2)
            kw = dict(causal=c["causal"], window=c["window"])
            want = attention_ref(q, k, v, **kw)
            exact = attention_ref(q.double(), k.double(), v.double(), **kw)
            tol = fk.TOL[dtype]
            err = float((out.float() - want.float()).abs().max())
            err64 = float((out.double() - exact).abs().max())
            plain64 = float((want.double() - exact).abs().max())
            dname = str(dtype).replace("torch.", "")
            if (name, dname) in FLASH_F64_HELD:
                held = "float64"
                ok = err64 <= FLASH_F32_SLACK * plain64
            else:
                held = "attention_ref"
                ok = torch.allclose(out.float(), want.float(), atol=tol,
                                    rtol=tol)
            if not (out.shape == want.shape and out.dtype == dtype
                    and torch.isfinite(out).all() and ok):
                raise AssertionError(
                    f"flash {name} {dtype}: max abs error {err} past {tol} "
                    f"(float64: kernel {err64}, plain {plain64})")
            del want, exact
            Bq, Hq, Sq, d = q.shape
            Hkv, Sk = k.shape[1], k.shape[2]
            run = entry(c)
            ms = cuda_ms(run)
            plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw),
                                 runs=3, warmup=1)
            if c["window"] is None and Sq == Sk:
                mask, causal = None, True
            else:
                qp = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
                kp = torch.arange(Sk, device=dev)[None, :]
                mask = kp <= qp
                if c["window"] is not None:
                    mask &= (qp - kp) < c["window"]
                causal = False
            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=causal,
                    enable_gqa=True)
            sdpa_ms = cuda_ms(sdpa)
            # a profiler session with no device event at all says nothing
            # of which kernel ran: its times are then not measured (None)
            on_card = launch_ms(run)
            mine = [t for key, t in on_card.items()
                    if "flash_mma_bf16" in key or "flash_kernel" in key]
            if on_card and len(mine) != 1:
                raise AssertionError(f"flash {name} {dtype}: kernels on the "
                                     f"card {sorted(on_card)}")
            lib_on_card = launch_ms(sdpa)
            ops = fk.attention_ops(Bq, Hq, Sq, Sk, d, **kw)
            nbytes = fk.attention_bytes(Bq, Hq, Hkv, Sq, Sk, d,
                                        q.element_size())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            peak = F32_OPS_PER_S if dtype == torch.float32 \
                else BF16_OPS_PER_S
            ops_ms = ops / peak * 1e3
            if dtype == torch.bfloat16:
                path = dict(path="mma_bf16", ptxas=mma_usage.get(d))
            else:
                plan = fk.flash_plan(Bq, Hq, Sq, Sk, d, c["causal"],
                                     c["window"], fk.resident_blocks(dev, d))
                path = dict(path="cuda_core_fp32", ptxas=f32_usage.get(d),
                            n_split=plan.n_split, grid=plan.grid,
                            resident_blocks=fk.resident_blocks(dev, d))
            rep = dict(
                shape={"B": Bq, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Sk": Sk,
                       "d": d, "window": c["window"]},
                dtype=dname, **path, max_abs_err=err,
                tol=tol, held_to=held, kernel_vs_f64=err64,
                plain_vs_f64=plain64, ms=ms,
                kernel_device_ms=mine[0] if mine else None,
                plain_ms=plain_ms, library_ms=sdpa_ms,
                library_device_ms=(sum(lib_on_card.values())
                                   if lib_on_card else None),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                f32_cuda_core_bound_ms=ops / F32_OPS_PER_S * 1e3,
                f32_bound_share=(ops / F32_OPS_PER_S * 1e3 / mine[0]
                                 if mine and dtype == torch.float32
                                 else None),
                bf16_tensor_core_bound_ms=ops / BF16_OPS_PER_S * 1e3,
                ops=ops, bytes=nbytes, achieved_tflops=ops / ms / 1e9,
                empty_profiler_sessions=EMPTY_PROFILER_SESSIONS[0])
            fp32 = report.get(f"{name}_float32")
            if dtype == torch.bfloat16 and fp32 is not None:
                rep["speedup_vs_float32"] = fp32["ms"] / ms
                rep["device_speedup_vs_float32"] = (
                    fp32["kernel_device_ms"] / rep["kernel_device_ms"]
                    if fp32["kernel_device_ms"] and rep["kernel_device_ms"]
                    else None)
            report[f"{name}_{rep['dtype']}"] = rep
            emit({"phase": "flash", "case": name, **rep})
    main = report["a_smollm_layer0_bfloat16"]
    return dict(main, launches=launches)


if __name__ == "__main__":
    if "--mesh-worker" in sys.argv[1:]:
        sys.exit(mesh_worker("cpu" if "--cpu" in sys.argv[1:] else None))
    sys.exit(main())
