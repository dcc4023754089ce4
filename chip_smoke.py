#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--views 1] [--res 200]

Serves novel views from a compressed TensoRF field at the full width of
`NeRFConfig()` (grid 160, R 16 + 48, app_dim 27, 8192 cubes) through the
port's entry points, and holds every CUDA kernel on that path against its
plain PyTorch version on inputs captured from the run. Phases, one JSON
line each:

  device   the card (torch and nvidia-smi);
  build    the kernels compiled from src/repro_torch/kernels/csrc;
  lm_train language-model training (plain PyTorch ops under autograd; no
           kernel of the port), first, while the machine's memory is
           free: one step (AdamW at the launcher's lr and schedule, the
           clip) of every reduced config in float32 and bf16, and of
           llama3.2-1b at published widths with 2 layers in float32, on
           the card against the CPU (loss, every gradient leaf, every
           updated param); llama3.2-1b at 8 of 16 layers (AdamW, 8 x 512
           tokens) and grok-1 cut to 1 layer (adafactor, COO, 4 x 128)
           trained at published widths in bf16, one `lm_train_full` line each: ms a
           step and its forward / backward / clip + update split, tok/s,
           peak memory, a profiled step, the least time the card could
           take; the training launcher as users run it: an injected
           failure beside the same run without it (the final checkpoints
           equal), the reduced deepseek-v3 and seamless-m4t, and
           llama3.2-1b at full size (two 12.4 GB checkpoints, their
           write seconds);
  lm       language-model serving of all ten archs (plain PyTorch ops;
           no kernel of the port): the reduced config of each in float32
           (greedy tokens equal too) and bfloat16, and LM_WIDE_CUTS
           (published widths, depth cut) in float32, prefill and decode
           on the card against the CPU on the same params, tokens and
           encoder frames; each of LM_FULL_CUTS at published widths on
           the card in bf16 (llama3.2-1b 8 of 16 layers; zamba2-7b 7 of 81
           blocks, rwkv6-1.6b 2 of 24 layers, seamless-m4t-large-v2 2
           + 2 of 24 + 24, deepseek-v3 1 dense + 1 MoE layer, grok-1 2
           layers), one `lm_full` line each: prefill ms,
           decode ms a step and tok/s at LM_FULL (batch 4, prompt 128,
           32 greedy tokens), peak memory, the least time the card could
           take, a profile of a prefill and 4 decode steps (not for
           the recurrent archs), and prefill-then-decode against the
           teacher-forced forward (float32 and bf16; MoE at check
           capacity), for the MoE archs the bitmap and COO dispatches
           agreeing on the first MoE layer's input, for the recurrent
           archs the float32 check at LM_RECURRENT_SEEDS seeds; the
           launcher run as a user runs it (`--arch <a> --reduced`) for
           llama3.2-1b and the five archs beyond the dense trunk, on
           cuda, the six side by side; after lm_train, while the
           machine's memory is free;
  lm_mesh  language-model serving across ranks (DTensors over a (data,
           model) mesh; no kernel of the port): two ranks spawned on the
           card over gloo, each world once, llama3.2-1b cut to 2 of 16
           layers on 1 x 2 and 2 x 1, grok-1 cut to 1 layer on 1 x 2 (4
           of 8 experts a rank, each dispatch), and zamba2-7b (7 of 81
           blocks), rwkv6-1.6b (2 of 24 layers) and seamless-m4t (2 + 2)
           on 1 x 2, at LM_MESH (batch 4, prompt 128, 8 greedy tokens):
           float32 `serve_lm` tokens equal to the single process's and
           its logits within LM_MESH_TOL (LM_RECURRENT_F32_TOL for the
           recurrent archs), bf16 logits (teacher-forced) by the noise
           rule; per mesh prefill ms, decode ms a step, the ms of gloo's
           collectives in a profiled step, each rank's param bytes
           against the whole tree's, which collectives gloo carries on
           bf16 CUDA tensors; then the LM launcher for llama3.2-1b and
           the reduced zamba2-7b, each under `torchrun --nproc-per-node
           2 --backend gloo` beside one process, the same sample tokens;
  lm_mesh_train  the language-model train step across ranks (params,
           optimizer state and batch placed; gradients through the
           port's collectives; no kernel of the port), in the lm_mesh
           worlds' ranks after their serving runs: llama3.2-1b cut to 4
           of 16 layers in
           float32 and bf16 with AdamW on 1 x 2 and 2 x 1, grok-1 cut to
           1 layer in bf16 with adafactor on 1 x 2, batch 4 x 128, two
           steps each against the same two steps in one process on the
           card (LM_MESH_TRAIN_RUNS): losses, grad norms, gradient leaves
           and (float32) the params after a step; per rank the ms of a
           step and its forward / backward / clip + update split, gloo's
           ms in a profiled step, the functional collectives (none), its
           bytes of params and optimizer state;
  field    a full-width field made from --seed with numpy, density
           confined to a few blobs, pruned and hybrid-encoded;
  serve    RenderEngine(cfg, field, device="cuda") builds the occupancy on
           the card (bitmap/COO gather kernels), then renders --views
           views of --res x --res on an orbit of radius 4 (fused kernel);
  view     one line per served view;
  parity   a small view rendered on the card against the same view
           rendered on the CPU through the plain versions;
  profile  one 64 x 64 view (one ray chunk) under torch.profiler: the
           device's busy share and the kernels taking the most time;
  store, delta, auto_flush, per_op_route, geometry  the serving tier:
           scenes spilled and revived, delta frames, the flush thread,
           a field past the fused kernel's shared memory, and occupancy
           and rays built on the card against the CPU;
  eval     the evaluation path at the paper's 800 x 800 view of the
           serve phase's field and cube set: the ground truth of "lego",
           render_rtnerf (eval_view, 8 cubes a scan step, the fused
           kernel) and the uniform baseline (eval_view, 640,000 rays x
           512 samples in passes, the gather kernels), each timed, with
           its launches, stats and the paper's ratio of occupancy
           accesses; each held against the port's CPU path
           (render_rtnerf at 64 x 64, the baseline on 512 strided rays
           of the view, the ground truth at 800 x 800 under a tie rule);
  kernel_ops  the kernel entry points `repro_torch.kernels.ops` offers
           beside the serve path, driven at full width: bitmap_matmul on
           Fig. 14's operand (app_planes slice 0 of the field, times x
           (25,600, 8)), volume_render on the field's uniform samples of
           4096 rays x NeRFConfig().max_samples_per_ray (the view's first
           rays, and its middle 64 x 64 rays with the density scaled until
           they terminate), flash_attention at Llama 3.2 1B's widths (32
           heads, head dim 64, 8 kv heads repeated) over 4096 tokens,
           causal;
  train    training and online fine-tuning on the card: NerfTrainer on
           "lego" at NeRFConfig() (12 views of 64 x 64, 4096 rays x 512
           samples a step), resumed from the serve phase's encoded field,
           20 steps across a re-encode at step 10 (ms a step, forward and
           backward of one step, peak memory, loss and PSNR per step,
           formats around the re-encode, the launches of the gathers'
           forward and backward kernels), 3 steps of a fresh dense field;
           one step's loss and every trainable leaf's gradient against
           the CPU on 256 rays; the trained field's cube set from
           final(), published to the serve engine and served; a
           FineTuneLoop on the engine's store publishing while the engine
           serves;
  fleet    the store phase's three scenes exported (`export_scene`: the
           occupancy built through the gather kernels) and served by two
           worker processes on the card behind `FleetRouter`, 64 x 64
           views (one ray chunk each): the seconds from spawn to the
           first result; each image against the port's CPU path (every
           8th ray) and beside the parent's in-process engine; a
           replicated scene served by both workers; the same 4 views
           through one worker and across two; a worker SIGKILLed with
           views queued behind an injected stall, every future resolved
           and the live ones replayed; each worker's device, dispatch
           path and kernel launches from its `stats` reply; the `fleet_*`
           metric families; close() leaving no child process;
  launch   `python -m repro_torch.launch.serve --arch rtnerf` run twice
           on one checkpoint root (train, fleet of two workers with the
           hot scene on both): exit codes, seconds, the device each
           printed, views, fps, kernel launches, and PSNRs equal to
           0.01 dB across the runs;
  mesh     `RenderEngine(mesh=)` across ranks spawned on the card: (a)
           one rank over NCCL, (b) two ranks sharing the card over gloo,
           each restoring the serve phase's field, building its occupancy
           through the gathers and rendering 2 views of 64 x 64 (one
           chunk each; in (b) half of every chunk a rank), each image
           within PARITY_TOL of the single-process engine's and the
           counters equal; per rank its kernel launches, ms a view and
           the engine's collectives' ms; (a) gpipe at one stage against
           its reference, (b) which collectives gloo carries on CUDA
           tensors; the serving launcher under `torchrun
           --nproc-per-node 1` restoring the launch phase's lego, its
           PSNRs equal to the launch phase's train run to 0.01 dB;
  kernels  {"kernels": [...]}: per kernel its launches on its path (serve,
           kernel_ops or train), the largest error against its plain
           version
           (the fused kernel on the captured step's cube order, two
           ascending runs, and on a shuffled copy; the COO gather on the
           occupancy build's first and middle chunk and on a shuffled
           copy, each with the share of its query tiles whose stream
           window the kernel staged in shared memory, as the kernel
           counts them; each flash kernel with the count of HGMMA in its
           SASS; the volume row with the bytes each case read, as the
           kernel counts its copies, held against the design's
           prediction; the fp32 flash row with its CUDA-core and 3xTF32
           bounds, and the SDPA backend its library call ran),
           its device time and the plain version's (CUDA events over a
           CUDA graph of repeated calls; `wall_ms`, over eager calls,
           includes the wrapper's host time; the fused row's `host_ms` is
           that host time alone), the time of one PyTorch call
           computing the same function where there is one, and the least
           time the card could take. Rows 1 to 3 carry an `eval`
           entry: the same at the eval path's shapes (the fused kernel
           at a render_rtnerf scan step, the gathers at a quarter of one
           uniform pass's appearance-plane call), with the launches of
           one 800 x 800 view; rows 2 and 3 a `train` entry, the same at
           a training step's appearance-plane call with the training
           run's launches; rows 1 to 3 a `fleet` entry, the launches of
           the fleet phase, summed from the workers' replies and the
           parent's exports, and a `mesh` entry, each mesh rank's
           launches. Rows 7 and 8 are the gathers' backward
           kernels at that call, held against their plain versions
           within the reordering bound of fp32 sums, with `index_add_`
           on the precomputed slots as the library call; each also timed
           on a shuffled copy of the call (no runs of equal queries) and
           checked, as is the shuffled copy, on 1 << 20 queries all on
           one slot; the COO row with the share of its warps' tiles
           searched in the CTA's staged range, as the kernel counts
           them, held against `bwd_search_counts`.

Then the card's name and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
nonzero and prints no result, as it does without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_16BIT_S = 989e12         # bf16 and fp16 tensor cores, dense
PEAK_TF32_S = 495e12          # TF32 tensor cores, dense

FUSED_TOL = 1e-4      # summation order differs (per-channel vs one matmul)
PARITY_TOL = 1e-3     # image: atomics order + kernel sums over 1024 steps
# kernel_ops: the kernels sum in another order than their plain versions
# (per-thread partial sums, warp scans, online softmax); the low-precision
# cases round their outputs once.
# bitmap_matmul fp32: a row sums up to 25,600 products, so the error is
# held against tol x (1 + |W| @ |x|), not against the result, which may
# cancel; fp16: both round the same fp32 sum to fp16, so the result is
# held to rtol = atol = tol
BITMAP_TOL = {"float32": 1e-5, "float16": 2e-2}
VR_TOL = 1e-5         # color and t_final, absolute
NPROC_REL_TOL = 1e-4  # nproc: exact, or this close with the odd samples
                      # sitting at term_eps
# (rtol, atol); bf16: one output ulp is at most 2^-7 of |o|, and atol
# covers outputs near 0
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}

BITMAP_N = 8          # x columns (benchmarks/speedup_fig14.py)
VR_RAYS = 4096        # the engine's ray chunk
# the second volume case: the 64 x 64 rays through the middle of the view
# (across the blobs), the field's density scaled so the rays terminate:
# the background's optical depth over a ray, about 1, becomes about 20,
# above -log(term_eps) = 9.2, and the blobs stop their rays earlier
VR_OPAQUE_SCALE = 20.0
OCC_CHUNK = 65536     # core/occupancy.build_occupancy's points per chunk
# Llama 3.2 1B (src/repro/configs/llama3_2_1b.py) at train_4k's length
FLASH_SHAPE = {"B": 1, "H": 32, "kv_heads": 8, "S": 4096, "D": 64}

# the serving tier's phases. Views of 64 x 64 are one ray chunk (4096
# rays, 1024 scan steps)
STORE_SCENES = 3          # scenes made from --seed, --seed + 1, ...
STORE_BUDGET = 2.5        # max_resident_bytes, in scene 0's factor bytes
STORE_RES = 64
DELTA_STEP = 0.05         # rad between delta frames
DELTA_PSNR_DB = 35.0      # tests/test_temporal.py's bound
AF_PRODUCERS, AF_VIEWS, AF_RES = 4, 2, 32
AF_INTERVAL_S = 0.05
RESULT_TIMEOUT_S = 300.0  # every future and thread of the phases
# NeRFConfig(cube_size=16, max_cubes=1000): fused window 31, past the
# sample kernel's shared memory; 16 is the smallest divisor of occ_res 160
# that is (cube_size 12, window 24, does not divide 160), and 1000 cubes
# are every cube of its 10^3 grid
PER_OP_CUBE_SIZE = 16
# the geometry phase's renders: one chunk per 200 x 200 view, a budget
# above any step's hitting pairs (about 400), so none is dropped
GEO_RAY_CHUNK = 40960
GEO_PAIR_BUDGET = 4096
# the eval phase: the paper's render_800 view (focal 960, tile 80, 15
# samples a segment) of the serve phase's field and cube set, on the
# store phase's orbit angle; render_rtnerf composites EVAL_CHUNK cubes a
# scan step. Its CPU parity: render_rtnerf at EVAL_PARITY_RES, the
# uniform baseline on every EVAL_UNIFORM_STRIDE-th ray of the view
# (512 rays), the ground truth at the full view
EVAL_RES = 800
EVAL_ANGLE = 0.3
EVAL_CHUNK = 8
EVAL_SCENE = "lego"
EVAL_PARITY_RES = 64
EVAL_UNIFORM_STRIDE = 1250
GT_TOL = 1e-4         # ground-truth colours off the tie pixels
GT_TIE = 1e-5         # a final SDF this close to the hit threshold is a tie
GT_TIE_SHARE = 1e-3   # ... and at most this share of pixels may flip
# the gather rows' eval timing: the first EVAL_GATHER_ROWS of the 48 rows
# of one render_uniform pass's appearance-plane call (its plain version
# over the whole call would hold about 38 GB of int64 temporaries)
EVAL_GATHER_ROWS = 12
# the backward rows' shuffled copy of the training call, and their
# one-slot stress case: BWD_ONE_SLOT queries all on one value slot, with
# whole-number gradients in [-BWD_ONE_SLOT_GRAD, BWD_ONE_SLOT_GRAD] made
# from BWD_ONE_SLOT_SEED: every partial sum is below 2^24 and exact in
# fp32, so any order gives the plain version's sum bit for bit
BWD_SHUFFLE_SEED = 1
BWD_ONE_SLOT = 1 << 20
BWD_ONE_SLOT_GRAD = 2
BWD_ONE_SLOT_SEED = 2
# the train phase: NerfTrainer on "lego" at NeRFConfig() (12 views of
# 64 x 64, train_rays 4096 x 512 samples: one render_uniform pass a
# step), resumed from the serve phase's encoded field, TRAIN_STEPS steps
# across one re-encode at TRAIN_OCC_EVERY; DENSE_STEPS steps of a fresh
# dense field; one step's loss and gradients on the card against the CPU
# on CPU_RAYS rays; FT_STEPS fine-tune steps publishing every FT_PUBLISH
TRAIN_SCENE = "lego"
TRAIN_STEPS = 20
TRAIN_OCC_EVERY = 10
TRAIN_VIEWS, TRAIN_RES = 12, 64
DENSE_STEPS = 3
CPU_RAYS = 256
# card against CPU: the loss within LOSS_RTOL relative; each gradient
# within GRAD_TOL of its leaf's largest |gradient| (sums in other orders:
# GEMM blocking, the backward kernels' atomics, the card's exp and log)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# one adamw update on the same gradients and state, card against CPU:
# elementwise and rounded alike but for the card's pow (1 - b2 ** step),
# so within UPDATE_RTOL relative and UPDATE_ATOL_LR x lr
UPDATE_RTOL, UPDATE_ATOL_LR = 1e-6, 1e-5
FT_STEPS, FT_PUBLISH, FT_VIEWS, FT_MAX_REQUESTS = 4, 2, 4, 8
# the fleet phase: the store phase's scenes exported and served by
# FLEET_WORKERS worker processes on the card, FLEET_RES x FLEET_RES views
# (one 4096-ray chunk each) on the store phase's orbit; FLEET_TIMED_VIEWS
# views of s0 timed through one worker and across two; a worker SIGKILLed
# FLEET_KILL_AFTER_S into an injected FLEET_STALL_S stall with
# FLEET_IN_FLIGHT views queued on it. The CPU path renders every
# FLEET_CPU_STRIDE-th ray of each scene's view (512 rays; a ray's colour
# does not depend on the other rays of its chunk) through the engine's
# renderer and ordering, with a CPU_PAIR_BUDGET pair budget above any
# step's hitting pairs (no pair may be dropped, which the phase checks)
# where the card's engines keep 8192: the compaction's size, not its
# result. Its scan stops at the chunk of the last valid cube: the
# ordering puts invalid cubes last, and a step of invalid cubes hits
# nothing and adds zeros (at 1024 steps a scene took 53 s on the card
# machine's CPU). The cube chunk stays the engine's 8: a step's cubes
# composite against the transmittance at the step's start, so the image
# moves with it (tests/test_torch_engine.py::
# test_cube_chunk_moves_the_image_as_in_the_reference)
FLEET_WORKERS = 2
FLEET_RES = 64
FLEET_TIMED_VIEWS = 4
FLEET_STALL_S = 2.0
FLEET_KILL_AFTER_S = 0.5
FLEET_IN_FLIGHT = 3
FLEET_CPU_STRIDE = 8
CPU_PAIR_BUDGET = 256
# the launch phase: `python -m repro_torch.launch.serve --arch rtnerf` on
# the card, three runs on one checkpoint root: train and serve, restore
# and serve, restore and serve through the fleet; PSNRs within
# LAUNCH_PSNR_DB of each other. The fields are pruned to 90% before they
# serve (the reference launcher's own example): a fresh field trains
# dense (its first re-encode is at step 200) and would otherwise encode
# dense, so no gather kernel would build its occupancy
LAUNCH_ARGS = ["--arch", "rtnerf", "--scenes", "lego,chair", "--views", "2",
               "--prune-sparsity", "0.9", "--res", "64", "--train-steps",
               "20"]
LAUNCH_FLEET_ARGS = ["--fleet-workers", "2", "--fleet-replicas", "2"]
LAUNCH_PSNR_DB = 0.01
LAUNCH_TIMEOUT_S = 300
# the mesh phase: RenderEngine(mesh=) across ranks on the card, in ranks
# spawned with the spawn start method: (a) one rank over NCCL on cuda:0;
# (b) two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
# card), each rendering half of every chunk. Each world restores the
# serve phase's field, builds its occupancy (the gather kernels) and
# renders MESH_VIEWS views of MESH_RES x MESH_RES (one chunk each) at a
# fixed pair budget above any step's hitting pairs (no pair may be
# dropped, which the phase checks); each image within PARITY_TOL of the
# single-process engine's on the card, the counters equal. The first view
# warms the rank up; the second is timed. (a) also runs gpipe at one
# stage (gpipe's point-to-point sends are what gloo cannot carry on CUDA
# tensors, so (b) does not run it); two more ranks sharing the card probe
# which collectives gloo carries on CUDA tensors. Then the serving
# launcher under `torchrun --nproc-per-node 1` restores the
# launch phase's lego; its PSNRs within LAUNCH_PSNR_DB of the launch
# phase's train run.
MESH_VIEWS = 2
MESH_RES = 64
MESH_PAIR_BUDGET = 2048
MESH_WORLDS = (("nccl", 1), ("gloo", 2))
MESH_COLLECTIVE_TIMEOUT_S = 60
MESH_PROBE_TIMEOUT_S = 10
MESH_TIMEOUT_S = 180
MESH_COLLECTIVE_REPEATS = 20
# send/recv last: gloo's send of a CUDA tensor killed the process with
# torch 2.11 on the H100 machine (a TCP write from device memory)
MESH_PROBES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor", "reduce",
               "gather", "scatter", "all_to_all_single", "barrier",
               "send_recv")
MESH_LAUNCH_ARGS = ["--scenes", "lego"]


# the lm phase: language-model serving of the dense archs
# (repro_torch.models.transformer through launch/steps.py). Card against
# the CPU on the same params: float32 to 1e-4 (cuBLAS sums in another
# order than the CPU's GEMMs, about 1e-6 relative a product; the full
# width's logits sum 2,048 of them), bfloat16 to 3e-2 (the reference's
# decode-parity bound: the two devices round bf16 sums apart).
# Full size, prefill-then-decode against the teacher-forced forward on
# the card: in float32 to 1e-4, inside the reference's 3e-2
# (tests/test_decode_parity.py:66; 1.9e-5 measured on an H100). In bf16
# the reference's 3e-2 cannot hold at 16 layers: the bf16 forward itself
# lies up to 0.086 from the float32 forward on an H100, so the bf16
# decode is held to be no farther from the float32 forward than the
# bf16 forward is, by LM_BF16_NOISE_RATIO in max and in mean, and its
# distance to the bf16 forward under 3e-2 is reported.
LM_ARCHS = ("llama3.2-1b", "granite-3-8b", "qwen1.5-32b", "granite-34b",
            "internvl2-76b", "deepseek-v3-671b", "grok-1-314b", "zamba2-7b",
            "rwkv6-1.6b", "seamless-m4t-large-v2")
LM_CPU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LM_DECODE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LM_BF16_NOISE_RATIO = 1.25
LM_SMALL = {"batch": 2, "prompt": 12, "gen": 4}
# float32 card against CPU at published widths, depth cut so that the CPU
# side holds it (zamba2: one group with the shared layer)
LM_WIDE_CUTS = {"llama3.2-1b": {"n_layers": 2},
                "rwkv6-1.6b": {"n_layers": 2},
                "seamless-m4t-large-v2": {"n_layers": 2, "n_enc_layers": 2},
                "zamba2-7b": {"n_layers": 6}}
# published widths on the card in bf16 at LM_FULL; the two MoE archs'
# depth cut to fit one card's 80 GB beside a float32 copy (PERF.md §4),
# llama3.2-1b to 8 of 16 layers (whole before the lm_mesh_train part),
# the recurrent and enc-dec archs' to a twelfth of their depth or less
# (zamba2: one group of 6 blocks ending in the shared layer, and 1
# trailing; rwkv6 2 of 24 layers; seamless 2 + 2 of 24 + 24) to keep
# the smoke inside its time limit beside the lm_mesh and lm_mesh_train
# phases: their per-layer loops are launch-bound
LM_FULL = {"batch": 4, "prompt": 128, "gen": 32}
LM_FULL_CUTS = {"llama3.2-1b": {"n_layers": 8},
                "zamba2-7b": {"n_layers": 7}, "rwkv6-1.6b": {"n_layers": 2},
                "seamless-m4t-large-v2": {"n_layers": 2,
                                          "n_enc_layers": 2},
                "deepseek-v3-671b": {"n_layers": 2, "n_dense_layers": 1},
                "grok-1-314b": {"n_layers": 2}}
LM_PREFILL_REPEATS = 3
# decode steps after the profiled prefill. The recurrent archs are not
# profiled: a prefill and 4 decode steps launch 38,382 (rwkv6-1.6b) and
# 82,870 (zamba2-7b) kernels, and with the profile their timed part took
# 50 and 114 s on an H100, against 19 s for llama3.2-1b
LM_PROFILE_STEPS = 4
# prefill groups MoE tokens by sequence and decode puts the batch in one
# group, so decode equals the forward only with capacity headroom
# (tests/test_decode_parity.py:23-27): the checks run at this factor, or
# at E / top_k where that is larger (no token can drop: C >= S), the
# timed runs at the published 1.25. Random weights route most of a
# sequence's tokens to the same few experts (15 of 16 tokens on one of
# deepseek-v3's reduced experts on a CPU), so at full width factor 16
# (C = S / 2 for deepseek-v3) dropped tokens in the forward and not in
# decode (0.40 apart on an H100)
LM_CHECK_CAPACITY = 16.0
LM_DISPATCH_TOL = 1e-4        # bitmap vs COO, float32, no drops
# the recurrent families (Mamba2 hybrid, RWKV6) carry their state across
# the sequence, and float32 rounding grows over their depth: at full
# depth their float32 prefill-then-decode parts from the forward by up
# to 1.6e-3 (zamba2-7b, three seeds on an H100; ROADMAP Queue 3 item
# 20), so it is held to LM_RECURRENT_F32_TOL, and the distances of both
# from the forward on float64 params are reported (the scan, the WKV
# recurrence and the norms keep the reference's float32 upcasts there),
# at LM_RECURRENT_SEEDS seeds. Their reduced configs' bf16 logits lie
# 0.14 to 0.19 from their float32 logits on an H100 and on a CPU (the
# lm line's card_vs_cpu entries), so two devices' bf16 roundings may
# part by more than LM_CPU_TOL's 3e-2: their bf16 card against CPU is
# held, like the full size's bf16, to be no farther from the float32
# logits (the same params on the CPU) than the CPU's bf16 is, by
# LM_BF16_NOISE_RATIO.
LM_RECURRENT = ("hybrid", "ssm")
LM_RECURRENT_F32_TOL = 5e-3
LM_RECURRENT_SEEDS = 1        # more seeds repeat the check (25 s a seed)
LM_LAUNCH_ARCHS = ("llama3.2-1b", "deepseek-v3-671b", "grok-1-314b",
                   "zamba2-7b", "rwkv6-1.6b", "seamless-m4t-large-v2")
LM_LAUNCH_ARGS = ["--reduced", "--batch", "4", "--prompt-len", "32",
                  "--gen", "16"]
# the lm_mesh phase: the language models on DTensors over a (data, model)
# mesh of ranks spawned on the card, sharing it over gloo (NCCL refuses
# two ranks on one card), each world spawned once: llama3.2-1b at
# LM_MESH on a 1 x 2 (tensor parallel) and a 2 x 1 (the launcher's)
# mesh, cut for the smoke's time to 4 of its 16 layers since the
# enc-dec, hybrid and RWKV runs, to 2 since the train runs that the same
# worlds then run (LM_MESH_TRAIN_RUNS); grok-1 cut to 1 layer at published
# widths on 1 x 2 (4 of its 8 experts a rank), each dispatch, at
# capacity E / top_k. Against the single process on the same params:
# float32 greedy tokens exactly and every step's logits (teacher-forced
# on those tokens) to LM_MESH_TOL;
# bf16 logits no farther from the float32 logits of the same params than
# the single process's bf16 logits are, by LM_BF16_NOISE_RATIO in max and
# in mean. Each rank draws the params placed a leaf at a time
# (`init_model(rules=)`): two ranks drawing grok-1's float32 tree (26 GB)
# whole would not fit. The enc-dec, hybrid and RWKV trunks at published
# widths on the same 1 x 2 world, depth cut: zamba2-7b at 7 of 81 blocks
# (a group of 6 ending in the shared layer, and one trailing block; 13
# before the train runs), rwkv6-1.6b at 2 of 24 layers,
# seamless-m4t-large-v2 at 2 + 2 layers (its encoder frames drawn from
# the seed, as the prompt). The
# recurrent archs' float32 logits are held to LM_RECURRENT_F32_TOL (Queue
# 3 item 20), the others' to LM_MESH_TOL. The single process runs once
# for each arch, cut and dispatch (`lm_mesh_ref`), however many meshes run
# them. Then `python -m repro_torch.launch.serve` for llama3.2-1b and the
# reduced zamba2-7b, each under `torchrun --nproc-per-node 2 --backend
# gloo` beside one process, all started together: the same sample tokens.
LM_MESH = {"batch": 4, "prompt": 128, "gen": 8}
LM_MESH_TOL = 1e-4
LM_MESH_WORLDS = ((1, 2), (2, 1))
LM_MESH_RUNS = (
    {"key": "llama3.2-1b@1x2", "world": (1, 2), "arch": "llama3.2-1b",
     "cut": {"n_layers": 2}, "dispatch": None},
    {"key": "grok-1-314b/bitmap@1x2", "world": (1, 2),
     "arch": "grok-1-314b", "cut": {"n_layers": 1}, "dispatch": "bitmap"},
    {"key": "grok-1-314b/coo@1x2", "world": (1, 2), "arch": "grok-1-314b",
     "cut": {"n_layers": 1}, "dispatch": "coo"},
    {"key": "zamba2-7b@1x2", "world": (1, 2), "arch": "zamba2-7b",
     "cut": {"n_layers": 7}, "dispatch": None},
    {"key": "rwkv6-1.6b@1x2", "world": (1, 2), "arch": "rwkv6-1.6b",
     "cut": {"n_layers": 2}, "dispatch": None},
    {"key": "seamless-m4t-large-v2@1x2", "world": (1, 2),
     "arch": "seamless-m4t-large-v2",
     "cut": {"n_layers": 2, "n_enc_layers": 2}, "dispatch": None},
    {"key": "llama3.2-1b@2x1", "world": (2, 1), "arch": "llama3.2-1b",
     "cut": {"n_layers": 2}, "dispatch": None})
LM_MESH_TIMEOUT_S = 420
LM_MESH_LAUNCH = [
    ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "32", "--gen",
     "8"],
    ["--arch", "zamba2-7b", "--reduced", "--batch", "4", "--prompt-len",
     "32", "--gen", "8"]]
# the lm_mesh_train part of the lm_mesh phase (its own line): the LM
# train step across ranks (DTensors over a (data, model) mesh; gradients
# through the port's own collectives, the clip and the optimizers on
# placed state; no kernel of the port), run by the lm_mesh worlds' ranks
# after their serving runs. llama3.2-1b at published widths cut to 4 of
# 16 layers, float32 and bf16, AdamW at the launcher's lr and schedule,
# on 1 x 2 and 2 x 1; grok-1 cut to 1 of 64 layers, bf16, adafactor
# (lm_train's optimizer for it) on 1 x 2, at capacity E / top_k (no
# token drops). Each run: a first step under the profiler (gloo's spans,
# any `_c10d_functional::` op; its gradients sampled as its
# `loss_and_grads` returns them), a second step in three synchronised
# parts (forward, backward, clip + update); the single process on the
# card runs the same first. Against it: float32 losses and grad_norm of
# both steps within LM_MESH_TRAIN_TOL (relative where above 1), each
# gradient leaf within it of the leaf's largest, the params after the
# first step by AdamW's first-step bound (`adamw_first_step_ratio`'s);
# bf16 losses within LM_MESH_TRAIN_BF16_LOSS_TOL, each gradient leaf no
# farther from the float32 gradient of the same bf16 params (one
# process) than the single process's bf16 gradient is, by
# LM_BF16_NOISE_RATIO in max and in mean. Leaves are compared on a fixed
# stride of at most LM_MESH_TRAIN_SAMPLES elements each (every element
# of a smaller leaf), which each rank reads from its own shard.
LM_MESH_TRAIN = {"batch": 4, "seq": 128}
LM_MESH_TRAIN_RUNS = (
    {"key": "llama3.2-1b@1x2", "world": (1, 2), "arch": "llama3.2-1b",
     "cut": {"n_layers": 4}, "opt": "adamw",
     "dtypes": ("float32", "bfloat16")},
    {"key": "grok-1-314b@1x2", "world": (1, 2), "arch": "grok-1-314b",
     "cut": {"n_layers": 1}, "opt": "adafactor", "dtypes": ("bfloat16",)},
    {"key": "llama3.2-1b@2x1", "world": (2, 1), "arch": "llama3.2-1b",
     "cut": {"n_layers": 4}, "opt": "adamw",
     "dtypes": ("float32", "bfloat16")})
LM_MESH_TRAIN_TOL = 1e-4
LM_MESH_TRAIN_BF16_LOSS_TOL = 5e-2
LM_MESH_TRAIN_SAMPLES = 1 << 18
# the lm_train phase: language-model training (launch/steps.py's
# build_train_step over models/transformer.model_loss and autograd, the
# optim package, data/tokens.py, launch/elastic.py, launch/train.py; no
# kernel of the port). Card against the CPU: one step of AdamW at the
# launcher's lr and schedule, with the clip, on the same params and
# TokenStream batch. The loss to 1e-5 relative in float32 (3e-2 in bf16),
# every gradient leaf to 1e-4 of its largest in float32 (the NeRF
# trainer's rule) and 3e-2 in bf16. AdamW's first step moves a param by
# lr g / (|g| + eps), near sign(g): where |g| sits at the gradients' own
# error two devices may move it apart by up to 2 lr, so each float32 param
# is held to that tolerance of its leaf's largest plus the first-order
# reach of the gradient error, lr x 4 tol max|g| / (|g| + eps), g = m /
# (1 - b1) (`adamw_first_step_ratio`; bf16 params too, with 3e-2: a
# zero-initialised bias moves by about lr, so its leaf's largest is no
# scale for it). The recurrent archs' bf16 gradients are held by the
# ratio rule of their serving logits (no farther from the CPU's float32
# gradients than the CPU's bf16 ones, LM_BF16_NOISE_RATIO; ROADMAP Queue
# 3 item 21); an MoE arch's by the same rule only where a token's bf16
# route differs between the devices (each such token named).
LM_TRAIN_SMALL = {"batch": 2, "seq": 16}
LM_TRAIN_LR = 3e-4                  # launch/train.py's default
LM_TRAIN_STEPS = 20                 # its schedule: cosine(max(n // 20, 1), n)
LM_TRAIN_ADAMW = {"b1": 0.9, "eps": 1e-8}       # adamw's defaults
LM_TRAIN_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 3e-2}
LM_TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LM_TRAIN_WIDE_CUTS = {"llama3.2-1b": {"n_layers": 2}}
# the enc-dec arch's first encoder norm gain is differentiated through the
# bf16 cast of the encoder frames (its cotangent rounds to bf16 on both
# devices; ROADMAP Queue 3 item 24): in float32 it is held to one bf16
# ulp of its largest (1.2e-4 read on an H100, the others within 2.6e-6)
LM_TRAIN_BF16_CAST_LEAF = ("/enc/ln1", 2.0 ** -8)
# published widths in bf16 on the card, timed: llama3.2-1b with AdamW,
# cut to 8 of 16 layers for the smoke's time (whole before the
# lm_mesh_train part); grok-1 cut to 1 layer with adafactor, the optimizer that
# pick_optimizer gives the uncut 316 B arch (AdamW's float32 moments of
# the cut, 52 GB, do not fit beside it); COO dispatch at capacity 1.25
LM_TRAIN_FULL = {
    "llama3.2-1b": {"cut": {"n_layers": 8}, "batch": 8, "seq": 512,
                    "warmup": 2, "steps": 10},
    "grok-1-314b": {"cut": {"n_layers": 1}, "batch": 4, "seq": 128,
                    "warmup": 1, "steps": 5}}
# the training launcher as users run it: an injected failure beside the
# same run without it, the full-size model (two checkpoints of 12.4 GB),
# and the reduced MoE-with-MTP and enc-dec archs
LM_TRAIN_LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--steps", "8",
                   "--ckpt-every", "2"]
LM_TRAIN_FAIL_AT = 5
LM_TRAIN_LAUNCH_FULL = ["--arch", "llama3.2-1b", "--no-reduced", "--steps",
                        "3", "--batch", "8", "--seq", "512"]
LM_TRAIN_LAUNCH_ARCHS = ("deepseek-v3-671b", "seamless-m4t-large-v2")
LM_TRAIN_LAUNCH_TIMEOUT_S = 600
# the full-size launcher run writes two 12.4 GB checkpoints into the
# temporary directory (RAM-backed on the card's machine) and holds a
# 12.4 GB host copy of its state for each: it starts only with this much
# memory available, and the smoke fails with the reading otherwise
LM_TRAIN_FULL_RUN_RAM_GB = 48


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def object_field(cfg, seed: int):
    """Full-width field params with density confined to four Gaussian
    blobs: mode-0 component 0 holds a constant negative density offset
    (softplus(-1.5) < occ_sigma_thresh everywhere), components 1..4 the
    separable blobs; the other slices carry low-amplitude texture at
    sparsities that encode as bitmap, COO or dense."""
    rng = np.random.default_rng(seed)
    G, Rs, Rc, A = cfg.grid_res, cfg.r_sigma, cfg.r_color, cfg.app_dim
    g = np.arange(G, dtype=np.float32)

    def texture(shape, frac, scale):
        return (rng.normal(0, scale, shape) * (rng.random(shape) < frac)
                ).astype(np.float32)

    sp = np.zeros((3, Rs, G, G), np.float32)
    sl = np.zeros((3, Rs, G), np.float32)
    sp[0, 0], sl[0, 0] = -1.5, 1.0
    s = 8.0                                       # blob width, voxels
    for j, c in enumerate(rng.uniform(-0.5, 0.5, size=(4, 3))):
        cg = (c / cfg.scene_bound * 0.5 + 0.5) * (G - 1)
        sp[0, 1 + j] = 3.5 * np.exp(-((g[:, None] - cg[1]) ** 2
                                      + (g[None, :] - cg[2]) ** 2) / (2 * s * s))
        sl[0, 1 + j] = np.exp(-(g - cg[0]) ** 2 / (2 * s * s))
    sp[1], sl[1] = texture((Rs, G, G), 0.4, 0.02), texture((Rs, G), 0.5, 0.02)
    sp[2], sl[2] = texture((Rs, G, G), 0.08, 0.02), texture((Rs, G), 0.08, 0.02)
    ap = np.stack([texture((Rc, G, G), f, 0.3) for f in (0.5, 0.08, 0.3)])
    al = np.stack([texture((Rc, G), f, 0.5) for f in (0.6, 0.08, 1.0)])
    in_dim = 3 + 6 * cfg.pe_view + A + 2 * A * cfg.pe_feat
    H = cfg.mlp_hidden

    def dense(*shape):
        return (rng.normal(0, 1, shape) / math.sqrt(shape[0])).astype(
            np.float32)

    return {"sigma_planes": sp, "sigma_lines": sl, "app_planes": ap,
            "app_lines": al, "basis": dense(3 * Rc, A),
            "mlp_w1": dense(in_dim, H), "mlp_b1": np.zeros(H, np.float32),
            "mlp_w2": dense(H, H), "mlp_b2": np.zeros(H, np.float32),
            "mlp_w3": dense(H, 3), "mlp_b3": np.zeros(3, np.float32)}


class Capture:
    """Records kernel inputs while the main path runs, without a host sync:
    the fused kernel's inputs of the scan step with the most hitting pairs
    (kept on the device by `torch.where`), the first largest gather call
    of each format, and the COO gather call numbered `coo_call` (counted
    from 0)."""

    def __init__(self, torch, ops, pipeline, coo_call):
        self.torch, self.ops, self.pipeline = torch, ops, pipeline
        self.orig = (ops.fused_sigma_app, ops.bitmap_gather, ops.coo_gather,
                     pipeline.compact_select)
        self.n_hit = None
        self.best = {}          # N -> {"hits", "pts", "base", "cid"}
        self.fused_static = None
        self.gathers = {}       # fmt -> (args, kwargs, nq)
        self.coo_call, self.coo_calls = coo_call, 0
        self.coo_at_call = None  # args of COO call number `coo_call`

    def __enter__(self):
        self.ops.fused_sigma_app = self.fused
        self.ops.bitmap_gather = self.gather("bitmap", self.orig[1])
        self.ops.coo_gather = self.gather("coo", self.orig[2])
        self.pipeline.compact_select = self.compact_select
        return self

    def __exit__(self, *exc):
        (self.ops.fused_sigma_app, self.ops.bitmap_gather,
         self.ops.coo_gather, self.pipeline.compact_select) = self.orig

    def compact_select(self, flat_hit, budget):
        self.n_hit = flat_hit.sum()
        return self.orig[3](flat_hit, budget)

    def fused(self, spec, streams, basis, pts, cube_base, cube_id, **kw):
        out = self.orig[0](spec, streams, basis, pts, cube_base, cube_id, **kw)
        torch = self.torch
        b = self.best.get(pts.shape[0])
        if b is None:
            b = self.best[pts.shape[0]] = {
                "hits": torch.full((), -1, dtype=torch.int64,
                                   device=pts.device),
                "pts": pts.clone(), "base": cube_base.clone(),
                "cid": cube_id.clone()}
        keep = self.n_hit > b["hits"]
        for k, v in (("pts", pts), ("base", cube_base), ("cid", cube_id)):
            b[k].copy_(torch.where(keep, v, b[k]))
        b["hits"] = torch.maximum(b["hits"], self.n_hit)
        self.fused_static = (spec, streams, basis,
                             {k: v for k, v in kw.items() if k != "force"})
        return out

    def gather(self, fmt, fn):
        def wrapped(*args, **kw):
            q = args[3] if fmt == "bitmap" else args[2]
            prev = self.gathers.get(fmt)
            if prev is None or q.shape[0] > prev[2]:
                self.gathers[fmt] = (args, kw, q.shape[0])
            if fmt == "coo":
                if self.coo_calls == self.coo_call:
                    self.coo_at_call = args
                self.coo_calls += 1
            return fn(*args, **kw)
        return wrapped

    def fused_inputs(self):
        best = max(self.best.values(), key=lambda b: int(b["hits"]))
        spec, streams, basis, kw = self.fused_static
        return (spec, streams, basis, best["pts"], best["base"],
                best["cid"]), kw, int(best["hits"])


def time_ms(torch, fn, iters: int) -> tuple:
    """(device ms, wall ms) per call of `fn`, both by CUDA events after a
    warm-up. Device ms replays `iters` calls captured into one CUDA graph,
    so the device runs them back to back with no host time between them;
    wall ms runs `iters` eager calls and includes any host time of the
    wrapper that the device waits on. The inputs stay warm in L2, as on
    the serving path, which re-reads the same streams every step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up before capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def per_call(run) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    wall = per_call(lambda: [fn() for _ in range(iters)])
    device = per_call(graph.replay)
    del graph
    return device, wall


def host_ms(torch, fn, iters: int = 50) -> float:
    """Host time per call of `fn` (perf_counter over `iters` eager calls
    after a warm-up, before the device is synchronised): what a caller's
    thread spends in the wrapper, whatever the device does."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def timing_keys(torch, kernel_fn, plain_fn, plain_iters: int = 10) -> dict:
    ms, wall = time_ms(torch, kernel_fn, 50)
    plain_ms, plain_wall = time_ms(torch, plain_fn, plain_iters)
    return {"ms": ms, "plain_ms": plain_ms, "wall_ms": wall,
            "plain_wall_ms": plain_wall}


def bound(nbytes: float, nops: float, peak_ops_s: float = PEAK_FP32_S
          ) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / peak_ops_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sass_count(lib: Path, nvcc: str, symbol: str, opcode: str) -> int:
    """Lines of `opcode` in the SASS of the functions whose mangled name
    holds `symbol`, by cuobjdump beside nvcc."""
    tool = Path(nvcc).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True)
    count, inside = 0, False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = symbol in line
        elif inside and opcode in line:
            count += 1
    return count


def cube_runs(cid) -> int:
    """Non-decreasing runs of cube ids in point order."""
    return 1 + int((cid[1:] < cid[:-1]).sum()) if cid.numel() else 0


def errors(torch, got, want) -> tuple:
    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    want = [w.float() for w in (want if isinstance(want, tuple) else (want,))]
    abs_err = max(float((g - w).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-6)).max())
                  if g.numel() else 0.0 for g, w in zip(got, want))
    return abs_err, rel_err


def over_limit(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 where
    `torch.allclose(got, want, rtol, atol)` holds."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def uniform_samples(torch, field, cfg, rendering, origins, dirs):
    """sigma (R, N) and rgb (R, N, 3) of the field at render_uniform's
    samples near + (k + 0.5) * step along each ray, 256 rays at a time."""
    n = cfg.max_samples_per_ray
    delta = rendering.step_world(cfg)
    t = cfg.near + (torch.arange(n, dtype=torch.float32,
                                 device=dirs.device) + 0.5) * delta
    sig, rgb = [], []
    for i in range(0, dirs.shape[0], 256):
        o, d = origins[i:i + 256], dirs[i:i + 256]
        pts = o[:, None] + d[:, None] * t[None, :, None]
        flat = pts.reshape(-1, 3)
        view = d[:, None].expand(pts.shape).reshape(-1, 3)
        sig.append(field.sigma(flat).reshape(-1, n))
        rgb.append(field.color(field.app_features(flat), view)
                   .reshape(-1, n, 3))
    return torch.cat(sig).contiguous(), torch.cat(rgb).contiguous()


def nproc_ok(torch, got, want, sigma, delta, term_eps) -> tuple:
    """nproc exact, or within NPROC_REL_TOL with no more differing samples
    than sit at term_eps (transmittance within 1e-4 relative of it), where
    the two summation orders may decide `alive` either way."""
    diff = abs(float(got) - float(want))
    tau = sigma * delta
    t_before = torch.exp(-(torch.cumsum(tau, dim=-1) - tau))
    at_eps = int(((t_before - term_eps).abs() <= 1e-4 * term_eps).sum())
    ok = diff == 0 or (diff <= NPROC_REL_TOL * float(want) and diff <= at_eps)
    return ok, diff, at_eps


class Deterministic:
    """`torch.use_deterministic_algorithms(True, warn_only=True)` inside
    the block: the renderer's `index_add_` scatters take PyTorch's
    deterministic path on CUDA (its default atomics need not repeat bit
    for bit), so two renders of one scene can be compared exactly."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import warnings
        t = self.torch
        self.prev = (t.are_deterministic_algorithms_enabled(),
                     t.is_deterministic_algorithms_warn_only_enabled())
        self.warn = warnings.catch_warnings()
        self.warn.__enter__()
        warnings.filterwarnings("ignore", message=".*determinis.*")
        t.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.prev[0],
                                                warn_only=self.prev[1])
        self.warn.__exit__(*exc)


def orbit_camera(m, angle: float, res: int, dev):
    """The serve phase's orbit (radius 4, elevation 0.5 rad), at `res`."""
    return m.rendering.look_at_camera(
        [4.0 * math.cos(angle) * math.cos(0.5),
         4.0 * math.sin(angle) * math.cos(0.5), 4.0 * math.sin(0.5)],
        [0.0, 0.0, 0.0], 1.2 * res, res, res, device=dev)


def launch_counts(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def zero_counts(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def host_state(m, field) -> dict:
    """A field's streams as host arrays (copies)."""
    _, arrays = m.field_lib.field_state(field)
    return {k: np.array(v) for k, v in arrays.items()}


def store_phase(torch, m, cfg, seed, dev, spill_dir, kernels) -> tuple:
    """Three full-width scenes under a budget of STORE_BUDGET scenes:
    register, spill, revive; every scene evicted and revived by a
    round-robin of one-chunk views. Returns (phase line, engine)."""
    import gc

    t_phase = time.perf_counter()

    def make(s):
        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in object_field(cfg, s).items()}
        return m.field_lib.DenseField(params, cfg).prune(tol=1e-3).encode()

    names = [f"s{i}" for i in range(STORE_SCENES)]
    zero_counts(kernels)
    f0 = make(seed)
    one = f0.factor_bytes()
    t0 = time.perf_counter()
    # a fixed pair budget: an adaptive resize changes the renderer's GEMM
    # shapes between renders, and with them the image's last bits
    eng = m.RenderEngine(cfg, f0, scene_name=names[0], device=dev,
                         max_resident_bytes=int(STORE_BUDGET * one),
                         spill_dir=spill_dir, adaptive_pair_budget=False)
    torch.cuda.synchronize()
    register_s = [time.perf_counter() - t0]
    del f0
    cam = orbit_camera(m, 0.3, STORE_RES, dev)
    store = eng.store

    def render(name):
        r = eng.submit(cam, scene=name).result(timeout=RESULT_TIMEOUT_S)
        check(r.stats["dispatch_path"] == "fused",
              f"store view of {name} took {r.stats['dispatch_path']}")
        return r.img

    # two renders of the resident scene, in each mode: is the card's
    # renderer repeatable bit for bit?
    with Deterministic(torch):
        img0 = render(names[0])
        repeat_det = max_diff(render(names[0]), img0)
    repeat_default = max_diff(render(names[0]), render(names[0]))
    before = host_state(m, store.get_field(names[0]))
    c = store.snapshot(names[0]).cubes
    cubes0 = [t.cpu() for t in (c.centers, c.valid, c.occ)] + [c.count]
    del c
    for i, name in enumerate(names[1:], start=1):
        f = make(seed + i)
        t0 = time.perf_counter()
        eng.register_scene(name, f)
        torch.cuda.synchronize()
        register_s.append(time.perf_counter() - t0)
        del f

    # one explicit eviction, with the card's allocated bytes around it
    victim = next(n for n in names if n in store.resident_scenes())
    victim_bytes = store.stats(victim)["factor_bytes"]
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store.evict(victim)
    spill_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()

    # a round of views: each scene revived, and each evicted once more
    revive_s, rr_latency = [], []
    for i in range(STORE_SCENES):
        name = names[i % STORE_SCENES]
        was_resident = name in store.resident_scenes()
        t0 = time.perf_counter()
        store.ensure_resident(name)
        torch.cuda.synchronize()
        if not was_resident:
            revive_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        render(name)
        rr_latency.append(time.perf_counter() - t0)

    # scene 0 revived once more: its streams, cubes and image as before
    if names[0] not in store.resident_scenes():
        t0 = time.perf_counter()
        store.ensure_resident(names[0])
        revive_s.append(time.perf_counter() - t0)
    after = host_state(m, store.get_field(names[0]))
    c = store.snapshot(names[0]).cubes
    cubes_equal = (all(torch.equal(a.cpu(), b) for a, b in zip(
        (c.centers, c.valid, c.occ), cubes0[:3])) and c.count == cubes0[3])
    del c
    streams_equal = (sorted(after) == sorted(before) and all(
        after[k].dtype == before[k].dtype
        and np.array_equal(after[k], before[k]) for k in before))
    with Deterministic(torch):
        revived_diff = max_diff(render(names[0]), img0)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    st = eng.stats()
    per = {n: {k: st["scenes"][n][k] for k in ("evictions", "revivals",
                                                "views_served")}
           for n in names}
    exact = repeat_det == 0.0
    line = {"phase": "store", "seconds": time.perf_counter() - t_phase,
            "scenes": STORE_SCENES, "res": STORE_RES,
            "factor_bytes": one, "max_resident_bytes": st[
                "max_resident_bytes"],
            "register_s": register_s, "spill_s": spill_s,
            "revive_s": revive_s, "round_robin_view_s": rr_latency,
            "evictions": st["evictions"], "revivals": st["revivals"],
            "per_scene": per, "resident_scenes": st["resident_scenes"],
            "resident_bytes": st["resident_bytes"],
            "evicted_scene": victim, "evicted_factor_bytes": victim_bytes,
            "memory_allocated_before_evict": mem_before,
            "memory_allocated_after_evict": mem_after,
            "streams_bitwise_equal": streams_equal,
            "cubes_equal": cubes_equal,
            "repeat_max_abs_diff": {"deterministic": repeat_det,
                                    "default": repeat_default},
            "revived_max_abs_diff": revived_diff,
            "image_match": "exact" if exact else
            "within the deterministic repeat difference",
            "launches": launches}
    check(mem_before - mem_after >= victim_bytes,
          f"evicting {victim} freed {mem_before - mem_after} bytes, less "
          f"than its {victim_bytes} factor bytes")
    check(streams_equal, "revived streams differ from the evicted ones")
    check(cubes_equal, "revived cube set differs")
    check(revived_diff <= repeat_det,
          f"revived image differs by {revived_diff} (repeat {repeat_det})")
    for n in names:
        check(per[n]["evictions"] >= 1 and per[n]["revivals"] >= 1,
              f"scene {n} was not evicted and revived: {per[n]}")
    check(launches["fused_sigma_app"] > 0, "no fused launch in the store "
          "phase")
    return line, eng


def delta_phase(torch, m, cfg, field, cubes, dev, kernels) -> dict:
    """A 3-frame orbit step of one-chunk frames through submit_delta
    (trajectory ordering), held against full renders of the same poses."""
    t_phase = time.perf_counter()
    eng = m.RenderEngine(cfg, field, cubes, order_mode="trajectory",
                         adaptive_pair_budget=False, device=dev)
    cams = [orbit_camera(m, 0.3 + DELTA_STEP * i, STORE_RES, dev)
            for i in range(3)]
    zero_counts(kernels)
    frames = []
    with Deterministic(torch):
        full0 = eng.submit(cams[0]).result(timeout=RESULT_TIMEOUT_S)
        prev = eng.submit_delta(cams[0], prev=None).result(
            timeout=RESULT_TIMEOUT_S)
        key_diff = max_diff(prev.img, full0.img)
        for cam in cams[1:]:
            t0 = time.perf_counter()
            d = eng.submit_delta(cam, prev=prev).result(
                timeout=RESULT_TIMEOUT_S)
            delta_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            full = eng.submit(cam).result(timeout=RESULT_TIMEOUT_S)
            full_s = time.perf_counter() - t0
            psnr = float(m.rendering.psnr(
                torch.from_numpy(d.img).clamp(0, 1),
                torch.from_numpy(full.img).clamp(0, 1)))
            n_pix = cam.h * cam.w
            frames.append({"warp_fraction": d.warp_fraction,
                           "fresh_rays": int(round((1 - d.warp_fraction)
                                                   * n_pix)),
                           "psnr_vs_full_db": psnr, "delta_s": delta_s,
                           "full_s": full_s,
                           "dispatch_path": d.stats["dispatch_path"]})
            prev = d
    torch.cuda.synchronize()
    st = eng.stats()["delta"]
    line = {"phase": "delta", "seconds": time.perf_counter() - t_phase,
            "res": STORE_RES, "step_rad": DELTA_STEP,
            "keyframe_max_abs_diff": key_diff, "frames": frames,
            "delta_stats": st, "stages": sorted(eng.stage_breakdown()),
            "launches": launch_counts(kernels)}
    check(key_diff == 0.0, f"keyframe differs from submit's image by "
          f"{key_diff}")
    check(0.0 < frames[0]["warp_fraction"] < 1.0,
          f"delta frame warp fraction {frames[0]['warp_fraction']}")
    check(frames[0]["psnr_vs_full_db"] >= DELTA_PSNR_DB,
          f"delta frame PSNR {frames[0]['psnr_vs_full_db']} dB")
    check(st["views"] == 2 and st["full_fallbacks"] == 0,
          f"delta stats {st}")
    check(all(f["dispatch_path"] == "fused" for f in frames),
          "delta frames left the fused path")
    return line


def auto_flush_phase(torch, m, eng, scenes, dev, kernels) -> dict:
    """AF_PRODUCERS threads submit AF_VIEWS views each across two scenes
    while the engine's flush thread renders; every future resolves
    through result(timeout=...), and close() joins the thread."""
    import threading

    t_phase = time.perf_counter()
    cam = orbit_camera(m, 1.1, AF_RES, dev)
    zero_counts(kernels)
    views0 = eng.stats()["views_served"]
    flushes0 = eng.stats()["flushes"]
    eng.start_auto_flush(AF_INTERVAL_S)
    futs, errors = [], []
    lock = threading.Lock()

    def producer(i):
        try:
            for j in range(AF_VIEWS):
                f = eng.submit(cam, scene=scenes[(i + j) % len(scenes)])
                with lock:
                    futs.append(f)
        except BaseException as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=producer, args=(i,))
               for i in range(AF_PRODUCERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(RESULT_TIMEOUT_S)
    hung = sum(t.is_alive() for t in threads)
    timeouts = 0
    results = []
    for f in futs:
        try:
            results.append(f.result(timeout=RESULT_TIMEOUT_S))
        except TimeoutError:
            timeouts += 1
    flusher = eng._flusher
    eng.close(timeout=RESULT_TIMEOUT_S)
    torch.cuda.synchronize()
    st = eng.stats()
    line = {"phase": "auto_flush", "seconds": time.perf_counter() - t_phase,
            "producers": AF_PRODUCERS, "views_each": AF_VIEWS,
            "scenes": list(scenes), "res": AF_RES,
            "interval_s": AF_INTERVAL_S,
            "views_served": st["views_served"] - views0,
            "flushes": st["flushes"] - flushes0, "timeouts": timeouts,
            "timed_out_results": sum(r.timed_out for r in results),
            "producer_errors": errors, "producers_hung": hung,
            "flusher_joined": not flusher.is_alive(),
            "launches": launch_counts(kernels)}
    check(not errors and not hung, f"producers: {errors}, {hung} hung")
    check(timeouts == 0 and len(results) == AF_PRODUCERS * AF_VIEWS,
          f"{timeouts} futures unresolved of {len(futs)}")
    check(line["views_served"] == AF_PRODUCERS * AF_VIEWS
          and line["timed_out_results"] == 0, f"auto-flush served "
          f"{line['views_served']} views")
    check(line["flusher_joined"], "close() left the flush thread running")
    check(not st["auto_flush_running"], "auto-flush still running")
    return line


def per_op_route_phase(torch, m, cfg, field, dev, kernels) -> dict:
    """A field whose fused window is past the sample kernel's shared
    memory (NeRFConfig(cube_size=PER_OP_CUBE_SIZE), max_cubes the whole
    cube grid: the same widths and streams, larger cubes) renders on the
    card through the per-op gather kernels, and matches the CPU's plain
    fused version."""
    t_phase = time.perf_counter()
    cfg_op = dataclasses.replace(cfg, cube_size=PER_OP_CUBE_SIZE,
                                 max_cubes=(cfg.occ_res
                                            // PER_OP_CUBE_SIZE) ** 3)
    W = m.tensorf.fused_window(cfg_op)
    smem = m.fused_sample.fused_smem_bytes(W, cfg.r_sigma, cfg.r_color)
    check(smem > m.fused_sample.MAX_SMEM_BYTES, f"window {W} fits ({smem})")
    card_field = m.field_lib.CompressedField(field.factors, field.extras,
                                             cfg_op, field.threshold)
    zero_counts(kernels)
    t0 = time.perf_counter()
    eng = m.RenderEngine(cfg_op, card_field, device=dev, ray_chunk=128)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    occ_launches = launch_counts(kernels)
    cam = m.rendering.look_at_camera([3.2, 2.0, 1.6], [0.0, 0.0, 0.0], 12.0,
                                     10, 10, device="cpu")
    zero_counts(kernels)
    t0 = time.perf_counter()
    got = eng.submit(cam).result(timeout=RESULT_TIMEOUT_S)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    cpu = field.to("cpu")
    cpu_field = m.field_lib.CompressedField(cpu.factors, cpu.extras, cfg_op,
                                            cpu.threshold)
    t0 = time.perf_counter()
    want = m.RenderEngine(cfg_op, cpu_field, eng.cubes, device="cpu",
                          ray_chunk=128).submit(cam).result()
    cpu_s = time.perf_counter() - t0
    err = max_diff(got.img, want.img)
    line = {"phase": "per_op_route", "seconds": time.perf_counter() - t_phase,
            "cube_size": PER_OP_CUBE_SIZE, "window": W, "smem_bytes": smem,
            "smem_limit": m.fused_sample.MAX_SMEM_BYTES,
            "cubes": eng.cubes.count, "res": 10,
            "dispatch_path": got.stats["dispatch_path"],
            "cpu_dispatch_path": want.stats["dispatch_path"],
            "engine_setup_s": setup_s, "card_view_s": card_s,
            "cpu_view_s": cpu_s, "max_abs_err": err, "tol": PARITY_TOL,
            "active_pairs_max": [got.stats["active_pairs_max"],
                                 want.stats["active_pairs_max"]],
            "occupancy_launches": occ_launches, "launches": launches}
    check(got.stats["dispatch_path"] == "per-op",
          f"oversized window took {got.stats['dispatch_path']}")
    check(launches["fused_sigma_app"] == 0, "fused kernel launched on the "
          "per-op route")
    check(launches["bitmap_gather"] > 0 and launches["coo_gather"] > 0,
          f"per-op route launches {launches}")
    check(got.stats["active_pairs_max"] > 0, "per-op view is empty")
    check(err <= PARITY_TOL, f"per-op card vs CPU image error {err}")
    return line


def geometry_phase(torch, m, cfg, field, cams, dev) -> dict:
    """Occupancy and camera rays built on the card and on the CPU for the
    serve phase's field and views: the grid, cube set and ray directions
    bit for bit, and the card's renders from either side's geometry with
    the same sample and pair counts."""
    t_phase = time.perf_counter()
    xs_equal = bool(torch.equal(m.occ_lib.grid_coords(cfg, dev).cpu(),
                                m.occ_lib.grid_coords(cfg, "cpu")))
    t0 = time.perf_counter()
    occ_card = m.occ_lib.build_occupancy(field, cfg)
    torch.cuda.synchronize()
    card_occ_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    occ_cpu = m.occ_lib.build_occupancy(field.to("cpu"), cfg)
    cpu_occ_s = time.perf_counter() - t0
    occ_equal = bool(torch.equal(occ_card.cpu(), occ_cpu))
    cubes_card = m.occ_lib.extract_cubes(occ_card, cfg)
    cubes_cpu = m.occ_lib.extract_cubes(occ_cpu, cfg)
    cams_cpu = [m.rendering.look_at_camera(
        c.origin.cpu().tolist(), [0.0, 0.0, 0.0], c.focal, c.h, c.w,
        device="cpu") for c in cams]
    dir_diff, origin_equal = 0.0, True
    for cg, cc in zip(cams, cams_cpu):
        (og, dg), (oc, dc) = (m.rendering.camera_rays(c) for c in (cg, cc))
        dir_diff = max(dir_diff, float((dg.cpu() - dc).abs().max()))
        origin_equal &= bool(torch.equal(og.cpu(), oc))
    kw = dict(device=dev, ray_chunk=GEO_RAY_CHUNK, max_batch_views=len(cams),
              pair_budget=GEO_PAIR_BUDGET, adaptive_pair_budget=False)
    t0 = time.perf_counter()
    by_card = m.RenderEngine(cfg, field, cubes_card, **kw).render_views(cams)
    by_cpu = m.RenderEngine(cfg, field, cubes_cpu, **kw).render_views(
        cams_cpu)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    views = [{k: (a.stats[k], b.stats[k]) for k in (
        "processed_samples", "active_pairs_max", "dropped_pairs")}
        for a, b in zip(by_card, by_cpu)]
    img_diff = max(max_diff(a.img, b.img) for a, b in zip(by_card, by_cpu))
    img_over = sum(int((np.abs(a.img - b.img).max(axis=-1) > 1e-4).sum())
                   for a, b in zip(by_card, by_cpu))
    line = {"phase": "geometry", "seconds": time.perf_counter() - t_phase,
            "grid_coords_equal": xs_equal, "occupancy_equal": occ_equal,
            "occupied_voxels": int(occ_card.sum()),
            "cubes": [cubes_card.count, cubes_cpu.count],
            "card_occupancy_s": card_occ_s, "cpu_occupancy_s": cpu_occ_s,
            "ray_origins_equal": origin_equal,
            "ray_direction_max_abs_diff": dir_diff,
            "ray_chunk": GEO_RAY_CHUNK, "render_s": render_s,
            "views": views, "image_max_abs_diff": img_diff,
            "pixels_over_1e-4": img_over}
    check(xs_equal, "grid coordinates differ between the card and the CPU")
    check(occ_equal, "occupancy grid differs between the card and the CPU")
    check(cubes_card.count == cubes_cpu.count and torch.equal(
        cubes_card.centers.cpu(), cubes_cpu.centers), "cube sets differ")
    check(origin_equal, "ray origins differ")
    check(dir_diff == 0.0, f"ray directions differ by {dir_diff}")
    for i, v in enumerate(views):
        for k in ("processed_samples", "active_pairs_max", "dropped_pairs"):
            check(v[k][0] == v[k][1], f"view {i} {k}: card geometry "
                  f"{v[k][0]}, CPU geometry {v[k][1]}")
    return line


class EvalCapture:
    """Wraps the dispatch of the field kernels while a render runs: the
    fused kernel's inputs at call number `fused_call` (cloned, no host
    sync), the largest bitmap and COO gather call (held, not copied),
    and, with `staged`, every COO launch counting its staged tiles into
    that device counter while `tiles` adds up its query tiles. Where the
    held call's output is differentiated, `grads[fmt]` is the gradient
    its backward kernel receives."""

    def __init__(self, ops, coo_gather, fused_call=None, staged=None):
        self.ops, self.coo_gather = ops, coo_gather
        self.orig = (ops.fused_sigma_app, ops.bitmap_gather, ops.coo_gather)
        self.fused_call, self.fused_calls, self.fused = fused_call, 0, None
        self.staged, self.tiles = staged, 0
        self.gathers = {}       # fmt -> (args, kwargs, nq)
        self.grads = {}         # fmt -> gradient of the held call's output

    def __enter__(self):
        self.ops.fused_sigma_app = self.fused_wrap
        self.ops.bitmap_gather = self.gather_wrap("bitmap", self.orig[1])
        self.ops.coo_gather = self.gather_wrap("coo", self.orig[2])
        return self

    def __exit__(self, *exc):
        (self.ops.fused_sigma_app, self.ops.bitmap_gather,
         self.ops.coo_gather) = self.orig

    def fused_wrap(self, *args, **kw):
        if self.fused_calls == self.fused_call:
            self.fused = (tuple(a.clone() if hasattr(a, "clone") else a
                                for a in args), kw)
        self.fused_calls += 1
        return self.orig[0](*args, **kw)

    def gather_wrap(self, fmt, fn):
        def wrapped(*args, **kw):
            q = args[3] if fmt == "bitmap" else args[2]
            prev = self.gathers.get(fmt)
            held = self.fused_call is None and (prev is None
                                                or q.shape[0] > prev[2])
            if held:
                self.gathers[fmt] = (args, kw, q.shape[0])
            if fmt == "coo" and self.staged is not None \
                    and kw.get("force") is None:
                self.tiles += self.coo_gather.coo_plan(q.shape[0]).blocks
                return self.coo_gather.coo_gather(*args,
                                                  staged=self.staged)
            out = fn(*args, **kw)
            if held and out.requires_grad:
                def keep(g):
                    if self.gathers[fmt][0] is args:
                        self.grads[fmt] = g
                out.register_hook(keep)
            return out
        return wrapped


def gt_compare(torch, rays, got, want) -> dict:
    """The ground truth's tie rule on (image, t, dist) from two devices:
    hit masks equal except at pixels whose final SDF lies within GT_TIE of
    the hit threshold on either side (at most GT_TIE_SHARE of the pixels),
    colours within GT_TOL on every pixel whose hit agrees."""
    (gi, gt_, gd), (wi, wt, wd) = ([x.cpu() for x in r] for r in (got, want))
    hit_g = (gd < rays.HIT_DIST) & (gt_ < rays.HIT_T_MAX)
    hit_w = (wd < rays.HIT_DIST) & (wt < rays.HIT_T_MAX)
    tie = (((gd - rays.HIT_DIST).abs() <= GT_TIE)
           | ((wd - rays.HIT_DIST).abs() <= GT_TIE))
    differ = hit_g != hit_w
    agree = ~differ
    col = float((gi[agree] - wi[agree]).abs().max()) if agree.any() else 0.0
    return {"pixels": int(differ.numel()), "hits": int(hit_w.sum()),
            "hit_flips": int(differ.sum()),
            "hit_flips_off_tie": int((differ & ~tie).sum()),
            "tie_pixels": int(tie.sum()),
            "max_abs_color_diff": col,
            "bitwise_equal": bool(torch.equal(gi, wi)),
            "tol": GT_TOL, "tie": GT_TIE, "max_flip_share": GT_TIE_SHARE}


def count_mismatch(name, got, want, where) -> None:
    """Fail on an exact count that differs, naming how many samples differ
    and where (`where()` locates them)."""
    if got != want:
        raise SystemExit(f"chip_smoke: FAILED: eval {name}: card {got}, CPU "
                         f"{want}: {abs(got - want)} samples differ; where: "
                         f"{where()}")


def eval_phase(torch, m, cfg, field, cubes, dev, kernels) -> tuple:
    """The evaluation path on the card at the paper's render_800 view: the
    ground truth of EVAL_SCENE, render_rtnerf (through eval_view, chunk
    EVAL_CHUNK, box, octant) and the uniform baseline (eval_view, 640,000
    rays x 512 samples in passes), each timed with CUDA synchronisation
    and with its launches counted; then each held against the port's own
    CPU path. Returns (phase line, captured kernel inputs)."""
    t_phase = time.perf_counter()
    cam = orbit_camera(m, EVAL_ANGLE, EVAL_RES, dev)
    scene = m.rays.make_scene(EVAL_SCENE)
    n_pix = EVAL_RES * EVAL_RES
    ns = m.pipeline.samples_per_segment(cfg)
    tile = m.pipeline.auto_tile(cfg, cam)
    steps = -(-cubes.count // EVAL_CHUNK)
    rays_per_pass = m.rendering.UNIFORM_PASS_SAMPLES // cfg.max_samples_per_ray
    passes = -(-n_pix // rays_per_pass)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    trace, gt_s = timed(lambda: m.rays.trace_gt(scene, cam))
    gt = trace[0]
    rt_kw = dict(pipeline="rtnerf", chunk=EVAL_CHUNK, intersect="box",
                 order_mode="octant")
    zero_counts(kernels)
    with EvalCapture(m.ops, m.coo_gather, fused_call=steps // 2) as cap_rt:
        (p_rt, st_rt, img_rt), rt_s = timed(lambda: m.train.eval_view(
            field, cfg, cubes, cam, gt, **rt_kw))
    launches_rt = launch_counts(kernels)

    staged = torch.zeros(1, dtype=torch.int32, device=dev)
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with EvalCapture(m.ops, m.coo_gather, staged=staged) as cap_uni:
        (p_uni, st_uni, img_uni), uni_s = timed(lambda: m.train.eval_view(
            field, cfg, cubes, cam, gt, pipeline="uniform"))
    peak = torch.cuda.max_memory_allocated()
    launches_uni = launch_counts(kernels)
    staged_share = int(staged.item()) / max(cap_uni.tiles, 1)

    occ_uni_exact = n_pix * cfg.max_samples_per_ray          # int64 count
    line = {"phase": "eval", "res": EVAL_RES, "focal": cam.focal,
            "tile": tile, "samples_per_segment": ns, "chunk": EVAL_CHUNK,
            "cubes": cubes.count, "scene": EVAL_SCENE,
            "ground_truth_s": gt_s, "rtnerf_s": rt_s, "uniform_s": uni_s,
            "rtnerf_scan_steps": steps, "uniform_passes": passes,
            "uniform_rays_per_pass": rays_per_pass,
            "launches": {"rtnerf": launches_rt, "uniform": launches_uni},
            "stats": {"rtnerf": st_rt, "uniform": st_uni},
            "occ_access_ratio_uniform_over_rtnerf":
                st_uni["occ_accesses"] / st_rt["occ_accesses"],
            "psnr_untrained_field_db": {"rtnerf": p_rt, "uniform": p_uni},
            "uniform_peak_memory_bytes": peak,
            "uniform_peak_memory_over_start_bytes": peak - mem0,
            "uniform_coo_staged_tile_share": staged_share,
            "uniform_coo_tiles": cap_uni.tiles}
    check(launches_rt["fused_sigma_app"] == steps
          and launches_rt["bitmap_gather"] == 0
          and launches_rt["coo_gather"] == 0,
          f"render_rtnerf launches {launches_rt}, not {steps} fused")
    check(launches_uni["fused_sigma_app"] == 0
          and launches_uni["bitmap_gather"] > 0
          and launches_uni["coo_gather"] > 0,
          f"render_uniform launches {launches_uni}")
    for name, img in (("rtnerf", img_rt), ("uniform", img_uni), ("gt", gt)):
        check(tuple(img.shape) == (n_pix, 3)
              and bool(torch.isfinite(img).all()), f"eval {name} image")
    check(st_rt["occ_accesses"] == cubes.count
          and st_rt["candidate_samples"] == cubes.count * tile * tile * ns,
          f"render_rtnerf stats {st_rt}")
    check(int(st_uni["occ_accesses"]) == occ_uni_exact
          and int(st_uni["candidate_samples"]) == occ_uni_exact,
          f"render_uniform occ_accesses {st_uni['occ_accesses']}, not "
          f"{occ_uni_exact}")
    check(0 < st_uni["processed_samples"] <= st_uni["preexisting_samples"]
          < occ_uni_exact, f"render_uniform stats {st_uni}")

    # -- parity against the port's own CPU path ---------------------------
    cpu_field = field.to("cpu")
    cpu_cubes = m.occ_lib.cubes_from_arrays(
        cubes.centers, cubes.valid, cubes.count, cubes.radius, cubes.occ,
        device="cpu")

    def on(c, device):
        return m.rendering.Camera(c.c2w.to(device), c.origin.to(device),
                                  c.focal, c.h, c.w)

    # render_rtnerf at EVAL_PARITY_RES: the same camera on both sides
    small = orbit_camera(m, EVAL_ANGLE, EVAL_PARITY_RES, "cpu")
    kw = {k: v for k, v in rt_kw.items() if k != "pipeline"}
    t0 = time.perf_counter()
    got_img, got = m.pipeline.render_rtnerf(field, cfg, cubes,
                                            on(small, dev), **kw)
    torch.cuda.synchronize()
    want_img, want = m.pipeline.render_rtnerf(cpu_field, cfg, cpu_cubes,
                                              small, **kw)
    rt_par_s = time.perf_counter() - t0
    rt_err = float((got_img.cpu() - want_img).abs().max())

    def rt_where():
        a = m.pipeline.rtnerf_scan(field, cfg, cubes, on(small, dev),
                                   per_pixel=True, **kw)[4].cpu()
        b = m.pipeline.rtnerf_scan(cpu_field, cfg, cpu_cubes, small,
                                   per_pixel=True, **kw)[4]
        ids = torch.nonzero(a != b).flatten()[:20].tolist()
        return {i: (int(a[i]), int(b[i])) for i in ids}
    for k in want:
        count_mismatch(f"render_rtnerf {k}", float(got[k]), float(want[k]),
                       rt_where)
    check(rt_err <= PARITY_TOL, f"render_rtnerf card vs CPU {rt_err}")
    check(float(want["processed_samples"]) > 0, "rtnerf parity view empty")

    # render_uniform on a strided subset of the view's rays, the same
    # rays on both sides
    o, d = m.rendering.camera_rays(cam)
    idx = torch.arange(0, n_pix, EVAL_UNIFORM_STRIDE, device=dev)
    o_s, d_s = o[idx].contiguous(), d[idx].contiguous()
    t0 = time.perf_counter()
    got_img, got = m.rendering.render_uniform(field, cfg, cubes, o_s, d_s)
    torch.cuda.synchronize()
    want_img, want = m.rendering.render_uniform(
        cpu_field, cfg, cpu_cubes, o_s.cpu(), d_s.cpu())
    uni_par_s = time.perf_counter() - t0
    uni_err = float((got_img.cpu() - want_img).abs().max())

    def uni_where():
        a = m.rendering.uniform_pass(field, cfg, cubes.occ, o_s, d_s)
        b = m.rendering.uniform_pass(cpu_field, cfg, cpu_cubes.occ,
                                     o_s.cpu(), d_s.cpu())
        out = {}
        for name, x, y in (("occupied", a[1], b[1]),
                           ("visible", a[2], b[2])):
            ids = torch.nonzero(x.cpu() != y).flatten()[:20].tolist()
            out[name] = {int(idx[i]): (int(x[i]), int(y[i])) for i in ids}
        return out
    for k in want:
        count_mismatch(f"render_uniform {k}", float(got[k]), float(want[k]),
                       uni_where)
    check(uni_err <= PARITY_TOL, f"render_uniform card vs CPU {uni_err}")

    # the ground truth at the full view on the CPU
    t0 = time.perf_counter()
    gt_cpu = m.rays.trace_gt(scene, on(cam, "cpu"))
    gt_par_s = time.perf_counter() - t0
    gt_cmp = gt_compare(torch, m.rays, trace, gt_cpu)
    check(gt_cmp["hit_flips_off_tie"] == 0
          and gt_cmp["hit_flips"] <= GT_TIE_SHARE * n_pix
          and gt_cmp["max_abs_color_diff"] <= GT_TOL,
          f"ground truth card vs CPU {gt_cmp}")
    line["parity"] = {
        "rtnerf": {"res": EVAL_PARITY_RES, "max_abs_err": rt_err,
                   "tol": PARITY_TOL, "counts_equal": True,
                   "processed_samples": float(want["processed_samples"]),
                   "seconds": rt_par_s},
        "uniform": {"rays": int(idx.numel()), "stride": EVAL_UNIFORM_STRIDE,
                    "max_abs_err": uni_err, "tol": PARITY_TOL,
                    "counts_equal": True,
                    "stats": {k: float(v) for k, v in want.items()},
                    "seconds": uni_par_s},
        "ground_truth": {**gt_cmp, "seconds": gt_par_s}}
    line["seconds"] = time.perf_counter() - t_phase
    del trace, gt, img_rt, img_uni, gt_cpu, cpu_field
    captured = {"fused": cap_rt.fused, "launches_rt": launches_rt,
                "launches_uni": launches_uni}
    check(captured["fused"] is not None, "no fused step captured")

    # one render_uniform pass (the middle one) with its gather calls held
    # for the kernels' eval timings
    i0 = (passes // 2) * rays_per_pass
    with EvalCapture(m.ops, m.coo_gather) as cap_pass:
        m.rendering.render_uniform(field, cfg, cubes,
                                   o[i0:i0 + rays_per_pass],
                                   d[i0:i0 + rays_per_pass])
    torch.cuda.synchronize()
    captured["gathers"] = cap_pass.gathers
    captured["pass_samples"] = rays_per_pass * cfg.max_samples_per_ray
    return line, captured


def eval_kernel_entries(torch, mods, captured, cfg) -> dict:
    """The `eval` sub-entry of kernel rows 1 to 3: the fused kernel at a
    render_rtnerf scan step of the 800 x 800 view, the two gathers at one
    render_uniform pass's appearance-plane call (its first
    EVAL_GATHER_ROWS rows); each checked against its plain version, timed
    as the rows are, with the rows' byte and operation models."""
    fused_sample, bitmap_decode, coo_gather = mods
    out = {}
    args, kw = captured["fused"]
    kw = {k: v for k, v in kw.items() if k != "force"}
    spec, streams, basis, pts, base, cid = args
    got = fused_sample.fused_sigma_app(*args, **kw)
    want = fused_sample.fused_sigma_app_ref(*args, **kw)
    torch.cuda.synchronize()
    ea, er = errors(torch, got, want)
    for g, w in zip(got, want):
        check(torch.allclose(g, w, rtol=FUSED_TOL, atol=FUSED_TOL),
              f"fused kernel vs plain at the eval step: abs {ea} rel {er}")
    del got, want
    N, C, W = pts.shape[0], base.shape[0], kw["window"]
    Rs, Rc, A = spec[0][1], spec[6][1], kw["app_dim"]
    R = Rs + Rc
    f_bytes = (nbytes(pts, cid, base, basis) + C * 3 * (W * W + W) * R * 4
               + N * 4 + N * A * 4)
    f_ops = N * (3 * (R * 11 + Rs + Rc * A * 2) + 40)
    b_ms, b_by = bound(f_bytes, f_ops)
    out["fused_sigma_app"] = {
        "path": "render_rtnerf scan step, 800 x 800, chunk 8",
        "launches_per_view": captured["launches_rt"]["fused_sigma_app"],
        "max_abs_err": ea, "max_rel_err": er, "tol": FUSED_TOL,
        **timing_keys(torch, lambda: fused_sample.fused_sigma_app(
            *args, **kw), lambda: fused_sample.fused_sigma_app_ref(
            *args, **kw), plain_iters=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": N, "C": C, "W": W, "R": R, "app_dim": A,
                  "cube_runs": cube_runs(cid)},
        "bytes": f_bytes, "ops": f_ops}

    S = captured["pass_samples"]
    for name, fmt in (("bitmap_gather", "bitmap"), ("coo_gather", "coo")):
        g = captured["gathers"].get(fmt)
        check(g is not None, f"no {fmt} gather captured in the uniform pass")
        out[name] = {"path": "render_uniform pass, appearance-plane call",
                     "launches_per_view": captured["launches_uni"][name],
                     **gather_call_entry(torch, mods, fmt, g, S, cfg)}
    return out


def gather_call_entry(torch, mods, fmt, call, samples, cfg) -> dict:
    """A forward gather kernel on a captured appearance-plane call of a
    render_uniform pass of `samples` samples (48 rows x 4 corners x
    samples queries), timed on its first EVAL_GATHER_ROWS rows (the plain
    version over the whole call would hold about 38 GB of int64
    temporaries); checked bit-exact against its plain version first."""
    _, bitmap_decode, coo_gather = mods
    fargs, fkw, nq = call
    rows = nq // (4 * samples)
    check(nq == rows * 4 * samples and rows == cfg.r_color,
          f"{fmt} call of {nq} queries is not an appearance plane's "
          f"({cfg.r_color} rows x 4 x {samples})")
    q_full = fargs[3] if fmt == "bitmap" else fargs[2]
    q = q_full[: EVAL_GATHER_ROWS * 4 * samples]
    entry = {"call_queries": nq, "call_rows": rows,
             "timed_rows": EVAL_GATHER_ROWS, "timed_queries": q.shape[0]}
    if fmt == "bitmap":
        words, rowptr, values = fargs[:3]
        cols, rank = fkw["cols"], fkw["rank"]

        def run_k():
            return bitmap_decode.bitmap_gather(words, rowptr, values, q,
                                               cols=cols, rank=rank)

        def run_p():
            return bitmap_decode.bitmap_gather_ref(words, rowptr, values, q,
                                                   cols, rank=rank)
        stream_bytes = nbytes(words, rowptr, values, rank)
        g_ops = q.shape[0] * 12
    else:
        coords, values = fargs[:2]

        def run_k():
            return coo_gather.coo_gather(coords, values, q)

        def run_p():
            return coo_gather.coo_gather_ref(coords, values, q)
        _, staged = coo_gather.coo_gather_staged(coords, values, q)
        win = coo_gather.tile_windows(coords, q)
        predicted = int((win <= coo_gather.CAPACITY).sum())
        check(staged == predicted, f"coo_gather staged {staged} tiles on "
              f"the appearance-plane call, the windows predict {predicted}")
        entry.update({"staged_tile_share": staged / win.shape[0],
                      "window_mean": float(win.double().mean()),
                      "window_max": int(win.max())})
        stream_bytes = nbytes(coords, values)
        g_ops = q.shape[0] * 4 * coo_gather.search_steps(coords.shape[0])
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{fmt} gather differs from plain on the "
          f"appearance-plane call")
    del got, want
    g_bytes = q.shape[0] * 8 + stream_bytes
    b_ms, b_by = bound(g_bytes, g_ops)
    entry.update({"max_abs_err": 0.0, "tol": 0.0,
                  **timing_keys(torch, run_k, run_p),
                  "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": None, "bytes": g_bytes, "ops": g_ops})
    return entry


def bwd_tol(torch, slot, hit, grad, nvalues) -> tuple:
    """(tolerance per value slot, queries per slot): two fp32 sums of the
    same k terms in different orders (the kernel's atomics, the plain
    version's index_add_) differ by at most about 2 k 2^-24 times the sum
    of the terms' magnitudes. Slots no query reads must be exactly 0."""
    w = torch.where(hit, 1.0, 0.0).double()
    k = torch.zeros(nvalues, dtype=torch.float64,
                    device=grad.device).index_add_(0, slot, w)
    a = torch.zeros(nvalues, dtype=torch.float64,
                    device=grad.device).index_add_(0, slot,
                                                   grad.abs().double() * w)
    return 2.0 * k * 2.0 ** -24 * a, k


def bwd_check(torch, name, what, got, want, slot, hit, grad, nvalues
              ) -> tuple:
    """(max |got - want|, largest excess over `bwd_tol`): fails if the
    kernel's sums leave the reordering bound or a slot no query reads is
    not 0."""
    tol, k = bwd_tol(torch, slot, hit, grad, nvalues)
    diff = (got.double() - want.double()).abs()
    over = float((diff - tol).max())
    unread = k == 0
    check(over <= 0.0, f"{name} differs from plain beyond the reordering "
          f"bound by {over} ({what})")
    check(bool((got[unread] == 0).all()) and bool((want[unread] == 0).all()),
          f"{name}: a value slot no query reads is not 0 ({what})")
    return float(diff.max()), over, k


def gather_bwd_row(torch, mods, fmt, call, samples, cfg, launches) -> dict:
    """The backward kernel of one gather on the training step's captured
    appearance-plane call (its first EVAL_GATHER_ROWS rows, as the
    forward entries): held against its plain version within `bwd_tol`,
    exact zeros where no query reads; timed as the forward rows are, with
    `index_add_` on the precomputed slots as the library call. The same
    on a shuffled copy of the call (queries and gradients permuted alike:
    no runs to merge), and a check on BWD_ONE_SLOT queries all on the
    call's first hit query, whose whole-number gradients must sum
    exactly as the plain version's (the reordering bound, at that
    contention, would pass a slot left 0). The bound counts the
    incoming gradient (4 bytes a query), the queries of nonzero gradient
    (4 bytes each: the kernel skips the rest), the stream's metadata and
    each value's read-modify-write (8 bytes)."""
    bitmap_decode, coo_gather = mods
    args, kw, nq = call
    rows = nq // (4 * samples)
    check(nq == rows * 4 * samples and rows == cfg.r_color,
          f"{fmt} backward call of {nq} queries is not an appearance "
          f"plane's")
    n = EVAL_GATHER_ROWS * 4 * samples
    if fmt == "bitmap":
        words, rowptr, q_full, g_full = args
        nvalues, cols, rank = kw["nvalues"], kw["cols"], kw["rank"]

        def run_k(q, g):
            return bitmap_decode.bitmap_gather_bwd(
                words, rowptr, q, g, nvalues=nvalues, cols=cols, rank=rank)

        def run_p(q, g):
            return bitmap_decode.bitmap_gather_bwd_ref(
                words, rowptr, q, g, nvalues, cols, rank=rank)

        def slots(q):
            return bitmap_decode.bitmap_slots(words, rowptr, nvalues, q,
                                              cols, rank)
        meta = nbytes(words, rowptr, rank)
        name, source = ("bitmap_gather_bwd",
                        "src/repro_torch/kernels/csrc/bitmap_gather.cu")
        replaces, oracle = ("src/repro/kernels/bitmap_decode.py:68",
                            "src/repro/kernels/ref.py:28")
    else:
        coords, q_full, g_full = args
        nvalues = coords.shape[0]

        def run_k(q, g):
            return coo_gather.coo_gather_bwd(coords, q, g)

        def run_p(q, g):
            return coo_gather.coo_gather_bwd_ref(coords, q, g)

        def slots(q):
            return coo_gather.coo_slots(coords, q)
        meta = nbytes(coords)
        name, source = ("coo_gather_bwd",
                        "src/repro_torch/kernels/csrc/coo_gather.cu")
        replaces, oracle = ("src/repro/kernels/coo_gather.py:40",
                            "src/repro/kernels/ref.py:41")
    q, g = q_full[:n], g_full[:n]
    slot, hit = slots(q)
    got, want = run_k(q, g), run_p(q, g)
    torch.cuda.synchronize()
    ea, over, k = bwd_check(torch, name, "the call", got, want, slot, hit,
                            g, nvalues)
    unread = k == 0
    vals = torch.where(hit, g, torch.zeros_like(g))

    def run_lib():
        return torch.zeros(nvalues, dtype=torch.float32,
                           device=g.device).index_add_(0, slot, vals)
    nz = int((g != 0).sum())
    b_bytes = 4 * n + 4 * nz + meta + 8 * nvalues
    b_ms, b_by = bound(b_bytes, 2 * nz)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           "replaces_note": f"the gradient of that kernel's function with "
                            f"respect to the values, which the reference "
                            f"takes by differentiating its jnp oracle "
                            f"({oracle}); no Pallas backward exists",
           "launches": launches, "max_abs_err": ea,
           "max_over_tol": over, "tol": "2 k 2^-24 sum|g| per slot",
           **timing_keys(torch, lambda: run_k(q, g), lambda: run_p(q, g)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, run_lib, 50)[0],
           "library_call": "torch.zeros(n).index_add_ on precomputed slots",
           "shape": {"Q": n, "call_queries": nq, "timed_rows":
                     EVAL_GATHER_ROWS, "nonzero_grad_queries": nz,
                     "hit_queries": int(hit.sum()), "values": nvalues,
                     "slots_read": int((~unread).sum()),
                     "max_queries_a_slot": int(k.max())},
           "bytes": b_bytes}
    if fmt == "coo":
        _, staged = coo_gather.coo_gather_bwd_staged(coords, q, g)
        predicted, live = coo_gather.bwd_search_counts(coords, q, g)
        check(staged == predicted, f"coo_gather_bwd searched {staged} warp "
              f"tiles in its staged ranges, the inputs predict {predicted}")
        row["staged_warp_tile_share"] = staged / max(live, 1)
        row["live_warp_tiles"] = live
    del got, want, slot, hit, vals, k, unread

    # a shuffled copy: the same sums, no runs of equal queries
    gen = torch.Generator(device=g.device)
    gen.manual_seed(BWD_SHUFFLE_SEED)
    perm = torch.randperm(n, device=g.device, generator=gen)
    qs, gs = q[perm].contiguous(), g[perm].contiguous()
    del perm
    slot, hit = slots(qs)
    got, want = run_k(qs, gs), run_p(qs, gs)
    torch.cuda.synchronize()
    ea_s, over_s, _ = bwd_check(torch, name, "shuffled", got, want, slot,
                                hit, gs, nvalues)
    del got, want, slot, hit
    shuffled = {"max_abs_err": ea_s, "max_over_tol": over_s,
                "ms": time_ms(torch, lambda: run_k(qs, gs), 50)[0]}
    if fmt == "coo":
        _, staged = coo_gather.coo_gather_bwd_staged(coords, qs, gs)
        predicted, live = coo_gather.bwd_search_counts(coords, qs, gs)
        check(staged == predicted, f"coo_gather_bwd searched {staged} "
              f"shuffled warp tiles in its staged ranges, the inputs "
              f"predict {predicted}")
        shuffled["staged_warp_tile_share"] = staged / max(live, 1)
    row["shuffled"] = shuffled
    del qs, gs

    # every query on one slot: the call's first hit query of nonzero
    # gradient, BWD_ONE_SLOT times, with whole-number gradients
    slot, hit = slots(q)
    first = int(torch.nonzero(hit & (g != 0))[0, 0])
    q1 = q[first].repeat(BWD_ONE_SLOT)
    gen = torch.Generator(device=g.device)
    gen.manual_seed(BWD_ONE_SLOT_SEED)
    g1 = torch.randint(-BWD_ONE_SLOT_GRAD, BWD_ONE_SLOT_GRAD + 1,
                       (BWD_ONE_SLOT,), device=g.device,
                       generator=gen).float()
    del slot, hit
    slot, hit = slots(q1)
    got, want = run_k(q1, g1), run_p(q1, g1)
    torch.cuda.synchronize()
    ea_1, over_1, k1 = bwd_check(torch, name, "one slot", got, want, slot,
                                 hit, g1, nvalues)
    check(int((k1 > 0).sum()) == 1, f"{name}: the one-slot case reads "
          f"{int((k1 > 0).sum())} slots")
    sum_abs = float(g1.abs().double().sum())
    check(sum_abs < 2.0 ** 24, f"{name}: the one-slot gradients' |g| sum "
          f"{sum_abs} leaves fp32's exact integers")
    check(bool(torch.equal(got, want)), f"{name}: the one-slot sum differs "
          f"from plain by {ea_1}, and whole numbers sum exactly")
    row["one_slot"] = {"queries": BWD_ONE_SLOT, "max_abs_err": ea_1,
                       "max_over_tol": over_1, "exact": True,
                       "slot_sum": float(want[k1 > 0].sum()),
                       "sum_abs_grad": sum_abs}
    del got, want, slot, hit, k1, q1, g1
    return row


def train_phase(torch, m, cfg, field, engine, dev, mods) -> tuple:
    """Training and fine-tuning on the card. (b) NerfTrainer resumed from
    the serve phase's encoded field, TRAIN_STEPS steps across a
    re-encode, every launch of the gathers' forward and backward kernels
    counted, and DENSE_STEPS steps of a fresh dense field; one extra
    step split into forward and backward, with its gather calls captured
    for (a) the kernels at the training shape; (c) one step's loss and
    gradients on the card against the CPU; (d) the trained field's cube
    set from final(), published to the serve engine and served; (e) a
    FineTuneLoop on the engine's store while the engine serves. Returns
    (phase line, forward train entries, backward rows)."""
    ops, bitmap_decode, coo_gather = mods
    t_phase = time.perf_counter()
    counted = {"bitmap_gather": bitmap_decode.bitmap_gather,
               "coo_gather": coo_gather.coo_gather,
               "bitmap_gather_bwd": bitmap_decode.bitmap_gather_bwd,
               "coo_gather_bwd": coo_gather.coo_gather_bwd}
    scene = m.rays.make_scene(TRAIN_SCENE)

    # -- (b) training on the card -----------------------------------------
    t0 = time.perf_counter()
    trainer = m.train.NerfTrainer(cfg, TRAIN_SCENE, field=field,
                                  n_views=TRAIN_VIEWS, image_hw=TRAIN_RES,
                                  occ_every=TRAIN_OCC_EVERY, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    formats = {"start": trainer.field.formats()}
    # the MLP and basis keep their shapes across a re-encode
    extras0 = {k: v.clone() for k, v in trainer.snapshot().trainable().items()
               if k.startswith("extras/")}
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    zero_counts(counted)
    t_train = time.perf_counter()
    for i in range(TRAIN_STEPS):
        reenc = i > 0 and i % TRAIN_OCC_EVERY == 0
        before = trainer.field.formats()
        t0 = time.perf_counter()
        rec = trainer.step()
        torch.cuda.synchronize()
        rec.update(ms=(time.perf_counter() - t0) * 1e3, reencode=reenc)
        steps.append(rec)
        if reenc:
            formats[f"step_{i}"] = {
                "before": before, "after": trainer.field.formats(),
                "nnz": {k: [ef.nnz for ef in efs]
                        for k, efs in trainer.field.factors.items()}}
    train_s = time.perf_counter() - t_train
    launches = launch_counts(counted)
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched while training")
    for rec in steps:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["psnr"]),
              f"training step {rec['step']}: {rec}")
    extras = trainer.snapshot().trainable()
    moved = {k: float((extras[k] - v).abs().max()) for k, v in extras0.items()}
    check(len(moved) > 0 and all(d > 0 for d in moved.values()),
          f"training left a trainable leaf unchanged: {moved}")
    del extras, extras0
    fmts = {f for fs in trainer.field.formats().values() for f in fs}
    check({"bitmap", "coo"} <= fmts, f"re-encoded formats {fmts}")
    plain = [r["ms"] for r in steps[1:] if not r["reencode"]]

    # one more step, split into forward and backward, its gather calls
    # captured (not counted: the launches above are the training run's)
    small = m.rays.build_dataset(scene, 2, TRAIN_RES, TRAIN_RES, device=dev)
    ro, rd, tgt = next(small.batches(cfg.train_rays, seed=1))
    f = trainer.snapshot()
    tv = {k: v.detach().requires_grad_(True)
          for k, v in f.trainable().items()}
    with EvalCapture(ops, coo_gather) as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = m.train.nerf_loss(f.with_trainable(tv), cfg, ro, rd, tgt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, list(tv.values()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    split_ms = {"forward": 1e3 * (t1 - t0), "backward": 1e3 * (t2 - t1)}
    del loss, tv, f

    # -- (a) the kernels at the training shape ------------------------------
    S = cfg.train_rays * cfg.max_samples_per_ray
    fwd_entries, bwd_rows = {}, []
    for name, fmt in (("bitmap_gather", "bitmap"), ("coo_gather", "coo")):
        check(fmt in cap.gathers and fmt in cap.grads,
              f"no {fmt} gather captured in the training step")
        args, kw, nq = cap.gathers[fmt]
        g = cap.grads[fmt].contiguous()
        vi = 2 if fmt == "bitmap" else 1       # the values, detached
        values = args[vi].detach()
        args = args[:vi] + (values,) + args[vi + 1:]
        # the backward kernel's call, as the autograd Function makes it
        if fmt == "bitmap":
            bwd_call = ((args[0], args[1], args[3], g),
                        {"nvalues": values.shape[0], "cols": kw["cols"],
                         "rank": kw["rank"]}, nq)
        else:
            bwd_call = ((args[0], args[2], g), {}, nq)
        fwd_entries[name] = {
            "path": "NerfTrainer step: render_uniform pass, appearance-"
                    "plane call", "launches": launches[name],
            "launches_per_step": launches[name] / TRAIN_STEPS,
            **gather_call_entry(torch, mods, fmt, (args, kw, nq), S, cfg)}
        bwd_rows.append(gather_bwd_row(
            torch, (bitmap_decode, coo_gather), fmt, bwd_call, S, cfg,
            launches[name + "_bwd"]))
        bwd_rows[-1]["launches_per_step"] = launches[name + "_bwd"] / \
            TRAIN_STEPS
    del cap

    # a fresh dense field: the field=None path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = m.train.NerfTrainer(cfg, TRAIN_SCENE, n_views=2,
                                image_hw=TRAIN_RES, compressed=False,
                                device=dev)
    dense_steps = []
    for _ in range(DENSE_STEPS):
        t1 = time.perf_counter()
        rec = dense.step()
        torch.cuda.synchronize()
        rec["ms"] = (time.perf_counter() - t1) * 1e3
        dense_steps.append(rec)
        check(math.isfinite(rec["loss"]), f"dense step {rec}")
    check(dense.field.kind == "dense", "the fresh field is not dense")
    dense_s = time.perf_counter() - t0
    del dense

    # -- (c) one step on the card against the CPU ----------------------------
    t0 = time.perf_counter()
    f_card = trainer.snapshot()
    ro, rd, tgt = next(small.batches(CPU_RAYS, seed=2))
    got = m.train.loss_and_grads(f_card, cfg, ro, rd, tgt)
    want = m.train.loss_and_grads(f_card.to("cpu"), cfg, ro.cpu(), rd.cpu(),
                                  tgt.cpu())
    loss_rel = abs(float(got[0]) - float(want[0])) / float(want[0])
    check(loss_rel <= LOSS_RTOL, f"card loss {float(got[0])} vs CPU "
          f"{float(want[0])}")
    check(got[2].keys() == want[2].keys(), "trainable leaves differ")
    grad_err = {}
    for k, w in want[2].items():
        scale = float(w.abs().max())
        err = float((got[2][k].cpu() - w).abs().max())
        grad_err[k] = err / scale if scale > 0 else err
        check(err <= GRAD_TOL * scale, f"gradient {k}: card vs CPU {err}, "
              f"{GRAD_TOL} x {scale} allowed")
    # the trainer's update from its own state on the card's gradients
    opt, state, tv = trainer.opt, trainer._opt_state, trainer._tvals
    new_card = opt.update(got[2], state, tv)[0]
    new_cpu = opt.update(
        {k: g.cpu() for k, g in got[2].items()},
        {"step": state["step"].cpu(),
         "m": {k: v.cpu() for k, v in state["m"].items()},
         "v": {k: v.cpu() for k, v in state["v"].items()}},
        {k: v.cpu() for k, v in tv.items()})[0]
    update_err = 0.0
    for k, w in new_cpu.items():
        c = new_card[k].cpu()
        over = (c - w).abs() - (UPDATE_RTOL * w.abs()
                                + UPDATE_ATOL_LR * cfg.lr_grid)
        check(float(over.max()) <= 0.0, f"adamw update of {k}: card vs "
              f"CPU beyond the tolerance by {float(over.max())}")
        check(not torch.equal(c, tv[k].cpu()) or not bool(got[2][k].any()),
              f"adamw left {k} unchanged though its gradient is not 0")
        update_err = max(update_err, float((c - w).abs().max()))
    cpu_s = time.perf_counter() - t0
    del got, want, f_card, new_card, new_cpu

    # -- (d) train, then serve -----------------------------------------------
    t0 = time.perf_counter()
    res = trainer.final()
    final_s = time.perf_counter() - t0
    cam = m.rays.make_cameras(TRAIN_VIEWS, TRAIN_RES, TRAIN_RES,
                              device=dev)[1]
    gt = m.rays.render_gt(scene, cam).cpu().numpy()

    def psnr(img):
        mse = float(np.mean((np.clip(img, 0, 1) - gt) ** 2))
        return -10.0 * math.log10(max(mse, 1e-10))
    before = engine.submit(cam).result(timeout=RESULT_TIMEOUT_S)
    engine.swap_field(res.field, res.cubes)
    t0 = time.perf_counter()
    after = engine.submit(cam).result(timeout=RESULT_TIMEOUT_S)
    serve_s = time.perf_counter() - t0
    check(after.img.shape == (TRAIN_RES * TRAIN_RES, 3)
          and bool(np.isfinite(after.img).all()), "trained view image")
    check(after.stats["dispatch_path"] == "fused",
          f"trained view took {after.stats['dispatch_path']}")
    check(res.cubes.count > 0, "the trained field has no cube")

    # -- (e) fine-tuning while the engine serves -------------------------------
    t0 = time.perf_counter()
    loop = m.FineTuneLoop.attach(
        engine.store, engine.default_scene, data_scene=TRAIN_SCENE,
        steps=FT_STEPS, publish_every=FT_PUBLISH, n_views=FT_VIEWS,
        image_hw=TRAIN_RES)
    small_cam = orbit_camera(m, 1.0, AF_RES, dev)
    zero_counts(counted)
    t_loop = time.perf_counter()
    loop.start()
    futs, windows = [], []
    while loop.running() and len(futs) < FT_MAX_REQUESTS:
        t_sub = time.perf_counter() - t_loop
        futs.append(engine.submit(small_cam))
        engine.flush()
        windows.append((t_sub, time.perf_counter() - t_loop))
    served = [fu.result(timeout=RESULT_TIMEOUT_S) for fu in futs]
    loop.join(timeout=RESULT_TIMEOUT_S)
    ft_launches = launch_counts(counted)
    ft_s = time.perf_counter() - t0
    # publications that landed while a view was queued or rendering (the
    # loop's t_wall counts from its start, a moment after t_loop)
    during = sum(any(a <= sw["t_wall"] <= b for a, b in windows)
                 for sw in loop.swaps)
    check(len(loop.history) == FT_STEPS
          and len(loop.swaps) == FT_STEPS // FT_PUBLISH,
          f"fine-tune history {len(loop.history)}, swaps {len(loop.swaps)}")
    check(len(served) > 0 and all(np.isfinite(r.img).all() for r in served),
          "views served during fine-tuning")
    check(during >= 1, f"no publication landed while a view was served "
          f"(swaps {loop.swaps}, views {windows})")
    check(ft_launches["bitmap_gather_bwd"] + ft_launches["coo_gather_bwd"]
          > 0, f"fine-tuning launched no backward kernel: {ft_launches}")

    line = {
        "phase": "train", "seconds": time.perf_counter() - t_phase,
        "scene": TRAIN_SCENE, "views": TRAIN_VIEWS, "res": TRAIN_RES,
        "train_rays": cfg.train_rays,
        "samples_per_step": cfg.train_rays * cfg.max_samples_per_ray,
        "occ_every": TRAIN_OCC_EVERY, "setup_s": setup_s,
        "train_s": train_s, "launches": launches,
        "step_ms_median": float(np.median(plain)),
        "step_ms_first": steps[0]["ms"],
        "reencode_step_ms": [r["ms"] for r in steps if r["reencode"]],
        "split_step_ms": split_ms,
        "peak_memory_bytes": peak,
        "peak_memory_over_start_bytes": peak - mem0,
        "steps": [{k: r[k] for k in ("step", "loss", "psnr", "ms",
                                     "reencode")} for r in steps],
        "formats": formats,
        "dense_fresh_init": {"steps": dense_steps, "seconds": dense_s},
        "card_vs_cpu": {"rays": CPU_RAYS, "loss_rel_err": loss_rel,
                        "loss_rtol": LOSS_RTOL,
                        "grad_err_over_leaf_max": grad_err,
                        "grad_tol": GRAD_TOL,
                        "update_max_abs_err": update_err,
                        "update_rtol": UPDATE_RTOL,
                        "update_atol": UPDATE_ATOL_LR * cfg.lr_grid,
                        "seconds": cpu_s},
        "extras_moved_max": moved,
        "served": {"final_s": final_s, "cubes": res.cubes.count,
                   "formats": res.field.formats(),
                   "psnr_before_db": psnr(before.img),
                   "psnr_after_db": psnr(after.img), "serve_s": serve_s,
                   "res": TRAIN_RES},
        "finetune": {"steps": FT_STEPS, "publish_every": FT_PUBLISH,
                     "swaps": loop.swaps, "history": loop.history,
                     "views_served": len(served),
                     "swaps_while_serving": during,
                     "launches": ft_launches,
                     "seconds": ft_s}}
    return line, fwd_entries, bwd_rows


def fleet_phase(torch, m, cfg, seed, dev, kernels, root) -> tuple:
    """The fleet tier on the card: the store phase's three scenes exported
    (`export_scene`: the occupancy built through the gather kernels),
    served by FLEET_WORKERS spawned worker processes (`FleetRouter`), each
    image held against the port's CPU path and reported beside the
    parent's in-process engine; a replicated scene; one worker against
    two on the same views; a SIGKILLed worker's requests replayed.
    Returns (phase line, {kernel name: fleet entry})."""
    import multiprocessing
    import os
    import signal

    t_phase = time.perf_counter()
    names = [f"s{i}" for i in range(STORE_SCENES)]
    ekw = {"ray_chunk": FLEET_RES * FLEET_RES, "adaptive_pair_budget": False}
    angles = 0.3 + 2 * math.pi * np.arange(FLEET_TIMED_VIEWS) / \
        FLEET_TIMED_VIEWS
    cams = [orbit_camera(m, a, FLEET_RES, dev) for a in angles]

    # export: the parent's launches are the gathers of the occupancy builds
    torch.cuda.synchronize()
    zero_counts(kernels)
    paths = {}
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in object_field(cfg, seed + i).items()}
        f = m.field_lib.DenseField(params, cfg).prune(tol=1e-3).encode()
        paths[name] = m.fleet.export_scene(os.path.join(root, name), f,
                                           cfg=cfg, scene=name)
        del f, params
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    export_launches = launch_counts(kernels)
    check(export_launches["bitmap_gather"] > 0
          and export_launches["coo_gather"] > 0,
          f"export built no occupancy through the gathers: {export_launches}")

    # each scene's view on the CPU path (strided rays) and on the parent's
    # card engine
    t0 = time.perf_counter()
    cpu_cam = orbit_camera(m, angles[0], FLEET_RES, "cpu")
    cpu_rays = np.arange(0, FLEET_RES * FLEET_RES, FLEET_CPU_STRIDE)
    ro, rd = (x[cpu_rays] for x in m.rendering.camera_rays(cpu_cam))
    cpu_render = m.pipeline.make_ray_renderer(cfg, pair_budget=CPU_PAIR_BUDGET)
    cpu_img, parent_img, cpu_pairs = {}, {}, {}
    for name in names:
        f, cubes = m.fleet.load_scene(paths[name], cfg, device="cpu")
        centers, valid = m.pipeline.OrderingCache(cubes).get_ordered(
            cpu_cam.origin)
        n_valid = int(valid.sum())
        check(bool(valid[:n_valid].all()),
              f"{name}: the ordering does not put its valid cubes first")
        n_scan = -(-n_valid // 8) * 8
        rgb, aux = cpu_render(f, centers[:n_scan], valid[:n_scan], ro, rd)
        cpu_img[name] = rgb.numpy()
        cpu_pairs[name] = int(aux["active_pairs_max"])
        check(int(aux["dropped_pairs"]) == 0 and f.dispatch_path()
              == "fused_ref", f"CPU path of {name}: {aux['dropped_pairs']} "
              f"pairs dropped, {f.dispatch_path()}")
        del f, cubes
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in names:
        f, cubes = m.fleet.load_scene(paths[name], cfg, device=dev)
        eng = m.RenderEngine(cfg, f, cubes, device=dev, **ekw)
        parent_img[name] = eng.submit(cams[0]).result(
            timeout=RESULT_TIMEOUT_S).img
        if name == names[0]:
            parent_repeat = max_diff(eng.submit(cams[0]).result(
                timeout=RESULT_TIMEOUT_S).img, parent_img[name])
        del eng, f, cubes
    parent_s = time.perf_counter() - t0

    def held(img, name, what):
        """An image's largest differences from the CPU path and from the
        parent's engine; the first must be within PARITY_TOL."""
        check(img is not None and img.shape == (FLEET_RES * FLEET_RES, 3)
              and bool(np.isfinite(img).all()), f"{what}: image")
        d_cpu = max_diff(img[cpu_rays], cpu_img[name])
        check(d_cpu <= PARITY_TOL, f"{what}: {d_cpu} from the CPU path")
        return {"max_abs_err_vs_cpu": d_cpu,
                "max_abs_diff_vs_parent": max_diff(img, parent_img[name])}

    def results(futs, what):
        out = [f.result(timeout=RESULT_TIMEOUT_S) for f in futs]
        for r in out:
            check(not r.timed_out, f"{what}: view {r.view_id} timed out")
        return out

    t_spawn = time.perf_counter()
    router = m.FleetRouter(cfg, paths, n_workers=FLEET_WORKERS,
                           engine_kwargs={"device": str(dev), **ekw})
    try:
        spawn_call_s = time.perf_counter() - t_spawn
        owners = {name: router.owner_of(name) for name in names}
        futs = [router.submit(cams[0], scene=name) for name in names]
        t_sent = time.perf_counter()
        first = results(futs, "first views")
        spawn_to_first_s = (t_sent - t_spawn
                            + min(r.latency_s for r in first))
        first_views = {r.scene: dict(held(r.img, r.scene, f"fleet {r.scene}"),
                                     worker=r.worker, latency_s=r.latency_s)
                       for r in first}
        check(all(first_views[n]["worker"] == owners[n] for n in names),
              f"scenes not served by their owners: {first_views} {owners}")

        # a hot scene on both workers: each replica serves the same image
        router.set_replicas(names[0], FLEET_WORKERS)
        replicas = router.replica_workers(names[0])
        check(len(replicas) == FLEET_WORKERS, f"replicas {replicas}")
        rep = results([router.submit(cams[0], scene=names[0],
                                     prefer_worker=w) for w in replicas],
                      "replicas")
        check([r.worker for r in rep] == replicas, "replica routing")
        replica_views = {r.worker: held(r.img, names[0],
                                        f"replica {r.worker}") for r in rep}
        replica_diff = max_diff(rep[0].img, rep[1].img)

        # the same views through one worker and across two
        timing = {}
        for label, prefer in (("one_worker", replicas[0]),
                              ("two_workers", None)):
            t0 = time.perf_counter()
            out = results([router.submit(c, scene=names[0],
                                         prefer_worker=prefer)
                           for c in cams], label)
            wall = time.perf_counter() - t0
            for r in out:
                check(r.img is not None and bool(np.isfinite(r.img).all()),
                      f"{label}: image")
            per = {}
            for r in out:
                per[r.worker] = per.get(r.worker, 0) + 1
            timing[label] = {"views": len(out), "wall_s": wall,
                             "views_per_s": len(out) / wall,
                             "views_by_worker": per,
                             "latency_s": [r.latency_s for r in out]}
        check(len(timing["two_workers"]["views_by_worker"]) == FLEET_WORKERS,
              f"the two-worker views used {timing['two_workers']}")

        # every worker on the card, through the fused kernel ("fused_ref",
        # its plain version, only in a rehearsal on the CPU)
        fused = "fused" if dev.type == "cuda" else "fused_ref"
        workers = router.stats()["workers"]
        check(sorted(workers) == sorted(replicas), f"workers {workers}")
        for w, ws in workers.items():
            check(ws["device"] == str(dev), f"worker {w} on {ws['device']}")
            check(set(ws["scene_dispatch_path"].values()) == {fused},
                  f"worker {w}: {ws['scene_dispatch_path']}")
            check(ws["launches"]["fused_sigma_app"] > 0,
                  f"worker {w} launched no fused kernel: {ws['launches']}")
        worker_launches = {w: ws["launches"] for w, ws in workers.items()}

        # SIGKILL a worker with views queued behind an injected stall
        victim = owners[names[0]]
        survivor = next(w for w in replicas if w != victim)
        router.inject(victim, stall_s=FLEET_STALL_S)
        live = [router.submit(cams[0], scene=names[0], prefer_worker=victim)
                for _ in range(FLEET_IN_FLIGHT)]
        expired = router.submit(cams[0], scene=names[0], deadline_s=0.01,
                                prefer_worker=victim)
        time.sleep(FLEET_KILL_AFTER_S)
        t_kill = time.perf_counter()
        os.kill(router.worker_pid(victim), signal.SIGKILL)
        replayed = results(live, "replayed views")
        replay_s = time.perf_counter() - t_kill
        rexp = expired.result(timeout=RESULT_TIMEOUT_S)
        for r in replayed:
            check(r.replayed and r.worker == survivor,
                  f"view {r.view_id}: worker {r.worker}, replayed "
                  f"{r.replayed}")
        replay_views = [held(r.img, names[0], "replayed view")
                        for r in replayed]
        check(rexp.timed_out and rexp.img is None,
              "the expired view was not answered timed out")
        after = router.stats()
        check(after["worker_deaths"] == 1 and after["replays_total"] >= 1
              and router.alive_workers() == [survivor],
              f"after the kill: deaths {after['worker_deaths']}, replays "
              f"{after['replays_total']}, alive {router.alive_workers()}")
        worker_launches[survivor] = after["workers"][survivor]["launches"]
        snap = router.registry.snapshot()
        families = {kind: {k: v for k, v in snap[kind].items()
                           if k.startswith("fleet_")}
                    for kind in ("counters", "gauges", "histograms")}
    finally:
        router.close()
    procs = [st.proc for st in router._workers.values()]
    check(not any(p.is_alive() for p in procs)
          and not multiprocessing.active_children(),
          "a worker process outlived close()")

    entries = {}
    for name in ("fused_sigma_app", "bitmap_gather", "coo_gather"):
        per = {w: int(lw[name]) for w, lw in worker_launches.items()}
        entries[name] = {"launches": sum(per.values()) + export_launches[
            name], "worker_launches": per,
            "export_launches": export_launches[name],
            "shape": {"rays_a_chunk": FLEET_RES * FLEET_RES,
                      "scenes": len(names)}}
    line = {"phase": "fleet", "seconds": time.perf_counter() - t_phase,
            "workers": FLEET_WORKERS, "res": FLEET_RES, "scenes": names,
            "owners": owners, "export_s": export_s,
            "export_launches": export_launches,
            "cpu_path_s": cpu_s, "cpu_rays": int(cpu_rays.size),
            "cpu_pair_budget": CPU_PAIR_BUDGET,
            "cpu_active_pairs_max": cpu_pairs,
            "parent_engine_s": parent_s,
            "parent_repeat_max_abs_diff": parent_repeat,
            "tol": PARITY_TOL, "spawn_call_s": spawn_call_s,
            "spawn_to_first_result_s": spawn_to_first_s,
            "first_views": first_views, "replicas": replicas,
            "replica_views": replica_views,
            "replica_max_abs_diff": replica_diff, "timing": timing,
            "speedup_two_over_one": (timing["two_workers"]["views_per_s"]
                                     / timing["one_worker"]["views_per_s"]),
            "worker_stats": {w: {k: ws[k] for k in (
                "device", "views_served", "fps", "scene_dispatch_path",
                "scene_views", "launches", "latency_p50_s")}
                for w, ws in workers.items()},
            "kill": {"victim": victim, "survivor": survivor,
                     "stall_s": FLEET_STALL_S, "in_flight": FLEET_IN_FLIGHT,
                     "replay_s": replay_s, "replayed_views": replay_views,
                     "expired_timed_out": rexp.timed_out,
                     "worker_deaths": after["worker_deaths"],
                     "replays_total": after["replays_total"],
                     "timeouts_total": after["timeouts_total"],
                     "routing_version": after["routing_version"]},
            "fleet_metrics": families}
    return line, entries


def launch_phase(torch, root) -> dict:
    """`python -m repro_torch.launch.serve --arch rtnerf` on the card, run
    twice as a user would on one checkpoint root: (1) trains each scene
    and checkpoints it, then serves; (2) restores and serves through the
    fleet (two workers, the hot scene on both), within LAUNCH_PSNR_DB of
    (1). Each run must exit 0 on the card's device. (The plain restore
    run is the mesh phase's, under torchrun.)"""
    import os
    import re

    t_phase = time.perf_counter()
    base = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_ARGS,
            "--ckpt-dir", os.path.join(root, "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    kind = torch.cuda.get_device_name(0)
    runs = []
    for label, extra in (("train", []), ("fleet", LAUNCH_FLEET_ARGS)):
        t0 = time.perf_counter()
        res = subprocess.run(base + extra, cwd=str(ROOT), env=env,
                             capture_output=True, text=True,
                             timeout=LAUNCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        out = res.stdout
        check(res.returncode == 0, f"launch run {label} exited "
              f"{res.returncode}:\n{out[-3000:]}\n{res.stderr[-3000:]}")
        psnr = {f"{s} view {i}": float(p) for s, i, p in re.findall(
            r"^(\w+) view (\d+): psnr=([-\d.]+)", out, re.M)}
        device = re.findall(r"^\[serve\] device: (.*)$", out, re.M)
        launches = [json.loads(x) for x in re.findall(
            r"^\[serve\] kernel launches: (.*)$", out, re.M)]
        summary = [ln for ln in out.splitlines()
                   if ln.startswith(("served ", "fleet: ", "  w"))]
        runs.append({"run": label, "args": base[3:] + extra,
                     "exit_code": res.returncode, "seconds": seconds,
                     "device": device, "psnr": psnr,
                     "restored": out.count("[engine] restoring scene"),
                     "trained": out.count("[engine] checkpointed field"),
                     "summary": summary,
                     "kernel_launches": launches[-1] if launches else None})
        check(device == [kind], f"launch run {label} printed device "
              f"{device}, not {kind}")
        check(len(psnr) == 4, f"launch run {label}: views {psnr}")
    train, fleet = runs
    check(train["trained"] == 2 and train["restored"] == 0,
          f"run 1 trained {train['trained']}")
    check(fleet["restored"] == 2 and fleet["trained"] == 0,
          f"run {fleet['run']} did not restore both scenes")
    diffs = {}
    for a, b in ((fleet, train),):
        check(sorted(a["psnr"]) == sorted(b["psnr"]), "views differ")
        d = max(abs(a["psnr"][k] - b["psnr"][k]) for k in a["psnr"])
        diffs[f"{a['run']}_vs_{b['run']}_db"] = d
        check(d <= LAUNCH_PSNR_DB, f"{a['run']} PSNRs {a['psnr']} against "
              f"{b['run']}'s {b['psnr']}")
    check(any("device=cuda" in ln for ln in fleet["summary"]),
          f"fleet workers not on cuda: {fleet['summary']}")
    for r in runs:
        k = r["kernel_launches"]
        check(k is not None and k["bitmap_gather"] + k["coo_gather"] > 0,
              f"run {r['run']} built no occupancy through the gathers: {k}")
    check(train["kernel_launches"]["fused_sigma_app"] > 0,
          f"run {train['run']} launched no fused kernel")
    return {"phase": "launch", "seconds": time.perf_counter() - t_phase,
            "runs": runs, "psnr_max_diff": diffs, "tol_db": LAUNCH_PSNR_DB}


def mesh_cams(m, dev):
    return [orbit_camera(m, a, MESH_RES, dev) for a in
            2 * math.pi * (np.arange(MESH_VIEWS) + 0.125) / MESH_VIEWS]


def mesh_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_render(torch, engine, cams) -> tuple:
    """The views one flush a view: (results, seconds of the last view,
    ended by a synchronise)."""
    results, seconds = [], 0.0
    for cam in cams:
        mesh_sync(torch, engine.device)
        t0 = time.perf_counter()
        fut = engine.submit(cam)
        engine.flush()
        results.append(fut.result())
        mesh_sync(torch, engine.device)
        seconds = time.perf_counter() - t0
    return results, seconds


def mesh_probe(torch, dist, dev, path: str) -> dict:
    """Each collective on small CUDA tensors, in MESH_PROBES order: "ok",
    or what the backend raised; the record is rewritten to `path` after
    each, so a collective that kills the process leaves the ones before
    it."""
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device=dev)

    def send_recv():
        peer = 1 - rank
        ops = [dist.P2POp(dist.isend, x.clone(), peer),
               dist.P2POp(dist.irecv, torch.empty_like(x), peer)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty((4 * world,)), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty((4 // world,)), x),
        "reduce": lambda: dist.reduce(x.clone(), dst=0),
        "gather": lambda: dist.gather(
            x, [torch.empty_like(x) for _ in range(world)] if rank == 0
            else None, dst=0),
        "scatter": lambda: dist.scatter(
            torch.empty_like(x), [x.clone() for _ in range(world)]
            if rank == 0 else None, src=0),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "send_recv": send_recv,
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name in MESH_PROBES:
        try:
            calls[name]()
            mesh_sync(torch, dev)
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        with open(path, "w") as f:
            json.dump(out, f)
    return out


def mesh_collective_ms(torch, dist, tdist, rules, n_rays: int, dev) -> dict:
    """ms of the engine's two collectives a chunk, each over
    MESH_COLLECTIVE_REPEATS calls ended by a synchronise: the pixel
    gather (`distributed.gather_rays`, an all-gather into n_rays x 5
    float32 in the data group) and the counters' all-reduce; a one-rank
    group times an all-reduce of the same bytes on the world group (NCCL,
    one rank)."""
    parts = rules.mesh.shape["data"]
    px = torch.rand((n_rays // parts, 5), device=dev)
    counts = torch.zeros((2 + 1024,), dtype=torch.float64, device=dev)
    if parts > 1:
        fns = {"gather_ms": lambda: tdist.gather_rays(rules, px, n_rays),
               "counts_ms": lambda: tdist.reduce_counts(rules, counts,
                                                        n_rays)}
    else:
        full = torch.rand((n_rays, 5), device=dev)
        fns = {"all_reduce_ms": lambda: dist.all_reduce(full),
               "counts_ms": lambda: dist.all_reduce(counts)}
    out = {}
    for name, fn in fns.items():
        fn()
        mesh_sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(MESH_COLLECTIVE_REPEATS):
            fn()
        mesh_sync(torch, dev)
        out[name] = (time.perf_counter() - t0) / MESH_COLLECTIVE_REPEATS * 1e3
    return out


def mesh_probe_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One rank of the gloo probe (a spawned process on `device`): writes
    rank<r>.json as it goes. It leaves without a last collective: one
    that the backend refused may have closed the connection (its exit
    code is part of the record)."""
    import os
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    dev = init_ranks(device, backend="gloo",
                     init_method="file://" + os.path.join(tmp, "init"),
                     rank=rank, world_size=world,
                     timeout_s=MESH_PROBE_TIMEOUT_S)
    mesh_probe(torch, dist, dev, os.path.join(tmp, f"rank{rank}.json"))
    dist.destroy_process_group()


def mesh_rank(rank: int, world: int, backend: str, tmp: str, device: str,
              cfg_fields: dict) -> None:
    """One rank of the mesh phase (a spawned process) on `device`, at the
    parent's config: writes rank<r>.npz (the images) and rank<r>.json, or
    rank<r>.err."""
    import os
    import traceback
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        from repro_torch.ckpt import checkpoint as ckpt_lib
        from repro_torch.configs.rtnerf import NeRFConfig
        from repro_torch.core import distributed as tdist
        from repro_torch.core import pipeline, rendering
        from repro_torch.kernels import bitmap_decode, coo_gather, fused_sample
        from repro_torch.launch import pipeline as gpipe_lib
        from repro_torch.launch.mesh import (init_ranks, make_host_mesh,
                                             make_pipeline_mesh)
        from repro_torch.models.sharding import make_rules
        from repro_torch.serving import RenderEngine

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        t_start = time.perf_counter()
        dev = init_ranks(device, backend=backend,
                         init_method="file://" + os.path.join(tmp, "init"),
                         rank=rank, world_size=world,
                         timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
        m = types.SimpleNamespace(rendering=rendering)
        cfg = NeRFConfig(**cfg_fields)
        cams = mesh_cams(m, dev)
        kernels = {"fused_sigma_app": fused_sample.fused_sigma_app,
                   "bitmap_gather": bitmap_decode.bitmap_gather,
                   "coo_gather": coo_gather.coo_gather}
        field, _ = ckpt_lib.restore_field(os.path.join(tmp, "field"), 0, cfg,
                                          device=dev)
        mesh = make_host_mesh(dev)
        mesh_sync(torch, dev)
        # -- the main path: counts from 0, the engine built (occupancy
        # through the gathers) and the views rendered --------------------
        zero_counts(kernels)
        t0 = time.perf_counter()
        engine = RenderEngine(cfg, field, mesh=mesh, ray_chunk=MESH_RES ** 2,
                              pair_budget=MESH_PAIR_BUDGET,
                              adaptive_pair_budget=False,
                              trace_requests=False)
        mesh_sync(torch, dev)
        setup_s = time.perf_counter() - t0
        results, view_s = mesh_render(torch, engine, cams)
        launches = launch_counts(kernels)
        st = engine.stats()
        line = {"rank": rank, "world": world, "backend": backend,
                "device": str(dev), "n_devices": st["n_devices"],
                "engine_setup_s": setup_s, "view_ms": view_s * 1e3,
                "views_per_s": 1.0 / view_s, "cubes": engine.cubes.count,
                "launches": launches,
                "fused_points_per_call": MESH_PAIR_BUDGET
                * pipeline.samples_per_segment(cfg),
                "rays_per_rank": MESH_RES ** 2 // world,
                "dropped_pairs": st["dropped_pairs"],
                "pair_budget": st["pair_budget"],
                "counters": [{k: r.stats[k] for k in (
                    "active_pairs_max", "dropped_pairs",
                    "processed_samples", "dispatch_path")}
                    for r in results]}
        line["collectives"] = mesh_collective_ms(
            torch, dist, tdist, make_rules(mesh), MESH_RES ** 2, dev)
        if world == 1:
            # gpipe at one stage: the pipeline mesh of the one rank
            rng = np.random.default_rng(0)
            params = {k: torch.from_numpy(
                (rng.standard_normal(s) * 0.1).astype(np.float32)).to(dev)
                for k, s in (("w1", (8, 16, 32)), ("w2", (8, 32, 16)))}
            x = torch.from_numpy(rng.standard_normal((6, 4, 16)).astype(
                np.float32)).to(dev)
            y = gpipe_lib.gpipe(gpipe_lib.mlp_stage, make_pipeline_mesh(
                stages=1, data=1, model=1, device=dev))(params, x)
            want = gpipe_lib.reference_apply(params, x)
            line["gpipe_max_abs_err"] = float((y - want).abs().max())
        # no rank tears its connections down under another's last
        # collective (gloo's barrier would use a CUDA tensor here: a CPU
        # all-reduce instead)
        if backend == "nccl":
            dist.barrier()
        else:
            dist.all_reduce(torch.zeros(1))
        dist.destroy_process_group()
        line["seconds"] = time.perf_counter() - t_start
        np.savez(os.path.join(tmp, f"rank{rank}.npz"),
                 **{f"img{i}": r.img for i, r in enumerate(results)},
                 **{f"depth{i}": r.depth for i, r in enumerate(results)})
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(line, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def mesh_spawn(target, world: int, args: tuple, limit_s: float) -> list:
    """`target(rank, world, *args)` in `world` processes started with the
    spawn method, joined within `limit_s` (what is left is killed);
    returns their exit codes."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(t0 + limit_s - time.perf_counter(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def mesh_world(backend: str, world: int, tmp: str, device: str,
               cfg_fields: dict) -> list:
    """The ranks of one world (`mesh_rank`): their lines and images."""
    import os
    t0 = time.perf_counter()
    codes = mesh_spawn(mesh_rank, world, (backend, tmp, device, cfg_fields),
                       MESH_TIMEOUT_S)
    errors = []
    for r, code in enumerate(codes):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()[-3000:]}")
        elif code != 0:
            errors.append(f"rank {r}: exit code {code}")
    check(not errors, f"mesh world {backend} x {world}:\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            line = json.load(f)
        line["world_seconds"] = time.perf_counter() - t0
        out.append((line, dict(np.load(os.path.join(tmp, f"rank{r}.npz")))))
    return out


def mesh_probe_world(world: int, tmp: str, device: str) -> dict:
    """The gloo probe in `world` ranks (`mesh_probe_rank`): each rank's
    record and exit code (a finding, not a check: what gloo refuses is
    reported)."""
    import os
    codes = mesh_spawn(mesh_probe_rank, world, (tmp, device),
                       MESH_PROBE_TIMEOUT_S * len(MESH_PROBES) + 30)
    out = {}
    for r, code in enumerate(codes):
        path = os.path.join(tmp, f"rank{r}.json")
        ops = {}
        if os.path.exists(path):
            with open(path) as f:
                ops = json.load(f)
        out[f"rank{r}"] = {"exit_code": code, "ops": ops}
    return out


def mesh_phase(torch, m, cfg, field, dev, root, train_psnr) -> tuple:
    """RenderEngine(mesh=) across ranks against the single-process engine
    on the card, gpipe at one stage, the gloo probe on CUDA tensors, and
    the serving launcher under torchrun. Returns (phase line, per kernel
    {"launches_per_rank": {world: [...]}})."""
    import os
    import re
    t_phase = time.perf_counter()
    cams = mesh_cams(m, dev)
    single = m.RenderEngine(cfg, field, device=dev, ray_chunk=MESH_RES ** 2,
                            pair_budget=MESH_PAIR_BUDGET,
                            adaptive_pair_budget=False, trace_requests=False)
    want, want_s = mesh_render(torch, single, cams)
    cubes = single.cubes.count
    del single
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        m.ckpt.save_field(os.path.join(tmp, "field"), 0, field)
        worlds = {}
        for backend, world in MESH_WORLDS:
            wdir = os.path.join(tmp, f"{backend}{world}")
            os.makedirs(wdir)
            os.symlink(os.path.join(tmp, "field"), os.path.join(wdir, "field"))
            worlds[f"{backend}x{world}"] = mesh_world(
                backend, world, wdir, str(dev), dataclasses.asdict(cfg))
        probe_dir = os.path.join(tmp, "probe")
        os.makedirs(probe_dir)
        probe = mesh_probe_world(2, probe_dir, str(dev))
    ranks, entries = {}, {}
    for key, res in worlds.items():
        ranks[key] = []
        for line, imgs in res:
            errs = [max_diff(imgs[f"img{i}"], w.img) for i, w in
                    enumerate(want)]
            line["max_abs_err"] = max(errs)
            ranks[key].append(line)
            world = line["world"]
            check(line["n_devices"] == world, f"{key}: n_devices "
                  f"{line['n_devices']}")
            check(line["cubes"] == cubes, f"{key}: {line['cubes']} cubes, "
                  f"the single-process engine {cubes}")
            check(max(errs) <= PARITY_TOL, f"{key} rank {line['rank']}: "
                  f"image error {errs} against the single-process engine")
            for got, w in zip(line["counters"], want):
                for k in ("active_pairs_max", "dropped_pairs",
                          "processed_samples"):
                    check(got[k] == w.stats[k], f"{key}: {k} {got[k]} "
                          f"against {w.stats[k]}")
                check(got["dispatch_path"] == "fused", f"{key}: "
                      f"{got['dispatch_path']}")
            check(line["dropped_pairs"] == 0, f"{key} dropped pairs")
            for name, n in line["launches"].items():
                check(n > 0, f"{key} rank {line['rank']}: {name} was not "
                      f"launched")
                entries.setdefault(name, {}).setdefault(
                    key, []).append(n)
        if world == 1:
            check(res[0][0]["gpipe_max_abs_err"] <= 1e-5,
                  f"gpipe at one stage: {res[0][0]['gpipe_max_abs_err']}")
    args = ["--standalone", "--nproc-per-node", "1", "-m",
            "repro_torch.launch.serve", *LAUNCH_ARGS, *MESH_LAUNCH_ARGS,
            "--ckpt-dir", os.path.join(root, "ckpt")]
    out, seconds = run_launcher(torch, "torch.distributed.run", args)
    psnr = {f"{s} view {i}": float(p) for s, i, p in re.findall(
        r"^(\w+) view (\d+): psnr=([-\d.]+)", out, re.M)}
    launches = [json.loads(x) for x in re.findall(
        r"^\[serve\] kernel launches: (.*)$", out, re.M)]
    check(len(psnr) == 2 and out.count("[engine] restoring scene") == 1,
          f"torchrun launcher output:\n{out[-3000:]}")
    diff = max(abs(p - train_psnr[k]) for k, p in psnr.items())
    check(diff <= LAUNCH_PSNR_DB, f"torchrun launcher PSNRs {psnr} against "
          f"the launch phase's {train_psnr}")
    check(launches and launches[-1]["fused_sigma_app"] > 0,
          f"torchrun launcher launched no fused kernel: {launches}")
    line = {"phase": "mesh", "seconds": time.perf_counter() - t_phase,
            "views": MESH_VIEWS, "res": MESH_RES,
            "pair_budget": MESH_PAIR_BUDGET, "tol": PARITY_TOL,
            "single_process": {"view_ms": want_s * 1e3,
                               "views_per_s": 1.0 / want_s,
                               "cubes": cubes},
            "ranks": ranks, "gloo_on_cuda": probe,
            "launcher": {"args": args, "seconds": seconds, "psnr": psnr,
                         "psnr_max_diff_db": diff,
                         "kernel_launches": launches[-1]}}
    return line, {name: {"launches_per_rank": v}
                  for name, v in entries.items()}


def lm_serve(torch, lm, cfg, params, tokens, frontend, n_decode, dev,
             teacher=None, times=None, enc_frames=None):
    """Prefill `tokens` (and the stub frontend, or the encoder frames of
    an enc-dec arch), grow the cache to the horizon, then `n_decode`
    decode steps of greedy tokens, or of `teacher`'s columns where given.
    Returns (the logits of every step as one (B, 1 + n_decode, Vp)
    tensor, the fed tokens (B, n_decode)). With a `times` dict on the
    card, records the seconds of the prefill (cache growth included) and
    of the decode loop, each ended by a synchronise."""
    rules = lm.sharding.make_rules(lm.mesh.make_host_mesh(dev))
    B, P = tokens.shape
    nf = frontend.shape[1] if frontend is not None else 0
    total = nf + P + n_decode + 1
    prefill = lm.steps.build_prefill_step(cfg, rules)
    decode = lm.steps.build_decode_step(cfg, rules, total)
    batch = {"tokens": tokens.to(dev)}
    if frontend is not None:
        batch["frontend"] = frontend.to(dev)
    if enc_frames is not None:
        batch["enc_frames"] = enc_frames.to(dev)
    if times is not None:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    shapes, _ = lm.tf.serve_cache_spec(
        cfg, B, total, enc_len=0 if enc_frames is None else
        enc_frames.shape[1])
    cache = lm.tf.grow_cache(cache, shapes)
    if times is not None:
        torch.cuda.synchronize()
        times["prefill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, fed = [logits], []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for i in range(n_decode):
        if teacher is not None:
            tok = teacher[:, i:i + 1].to(dev)
        fed.append(tok)
        logits, cache = decode(params, tok, nf + P + i, cache)
        out.append(logits)
        tok = torch.argmax(logits, dim=-1)
    if times is not None:
        torch.cuda.synchronize()
        times["decode_s"] = time.perf_counter() - t0
    return torch.cat(out, dim=1), torch.cat(fed, dim=1)


def lm_forward_logits(torch, lm, cfg, params, tokens, frontend,
                      enc_frames=None):
    """Every position's logits through the training trunk (no cache; the
    encoder first for an enc-dec arch)."""
    batch = {"tokens": tokens}
    if frontend is not None:
        batch["frontend"] = frontend
    with torch.no_grad():
        memory = (None if enc_frames is None
                  else lm.tf._encode(params, cfg, enc_frames))
        x, pos = lm.tf._assemble_input(params, cfg, batch)
        h, _, _ = lm.tf._trunk(params, cfg, x, pos, memory=memory)
        return lm.tf._logits(params, cfg, h)


def lm_card_vs_cpu(torch, lm, cfg, dtype, seed, dev) -> dict:
    """One model's params drawn on the CPU and copied to the card; the
    same prompt (and frontend, or encoder frames) served on both for
    LM_SMALL's decode steps, teacher-forced with the same tokens; every
    step's logits compared. In float32 also greedily, with the same
    tokens out of both."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(seed)
    params, _ = lm.common.split_pl(lm.tf.init_model(cfg, gen, dtype=tdt,
                                                    device="cpu"))
    B, P, G = LM_SMALL["batch"], LM_SMALL["prompt"], LM_SMALL["gen"]
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen)
    teacher = torch.randint(0, cfg.vocab, (B, G - 1), generator=gen)
    frontend = frames = None
    if cfg.frontend == "vision":
        frontend = torch.randn(B, cfg.n_frontend_tokens, cfg.d_model,
                               generator=gen).to(torch.bfloat16)
    if cfg.enc_dec:
        frames = torch.randn(B, P, cfg.d_model, generator=gen).to(
            torch.bfloat16)
    cpu = torch.device("cpu")
    want, _ = lm_serve(torch, lm, cfg, params, tokens, frontend, G - 1,
                       cpu, teacher, enc_frames=frames)
    greedy = truth = None
    if dtype == "float32":
        _, want_tok = lm_serve(torch, lm, cfg, params, tokens, frontend,
                               G - 1, cpu, enc_frames=frames)
    elif cfg.family in LM_RECURRENT:
        truth, _ = lm_serve(torch, lm, cfg, lm.common.tree_map(
            lambda a: a.float(), params), tokens, frontend, G - 1, cpu,
            teacher, enc_frames=frames)
    params = lm.common.tree_map(lambda a: a.to(dev), params)
    got, _ = lm_serve(torch, lm, cfg, params, tokens, frontend, G - 1, dev,
                      teacher, enc_frames=frames)
    if dtype == "float32":
        _, got_tok = lm_serve(torch, lm, cfg, params, tokens, frontend,
                              G - 1, dev, enc_frames=frames)
        greedy = got_tok.cpu().tolist()
        check(greedy == want_tok.tolist(), f"lm {cfg.name} float32: greedy "
              f"tokens on the card {greedy} vs the CPU's "
              f"{want_tok.tolist()}")
    torch.cuda.synchronize()
    got = got.float().cpu()
    want = want.float()
    tol = LM_CPU_TOL[dtype]
    err = float((got - want).abs().max())
    over = (got - want).abs() > tol + tol * want.abs()
    line = {"arch": cfg.name, "dtype": dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab_padded": cfg.vocab_padded,
            "steps": G, "seed": seed, "max_abs_err": err, "tol": tol,
            "share_over_tol": float(over.float().mean())}
    check(bool(torch.isfinite(got).all()),
          f"lm {cfg.name} {dtype}: card logits are not finite")
    if truth is None:
        check(not bool(over.any()), f"lm {cfg.name} {dtype}: card vs CPU "
              f"logits off by {err} (tol {tol})")
    else:
        line["tol"] = (f"no farther from the float32 logits than the CPU's "
                       f"bf16, x{LM_BF16_NOISE_RATIO}")
        line["bf16_noise_vs_f32_max_mean"] = noise_check(
            torch, cfg.name, "bf16", got, want, truth.float(),
            LM_BF16_NOISE_RATIO, labels=("card", "cpu"))
    if greedy is not None:
        line["greedy_tokens_equal"] = True
    return line


def profile_run(torch, fn) -> dict:
    """`fn()` under torch.profiler: wall time, the device's busy share
    (summed kernel time over wall time), the kernels launched, and the
    kernels taking the most device time ("not measured" where the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_s = sum(r[0] for r in rows) * 1e-6
    rows.sort(reverse=True)
    return {"wall_s": wall,
            "kernels_launched": sum(r[2] for r in rows) if rows
            else "not measured",
            "device_busy_s": busy_s if rows else "not measured",
            "device_busy_share": busy_s / wall if rows else "not measured",
            "top_kernels": [{"name": k[:80], "device_ms": us * 1e-3,
                             "calls": n} for us, k, n in rows[:6]]}


def lm_profile(torch, lm, cfg, params, tokens, frames, n_decode,
               dev) -> dict:
    """One prefill and `n_decode` greedy decode steps under torch.profiler
    (`profile_run`)."""
    return {"decode_steps": n_decode, **profile_run(torch, lambda: lm_serve(
        torch, lm, cfg, params, tokens, None, n_decode, dev,
        enc_frames=frames))}


def tree_numel(t) -> int:
    """The elements of a tree of tensors (None: 0)."""
    if t is None:
        return 0
    if isinstance(t, dict):
        return sum(tree_numel(v) for v in t.values())
    return t.numel()


def lm_bounds(cfg, params, B: int, P: int, G: int) -> dict:
    """The least time the card could take for the bf16 serve at B x P + G
    (H100 SXM peaks), from the param tree: prefill reads every param it
    runs once (not the MTP block) and does 2 flops a param a token (each
    token through its top_k experts; the head at the last position
    only), plus the attention products (causal self-attention, the
    enc-dec's cross-attention and non-causal encoder) or the recurrences
    (the Mamba state update and read, the WKV step); a decode step reads
    the trunk, the head, the B * top_k experts its tokens route to
    (assumed distinct) and the cache or states, and does 2 flops a param
    a token of those."""
    d = cfg.d_model
    n_all = tree_numel(params)
    n_embed = params["embed"].numel()
    n_head = tree_numel(params.get("head")) or n_embed
    n_enc = (tree_numel(params.get("enc"))
             + tree_numel(params.get("enc_norm")))
    n_exp = sum(tree_numel(params["moe_layers"]["moe"].get(k))
                for k in ("w1", "w2", "w3")) if cfg.is_moe else 0
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.is_moe else 0
    per_exp = n_exp / max(n_moe * cfg.n_experts, 1)
    n_trunk = (n_all - n_embed - tree_numel(params.get("head"))
               - tree_numel(params.get("mtp")) - n_enc - n_exp)
    n_tok = n_trunk + n_moe * cfg.top_k * per_exp      # params a token runs
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    elif cfg.family == "ssm":
        n_attn = 0
    else:
        n_attn = cfg.n_layers
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    if cfg.attention == "mla":
        pre_attn = 2 * H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                            + cfg.v_head_dim)
        dec_attn = 2 * H * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        row = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    else:
        pre_attn = dec_attn = 4 * H * hd
        row = 2 * cfg.n_kv_heads * hd * 2
    cache_row = n_attn * row                          # bytes a position
    state_ops = state_bytes = 0
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        state_ops = cfg.n_layers * 8 * nh * cfg.ssm_head_dim * cfg.ssm_state
        state_bytes = cfg.n_layers * (4 * nh * cfg.ssm_head_dim
                                      * cfg.ssm_state
                                      + 2 * (cfg.ssm_conv - 1)
                                      * (d_in + 2 * cfg.ssm_state))
    elif cfg.family == "ssm":
        state_ops = cfg.n_layers * 7 * H * hd * hd
        state_bytes = cfg.n_layers * (4 * H * hd * hd + 2 * 2 * d)
    cross = 0
    if cfg.enc_dec:                  # decoder tokens against P frames
        cross = cfg.n_layers * 4 * H * hd * P
    pre_ops = (2 * n_tok * B * P + 2 * n_head * B
               + B * n_attn * pre_attn * P * (P + 1) // 2
               + B * P * (state_ops + cross))
    pre_bytes = 2 * (n_all - tree_numel(params.get("mtp"))) \
        + B * P * cache_row \
        + B * state_bytes
    if cfg.enc_dec:
        pre_ops += (2 * n_enc * B * P
                    + B * cfg.n_enc_layers * 4 * H * hd * P * P)
        pre_bytes += B * P * cfg.n_layers * 2 * cfg.n_kv_heads * hd * 2
    ctx = P + G // 2
    experts_read = min(cfg.n_experts, B * cfg.top_k) if cfg.is_moe else 0
    dec_ops = (2 * (n_tok + n_head) * B + B * n_attn * dec_attn * ctx
               + B * (state_ops + cross))
    dec_bytes = (2 * (n_trunk + n_head + n_moe * experts_read * per_exp)
                 + B * ctx * cache_row + 2 * B * state_bytes)
    if cfg.enc_dec:
        dec_bytes += B * P * cfg.n_layers * 2 * cfg.n_kv_heads * hd * 2
    pre_ms, pre_by = bound(pre_bytes, pre_ops, PEAK_16BIT_S)
    dec_ms, dec_by = bound(dec_bytes, dec_ops, PEAK_16BIT_S)
    return {"params": n_all, "params_read_a_token": n_tok + n_head,
            "prefill_bound_ms": pre_ms, "prefill_bound_by": pre_by,
            "decode_step_bound_ms": dec_ms, "decode_step_bound_by": dec_by,
            "decode_tok_s_bound": B / dec_ms * 1e3}


def to_dtype_in_place(torch, tree, dtype) -> None:
    """Every leaf of a param tree cast to `dtype` in its dict, each old
    leaf freed as it is cast (bf16 -> float32 -> float64 is exact), so
    that a model that cannot sit on the card twice is held once. The
    freed blocks are released to CUDA after each leaf: a cast leaf is
    larger than the blocks freed before it (deepseek-v3's expert weights
    are 15 GB in float32), and cached blocks would fragment the card."""
    torch.cuda.empty_cache()
    for k, v in tree.items():
        if isinstance(v, dict):
            to_dtype_in_place(torch, v, dtype)
        elif v is not None:
            tree[k] = v.to(dtype)
            del v
            torch.cuda.empty_cache()


def noise_check(torch, name, what, got, want, truth, ratio,
                labels=("decode", "forward")) -> dict:
    """`got` no farther from `truth` than `want` is, by `ratio` in max and
    in mean; returns both distances [max, mean] under `labels`."""
    e_got, e_want = (got - truth).abs(), (want - truth).abs()
    a, b = labels
    noise = {a: [float(e_got.max()), float(e_got.mean())],
             b: [float(e_want.max()), float(e_want.mean())]}
    for i, stat in enumerate(("max", "mean")):
        check(noise[a][i] <= ratio * noise[b][i],
              f"lm {name}: the {what} {a} is farther from the truth than "
              f"the {what} {b} ({stat}): {noise}")
    return noise


def moe_dispatch_check(torch, lm, cfg, params, tokens) -> dict:
    """Both MoE dispatches on the first MoE layer's input, taken from the
    trunk itself (`moe_forward`'s first call in a forward over the
    prompt), float32: moe_forward_bitmap against moe_forward_coo, to
    LM_DISPATCH_TOL, each timed on its second call. They agree up to
    capacity drops, so they run at `cfg`'s check capacity, where no
    token can drop (C >= S). The assignments COO would drop at
    LM_CHECK_CAPACITY are counted: random weights route many of a
    sequence's tokens to the same experts."""
    moe = lm.moe
    torch.cuda.empty_cache()
    first, real = [], moe.moe_forward

    def grab(p, c, h):
        first.append((p, h))
        return real(p, c, h)

    moe.moe_forward = grab
    try:
        lm_forward_logits(torch, lm, cfg, params, tokens, None)
    finally:
        moe.moe_forward = real
    p, h = first[0]
    with torch.no_grad():
        G, S, _ = h.shape
        E, k = cfg.n_experts, cfg.top_k
        vals, idx, _ = moe._router_scores(p, cfg, h)
        dcfg = dataclasses.replace(cfg, capacity_factor=LM_CHECK_CAPACITY)
        buf, _ = moe._route_one_group(idx, vals, S, E, moe.capacity(dcfg, S))
        dropped = G * S * k - int((buf < S).sum())
        load = torch.zeros((G, E), dtype=torch.int64, device=h.device)
        load.scatter_add_(1, idx.reshape(G, -1),
                          torch.ones_like(idx.reshape(G, -1)))
        check(moe.capacity(cfg, S) >= S, f"lm {cfg.name}: capacity "
              f"{moe.capacity(cfg, S)} < {S}")
        out, ms = {}, {}
        for mode in ("bitmap", "coo"):
            fn = getattr(moe, f"moe_forward_{mode}")
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[mode] = fn(p, cfg, h)
                torch.cuda.synchronize()
                ms[mode] = (time.perf_counter() - t0) * 1e3
    (yb, ab), (yc, ac) = out["bitmap"], out["coo"]
    err = float((yb - yc).abs().max())
    check(bool(torch.isfinite(yb).all() and torch.isfinite(yc).all()),
          f"lm {cfg.name}: MoE dispatch outputs are not finite")
    check(bool(torch.allclose(yb, yc, rtol=LM_DISPATCH_TOL,
                              atol=LM_DISPATCH_TOL)),
          f"lm {cfg.name}: bitmap vs COO dispatch off by {err} (tol "
          f"{LM_DISPATCH_TOL})")
    return {"input": list(h.shape), "experts": E, "top_k": k,
            "capacity_factor": cfg.capacity_factor,
            "coo_capacity": moe.capacity(cfg, S),
            "max_tokens_on_one_expert": int(load.max()),
            "dropped_at_capacity_factor": {
                str(LM_CHECK_CAPACITY): dropped,
                "capacity": moe.capacity(dcfg, S)},
            "max_abs_err": err, "tol": LM_DISPATCH_TOL,
            "aux": [float(ab), float(ac)], "bitmap_ms": ms["bitmap"],
            "coo_ms": ms["coo"], "max_abs_out": float(yc.abs().max())}


def lm_full(torch, lm, cfg, seed, dev, timed: bool = True) -> dict:
    """One arch at published widths on the card in bf16, params drawn on
    the card from `seed`. Timed: prefill ms (median of
    LM_PREFILL_REPEATS), decode ms a step and tok/s over LM_FULL's greedy
    tokens, peak memory, the bounds and (not for the recurrent archs) a
    profile. Then, at the check capacity for MoE, greedy
    prefill-then-decode against the teacher-forced forward in bf16 and,
    on the same params cast to float32 in place, in float32 (for the
    recurrent archs also both against the forward on float64 params);
    the MoE archs' two dispatches at the first MoE layer."""
    B, P, G = LM_FULL["batch"], LM_FULL["prompt"], LM_FULL["gen"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, _ = lm.common.split_pl(lm.tf.init_model(cfg, gen, device=dev))
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    frames = (torch.randn(B, P, cfg.d_model, generator=gen, device=dev)
              .to(torch.bfloat16) if cfg.enc_dec else None)
    torch.cuda.synchronize()
    line = {"arch": cfg.name, "dtype": "bfloat16", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": B, "prompt": P, "gen": G,
            "seed": seed, "init_s": time.perf_counter() - t0}
    part = line["part_seconds"] = {}
    t_part = time.perf_counter()
    if timed:
        rules = lm.sharding.make_rules(lm.mesh.make_host_mesh(dev))
        prefill = lm.steps.build_prefill_step(cfg, rules)
        batch = {"tokens": tokens}
        if frames is not None:
            batch["enc_frames"] = frames
        lm_serve(torch, lm, cfg, params, tokens, None, 2, dev,
                 enc_frames=frames)                             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_ms = []
        for _ in range(LM_PREFILL_REPEATS):
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        times = {}
        lm_serve(torch, lm, cfg, params, tokens, None, G - 1, dev,
                 times=times, enc_frames=frames)
        decode_s = times["decode_s"]
        line.update(
            prefill_ms=sorted(prefill_ms)[len(prefill_ms) // 2],
            prefill_ms_all=prefill_ms,
            serve_prefill_ms=times["prefill_s"] * 1e3, decode_s=decode_s,
            decode_ms_per_step=decode_s / (G - 1) * 1e3,
            decode_tok_s=B * (G - 1) / decode_s,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            **lm_bounds(cfg, params, B, P, G))
        if cfg.family not in LM_RECURRENT:
            line["profile"] = lm_profile(torch, lm, cfg, params, tokens,
                                         frames, LM_PROFILE_STEPS, dev)
        line["peak_memory_gb"] = line["peak_memory_bytes"] / 1e9
        part["timed"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    ccfg = (dataclasses.replace(cfg, capacity_factor=max(
        LM_CHECK_CAPACITY, cfg.n_experts / cfg.top_k)) if cfg.is_moe
        else cfg)
    served, fed = lm_serve(torch, lm, ccfg, params, tokens, None, G - 1, dev,
                           enc_frames=frames)
    seq = torch.cat([tokens, fed], dim=1)
    cols = slice(P - 1, P - 1 + G)
    fwd = lm_forward_logits(torch, lm, ccfg, params, seq, None,
                            frames)[:, cols].float()
    served = served.float()
    part["bf16_check"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    params.pop("mtp", None)             # not read by serving; card memory
    to_dtype_in_place(torch, params, torch.float32)
    truth = lm_forward_logits(torch, lm, ccfg, params, seq, None,
                              frames)[:, cols]
    served32, _ = lm_serve(torch, lm, ccfg, params, tokens, None, G - 1, dev,
                           teacher=fed, enc_frames=frames)
    if cfg.is_moe:
        line.update(dispatch=cfg.resolved_dispatch(),
                    timed_capacity_factor=cfg.capacity_factor,
                    check_capacity_factor=ccfg.capacity_factor,
                    dispatch_check=moe_dispatch_check(torch, lm, ccfg,
                                                      params, tokens))
    check(bool(torch.isfinite(served).all() and torch.isfinite(served32)
               .all()), f"lm {cfg.name}: full-width logits are not finite")
    tol16 = LM_DECODE_TOL["bfloat16"]
    tol32 = (LM_RECURRENT_F32_TOL if cfg.family in LM_RECURRENT
             else LM_DECODE_TOL["float32"])
    err32 = float((served32 - truth).abs().max())
    check(bool(torch.allclose(served32, truth, rtol=tol32, atol=tol32)),
          f"lm {cfg.name}: float32 prefill-then-decode vs forward: "
          f"{err32} (tol {tol32})")
    if cfg.family in LM_RECURRENT:
        to_dtype_in_place(torch, params, torch.float64)
        truth64 = lm_forward_logits(torch, lm, ccfg, params, seq, None,
                                    frames)[:, cols]
        line["f32_vs_f64_forward_max_mean"] = {
            k: [float(e.max()), float(e.mean())] for k, e in (
                ("decode", (served32.double() - truth64).abs()),
                ("forward", (truth.double() - truth64).abs()))}
        del truth64
    part["f32_check"] = time.perf_counter() - t_part
    d16 = (served - fwd).abs()
    line.update(
        f32_decode_vs_forward_max_abs_err=err32,
        f32_decode_vs_forward_tol=tol32,
        bf16_noise_vs_f32_forward_max_mean=noise_check(
            torch, cfg.name, "bf16", served, fwd, truth,
            LM_BF16_NOISE_RATIO),
        bf16_noise_ratio_bound=LM_BF16_NOISE_RATIO,
        bf16_decode_vs_forward_max_abs_err=float(d16.max()),
        bf16_decode_vs_forward_share_over_3e_2=float(
            (d16 > tol16 + tol16 * fwd.abs()).float().mean()))
    del params, served, fwd, truth, served32
    torch.cuda.empty_cache()
    return line


def run_launchers(torch, module, arg_lists, timeout=LAUNCH_TIMEOUT_S):
    """`python -m <module> <args>` from the checkout for each of
    `arg_lists`, all started together, as a user runs them (`module`: one
    for all, or a list, one a run); fails unless each exits 0 and prints
    the card's name as its device (a run past `timeout` is killed, with
    the rest). Returns [(stdout, seconds)]."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    modules = [module] * len(arg_lists) if isinstance(module, str) else module
    runs = []
    try:
        for mod, args in zip(modules, arg_lists):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            runs.append((args, subprocess.Popen(
                [sys.executable, "-m", mod, *args], cwd=str(ROOT),
                env=env, stdout=out, stderr=err), out, err,
                time.perf_counter()))
        ended = {}
        while len(ended) < len(runs):
            for i, (_, proc, _, _, t0) in enumerate(runs):
                if i not in ended and proc.poll() is not None:
                    ended[i] = time.perf_counter() - t0
            check(all(time.perf_counter() - r[4] < timeout for i, r in
                      enumerate(runs) if i not in ended),
                  f"{module}: a run passed {timeout} s")
            time.sleep(0.05)
    finally:
        for _, proc, _, _, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    kind = torch.cuda.get_device_name(0)
    results = []
    for i, (args, proc, out, err, _) in enumerate(runs):
        out.seek(0)
        err.seek(0)
        text, errs = out.read().decode(), err.read().decode()
        out.close()
        err.close()
        check(proc.returncode == 0, f"{module} {args} exited "
              f"{proc.returncode}:\n{text[-3000:]}\n{errs[-3000:]}")
        device = re.findall(r"^\[\w+\] device: (.*)$", text, re.M)
        check(device == [kind], f"{module} printed device {device}, not "
              f"{kind}")
        results.append((text, ended[i]))
    return results


def run_launcher(torch, module: str, args, timeout=LAUNCH_TIMEOUT_S):
    """One `run_launchers` run: (stdout, seconds)."""
    return run_launchers(torch, module, [args], timeout)[0]


def lm_launch(torch, archs) -> list:
    """`python -m repro_torch.launch.serve --arch <arch>` with
    LM_LAUNCH_ARGS as a user runs it, on the card, for each of `archs`,
    all started together (their seconds and rates are those of runs side
    by side): exit 0, the card's name, one prefill, decode and sample
    line each."""
    arg_lists = [["--arch", arch] + LM_LAUNCH_ARGS for arch in archs]
    return [lm_launch_result(torch, args, out, seconds)
            for args, (out, seconds) in zip(arg_lists, run_launchers(
                torch, "repro_torch.launch.serve", arg_lists))]


def lm_launch_result(torch, args, out: str, seconds: float) -> dict:
    import re
    pre = re.findall(r"^prefill: ([\d.]+)s logits (.*)$", out, re.M)
    rate = re.findall(r"^decoded (\d+)x(\d+) tokens in ([\d.]+)s "
                      r"\(([\d.]+) tok/s\)$", out, re.M)
    sample = re.findall(r"^sample: (.*)$", out, re.M)
    check(len(pre) == 1 and len(rate) == 1 and len(sample) == 1,
          f"lm launcher {args} output:\n{out[-2000:]}")
    return {"args": args, "exit_code": 0, "seconds": seconds,
            "device": torch.cuda.get_device_name(0),
            "prefill_s": float(pre[0][0]), "logits": pre[0][1],
            "decoded": [int(rate[0][0]), int(rate[0][1])],
            "decode_s": float(rate[0][2]), "tok_s": float(rate[0][3]),
            "sample": json.loads(sample[0])}


def lm_modules():
    """The port's modules that the lm and lm_train phases drive."""
    from repro_torch import optim
    from repro_torch import ckpt
    from repro_torch.configs import registry
    from repro_torch.data import tokens
    from repro_torch.launch import elastic, mesh, steps
    from repro_torch.models import common, moe, sharding
    from repro_torch.models import transformer as tf
    return types.SimpleNamespace(
        mesh=mesh, steps=steps, common=common, sharding=sharding, tf=tf,
        moe=moe, registry=registry, tokens=tokens, elastic=elastic,
        optim=optim, ckpt=ckpt)


def lm_phase(torch, seed, dev) -> dict:
    """Language-model serving on the card. (1) Each arch's reduced config
    in float32 and bf16, and LM_WIDE_CUTS in float32: card against the
    CPU. (2) LM_FULL_CUTS at published widths in bf16 (`lm_full`, one
    `lm_full` line each), and the recurrent archs' float32 check at
    further seeds. (3) The launcher, as a user runs it, for
    LM_LAUNCH_ARCHS."""
    lm = lm_modules()
    registry = lm.registry
    t_phase = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    parity = []
    for i, name in enumerate(LM_ARCHS):
        for dtype in ("float32", "bfloat16"):
            parity.append(lm_card_vs_cpu(
                torch, lm, registry.reduced(registry.ARCHS[name]), dtype,
                seed + i, dev))
    seconds["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = []
    for name, cut in LM_WIDE_CUTS.items():
        t1 = time.perf_counter()
        row = lm_card_vs_cpu(torch, lm, dataclasses.replace(
            registry.ARCHS[name], **cut), "float32", seed, dev)
        row.update(cut=cut, seconds=time.perf_counter() - t1)
        wide.append(row)
        torch.cuda.empty_cache()
    seconds["full_width"] = time.perf_counter() - t0
    full, recurrent = [], []
    for name, cut in LM_FULL_CUTS.items():
        cfg = dataclasses.replace(registry.ARCHS[name], **cut)
        t0 = time.perf_counter()
        row = lm_full(torch, lm, cfg, seed, dev)
        row.update(cut=cut, seconds=time.perf_counter() - t0)
        emit({"phase": "lm_full", **row})
        full.append(row)
        if cfg.family in LM_RECURRENT:
            recurrent.append((cfg, row))
    seconds["full_size"] = sum(r["seconds"] for r in full)
    t0 = time.perf_counter()
    for cfg, _ in list(recurrent):
        for s in range(1, LM_RECURRENT_SEEDS):
            row = lm_full(torch, lm, cfg, seed + s, dev, timed=False)
            emit({"phase": "lm_recurrent_seed", **row})
            recurrent.append((cfg, row))
    seconds["recurrent_seeds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch = lm_launch(torch, LM_LAUNCH_ARCHS)
    seconds["launch"] = time.perf_counter() - t0
    return {"phase": "lm", "seconds": time.perf_counter() - t_phase,
            "part_seconds": seconds, "card_vs_cpu": parity,
            "full_width": wide,
            "full_size": [{k: r[k] for k in (
                "arch", "cut", "prefill_ms", "decode_tok_s",
                "peak_memory_gb", "f32_decode_vs_forward_max_abs_err",
                "prefill_bound_ms", "decode_step_bound_ms")} for r in full],
            "recurrent_f32": [
                {"arch": r["arch"], "seed": r["seed"],
                 "decode_vs_forward": r["f32_decode_vs_forward_max_abs_err"],
                 "vs_f64_forward": r["f32_vs_f64_forward_max_mean"]}
                for _, r in recurrent],
            "launch": launch}


# --------------------------------------------------------------------------
# lm_mesh: language-model serving across ranks
# --------------------------------------------------------------------------


def lm_mesh_cfg(lm, run: dict):
    """A run's config: the arch cut to `run["cut"]`, with its dispatch and
    at capacity E / top_k (no token drops; random weights overflow the
    published 1.25)."""
    cfg = dataclasses.replace(lm.registry.ARCHS[run["arch"]], **run["cut"])
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_dispatch=run["dispatch"],
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def lm_mesh_ref(run: dict) -> str:
    """The single-process reference's key of a run: its arch, cut and
    dispatch (the same for every mesh)."""
    cut = ",".join(f"{k}={v}" for k, v in sorted(run["cut"].items()))
    return f"{run['arch']}/{run['dispatch']}/{cut}"


def lm_mesh_params(torch, lm, cfg, dtype, seed: int, dev, rules=None):
    """`cfg`'s params drawn on the card from a CUDA generator seeded
    `seed` (every process on the card draws the same numbers), in
    `dtype`. With `rules` over a mesh of several ranks each leaf is
    placed as it is drawn (`init_model(rules=)`, as `serve_lm` draws
    them): each rank's shards only, by `param_sharding`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, logical = lm.common.split_pl(lm.tf.init_model(
        cfg, gen, dtype=getattr(torch, dtype), device=dev, rules=rules))
    if rules is None:
        return params
    want = lm.sharding.param_sharding(params, logical, rules)
    bad = [p for p, ok in named_leaves(lm.common.tree_map(
        lambda t, pls: tuple(t.placements) == tuple(pls), params, want))
        if not ok]
    check(not bad, f"{cfg.name}: leaves placed off their param_sharding: "
          f"{bad[:5]}")
    return params


def lm_mesh_file(key: str) -> str:
    """A run's key as a file name."""
    return "".join(c if c.isalnum() or c in ".-" else "_" for c in key)


def lm_mesh_teacher(torch, lm, cfg, params, rules, tokens, fed, dev,
                    profile: bool = False, enc_frames=None) -> tuple:
    """Prefill `tokens` (and an enc-dec arch's `enc_frames`), grow the
    cache to P + gen, then decode `fed`'s columns on `rules`' mesh: (the
    logits of every step (B, gen, Vp) as float32 on the CPU, times
    {prefill_ms, decode_ms_per_step}; with `profile`, the last step under
    torch.profiler: the host ms of its collectives)."""
    B, P = tokens.shape
    n = fed.shape[1]
    total = P + n + 1
    prefill = lm.steps.build_prefill_step(cfg, rules)
    decode = lm.steps.build_decode_step(cfg, rules, total)
    batch = {"tokens": tokens.to(dev)}
    if enc_frames is not None:
        batch["enc_frames"] = enc_frames.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    cache = lm.tf.grow_cache(cache, lm.tf.serve_cache_spec(
        cfg, B, total, enc_len=0 if enc_frames is None else
        enc_frames.shape[1])[0])
    out = [lm.sharding.whole(logits)]
    torch.cuda.synchronize()
    times = {"prefill_ms": (time.perf_counter() - t0) * 1e3}
    steps = n - 1 if profile else n
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = decode(params, fed[:, i:i + 1].to(dev), P + i, cache)
        out.append(lm.sharding.whole(logits))
    torch.cuda.synchronize()
    times["decode_ms_per_step"] = (time.perf_counter() - t0) / steps * 1e3
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            logits, cache = decode(params, fed[:, n - 1:n].to(dev),
                                   P + n - 1, cache)
            out.append(lm.sharding.whole(logits))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        coll = {e.key: (e.count, e.cpu_time_total * 1e-3)
                for e in prof.key_averages()
                if e.key.startswith(("gloo:", "_c10d_functional::"))}
        gloo = [v for k, v in coll.items() if k.startswith("gloo:")]
        times["profiled_step_ms"] = step_ms
        # gloo's own spans (each collective's run), and any collective
        # that DTensor issued itself (`_c10d_functional::`: none is
        # expected, `sharding.redistribute` issues them over gloo)
        times["collective_ms_per_step"] = (
            sum(v[1] for v in gloo) if gloo else "not measured")
        times["collectives"] = {k: {"calls": c, "host_ms": ms}
                                for k, (c, ms) in sorted(coll.items())}
    return torch.cat([o.float() for o in out], dim=1).cpu(), times


def lm_mesh_bytes(params) -> dict:
    """The bytes of this rank's shards of a placed tree and of the whole
    tree."""
    local = whole = 0
    for _, t in named_leaves(params):
        local += t.to_local().numel() * t.element_size()
        whole += t.numel() * t.element_size()
    return {"local_param_bytes": local, "whole_param_bytes": whole}


def lm_mesh_probe(torch, dist, dev) -> dict:
    """The collectives DTensor's redistributions call, on bf16 CUDA
    tensors over gloo: "ok" or what gloo raised."""
    world = dist.get_world_size()
    x = torch.arange(8, dtype=torch.bfloat16, device=dev)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty((8 * world,)), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty((8 // world,)), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0)}
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def lm_mesh_rank(rank: int, world: int, tmp: str, device: str,
                 shape: tuple, runs: list, seed: int,
                 train_runs: list = ()) -> None:
    """One rank of an lm_mesh world (a spawned process sharing the card
    over gloo): the mesh `shape` (data, model); per run and dtype its
    param bytes, float32 `serve_lm` greedy tokens, the teacher-forced
    logits and times (rank 0 writes the logits); an enc-dec run's encoder
    frames are the single process's. Then the train runs of the world
    (`lm_mesh_train_runs`: the lm_mesh_train part). Writes rank<r>.json,
    or rank<r>.err."""
    import faulthandler
    import os
    import traceback
    # a crash inside a collective leaves the Python stack on stderr
    faulthandler.enable()
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        from repro_torch.launch import serve
        from repro_torch.launch.mesh import init_ranks, make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        t_start = time.perf_counter()
        dev = init_ranks(device, backend="gloo",
                         init_method="file://" + os.path.join(tmp, "init"),
                         rank=rank, world_size=world,
                         timeout_s=MESH_COLLECTIVE_TIMEOUT_S * 4)
        lm = lm_modules()
        mesh = make_mesh(*shape, device=dev)
        rules = lm.sharding.make_rules(mesh)
        probe = lm_mesh_probe(torch, dist, dev)
        bf16_ok = all(v == "ok" for v in probe.values())
        data = np.load(os.path.join(tmp, "inputs.npz"))
        line = {"rank": rank, "world": world, "mesh": dict(mesh.shape),
                "device": str(dev), "gloo_bf16": probe, "runs": []}
        for run in runs:
            cfg = lm_mesh_cfg(lm, run)
            key = run["key"]
            ref = lm_mesh_file(lm_mesh_ref(run))
            tokens = torch.from_numpy(data[f"{ref}_tokens"])
            fed = torch.from_numpy(data[f"{ref}_fed"])
            frames = (torch.from_numpy(data[f"{ref}_frames"]).to(
                torch.bfloat16) if f"{ref}_frames" in data.files else None)
            for dtype in ("float32", "bfloat16"):
                if dtype == "bfloat16" and not bf16_ok:
                    continue
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params = lm_mesh_params(torch, lm, cfg, dtype, seed, dev,
                                        rules)
                torch.cuda.synchronize()
                r = {"key": key, "dtype": dtype,
                     "params_s": time.perf_counter() - t0,
                     **lm_mesh_bytes(params)}
                if dtype == "float32":
                    # the launcher's loop: greedy tokens, and the logits
                    # they were read from (the single process's path when
                    # the tokens are equal)
                    args = serve.build_parser().parse_args(
                        ["--arch", run["arch"], "--device", str(dev),
                         "--batch", str(tokens.shape[0]), "--prompt-len",
                         str(tokens.shape[1]), "--gen",
                         str(fed.shape[1] + 1)])
                    seen = []
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    toks = serve.serve_lm(args, params=params, tokens=tokens,
                                          enc_frames=frames, mesh=mesh,
                                          cfg=cfg, logits_out=seen)
                    torch.cuda.synchronize()
                    r["serve_lm_s"] = time.perf_counter() - t0
                    r["greedy"] = toks.cpu().tolist()
                    logits = torch.cat([o.float() for o in seen], 1).cpu()
                    del seen
                else:
                    # teacher-forced on the float32 greedy tokens, timed,
                    # the last step profiled
                    logits, times = lm_mesh_teacher(
                        torch, lm, cfg, params, rules, tokens, fed, dev,
                        profile=True, enc_frames=frames)
                    r.update(times)
                r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
                if rank == 0:
                    np.save(os.path.join(
                        tmp, f"{lm_mesh_file(key)}_{dtype}.npy"),
                        logits.numpy())
                del params, logits
                torch.cuda.empty_cache()
                line["runs"].append(r)
        line["train"] = lm_mesh_train_runs(torch, lm, rules, rank, tmp,
                                           list(train_runs), seed, dev)
        # no rank tears its connections down under another's last
        # collective
        dist.all_reduce(torch.zeros(1))
        dist.destroy_process_group()
        line["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(line, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def lm_mesh_world(tmp: str, device: str, shape: tuple, runs: list,
                  seed: int, train_runs: list) -> list:
    """The ranks of one lm_mesh world (`lm_mesh_rank`): their lines."""
    import os
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    codes = mesh_spawn(lm_mesh_rank, world,
                       (tmp, device, shape, runs, seed, train_runs),
                       LM_MESH_TIMEOUT_S)
    errors = []
    for r, code in enumerate(codes):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()[-3000:]}")
        elif code != 0:
            errors.append(f"rank {r}: exit code {code}")
    check(not errors, f"lm_mesh world {shape}:\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            line = json.load(f)
        line["world_seconds"] = time.perf_counter() - t0
        out.append(line)
    return out


def lm_mesh_single(torch, lm, cfg, seed: int, dev) -> dict:
    """The single process on the card: the prompt (and an enc-dec arch's
    encoder frames, (B, prompt, d_model) bf16 drawn from the seed),
    float32 greedy tokens (`serve_lm`'s loop, `lm_serve`) and the tokens
    they feed, then the teacher-forced logits of the float32 params, of
    the bf16 params and of the bf16 params in float32 (the truth of the
    noise rule), with prefill and decode times."""
    B, P, G = LM_MESH["batch"], LM_MESH["prompt"], LM_MESH["gen"]
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen)
    frames = (torch.randn((B, P, cfg.d_model), generator=gen).to(
        torch.bfloat16) if cfg.enc_dec else None)
    out = {"tokens": tokens, "frames": frames, "times": {}}
    params = lm_mesh_params(torch, lm, cfg, "float32", seed, dev)
    times = {}
    logits, fed = lm_serve(torch, lm, cfg, params, tokens, None, G - 1, dev,
                           times=times, enc_frames=frames)
    out["greedy"] = torch.argmax(logits, dim=-1).cpu()
    out["fed"] = fed.cpu()
    out["float32"] = logits.float().cpu()
    out["times"]["float32"] = {
        "prefill_ms": times["prefill_s"] * 1e3,
        "decode_ms_per_step": times["decode_s"] / (G - 1) * 1e3}
    del params, logits
    torch.cuda.empty_cache()
    params = lm_mesh_params(torch, lm, cfg, "bfloat16", seed, dev)
    times = {}
    out["bfloat16"] = lm_serve(torch, lm, cfg, params, tokens, None, G - 1,
                               dev, out["fed"], times=times,
                               enc_frames=frames)[0].float().cpu()
    out["times"]["bfloat16"] = {
        "prefill_ms": times["prefill_s"] * 1e3,
        "decode_ms_per_step": times["decode_s"] / (G - 1) * 1e3}
    params = lm.common.tree_map(lambda a: a.float(), params)
    torch.cuda.empty_cache()
    out["truth"] = lm_serve(torch, lm, cfg, params, tokens, None, G - 1, dev,
                            out["fed"], enc_frames=frames)[0].float().cpu()
    del params
    torch.cuda.empty_cache()
    return out


def lm_mesh_phase(torch, seed, dev) -> tuple:
    """Language-model serving across ranks on the card (LM_MESH_RUNS):
    the single process first, then each world spawned once, then the
    launchers under torchrun beside one process each. Checks each rank
    against the single process: float32 greedy tokens exactly and logits
    to LM_MESH_TOL (LM_RECURRENT_F32_TOL for the recurrent archs; relative
    and absolute), bf16 by the noise rule; each rank's param bytes under
    the whole tree's. The same worlds then run the train step
    (LM_MESH_TRAIN_RUNS, after their single process on the card), held
    by `lm_mesh_train_results`. Returns (the lm_mesh line, the
    lm_mesh_train line)."""
    import os
    import re
    lm = lm_modules()
    t_phase = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    train_single = lm_mesh_train_single_all(torch, lm, seed, dev)
    torch.cuda.empty_cache()
    train_seconds = {"single_process": time.perf_counter() - t0}
    single = {}
    t0 = time.perf_counter()
    refs = {run["key"]: lm_mesh_ref(run) for run in LM_MESH_RUNS}
    for run in LM_MESH_RUNS:
        ref = refs[run["key"]]
        if ref not in single:
            single[ref] = lm_mesh_single(torch, lm, lm_mesh_cfg(lm, run),
                                         seed, dev)
    seconds["single_process"] = time.perf_counter() - t0
    results, lines, dirs = {}, [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_mesh_") as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), **{
            f"{lm_mesh_file(k)}_{w}": s[w].float().numpy() if w == "frames"
            else s[w].numpy() for k, s in single.items()
            for w in ("tokens", "fed", "frames") if s[w] is not None})
        for shape in LM_MESH_WORLDS:
            runs = [r for r in LM_MESH_RUNS if tuple(r["world"]) == shape]
            wdir = os.path.join(tmp, f"w{shape[0]}x{shape[1]}")
            os.makedirs(wdir)
            os.symlink(os.path.join(tmp, "inputs.npz"),
                       os.path.join(wdir, "inputs.npz"))
            t0 = time.perf_counter()
            ranks = lm_mesh_world(wdir, str(dev), shape, runs, seed, [
                r for r in LM_MESH_TRAIN_RUNS if tuple(r["world"]) == shape])
            seconds[f"world_{shape[0]}x{shape[1]}"] = (
                time.perf_counter() - t0)
            dirs[shape] = wdir
            for r in runs:
                for dtype in ("float32", "bfloat16"):
                    path = os.path.join(
                        wdir, f"{lm_mesh_file(r['key'])}_{dtype}.npy")
                    if os.path.exists(path):
                        results[(r["key"], dtype)] = torch.from_numpy(
                            np.load(path))
            lines.append({"mesh": {"data": shape[0], "model": shape[1]},
                          "ranks": ranks})
        t0 = time.perf_counter()
        train_rows = lm_mesh_train_results(train_single, lines, dirs)
        train_seconds["checks"] = time.perf_counter() - t0
    train_line = {
        "phase": "lm_mesh_train", "part_seconds": train_seconds,
        "rank_seconds": {f"{w['mesh']['data']}x{w['mesh']['model']}":
                         sum(r["seconds"] for r in w["ranks"][0]["train"])
                         for w in lines},
        "shape": LM_MESH_TRAIN, "runs": LM_MESH_TRAIN_RUNS,
        "tol": LM_MESH_TRAIN_TOL, "bf16_loss_tol": LM_MESH_TRAIN_BF16_LOSS_TOL,
        "bf16_noise_ratio": LM_BF16_NOISE_RATIO,
        "samples_a_leaf": LM_MESH_TRAIN_SAMPLES,
        "single_process": {k: {d: line for d, (line, _) in v.items()}
                           for k, v in train_single.items()},
        "worlds": [{"mesh": w["mesh"], "ranks": [
            {"rank": rk["rank"], "runs": rk["train"]} for rk in w["ranks"]]}
            for w in lines],
        "checks": train_rows}
    for w in lines:
        for rk in w["ranks"]:
            del rk["train"]
    checks = []
    bf16_carried = all(v == "ok" for w in lines for rk in w["ranks"]
                       for v in rk["gloo_bf16"].values())
    f32_tol = {run["key"]: LM_RECURRENT_F32_TOL if lm.registry.ARCHS[
        run["arch"]].family in LM_RECURRENT else LM_MESH_TOL
        for run in LM_MESH_RUNS}
    for w in lines:
        for rk in w["ranks"]:
            for r in rk["runs"]:
                s = single[refs[r["key"]]]
                check(r["local_param_bytes"] < r["whole_param_bytes"],
                      f"lm_mesh {r['key']} rank {rk['rank']}: "
                      f"{r['local_param_bytes']} bytes of "
                      f"{r['whole_param_bytes']}")
                if r["dtype"] == "float32":
                    want = s["greedy"].tolist()
                    check(r["greedy"] == want, f"lm_mesh {r['key']} "
                          f"{w['mesh']} rank {rk['rank']}: greedy tokens "
                          f"{r['greedy']} vs one process's {want}")
                got = results.get((r["key"], r["dtype"]))
                if got is None or rk["rank"] != 0:
                    continue        # rank 0 wrote the (whole) logits
                row = {"key": r["key"], "mesh": w["mesh"],
                       "dtype": r["dtype"]}
                check(bool(torch.isfinite(got).all()),
                      f"lm_mesh {r['key']} {r['dtype']}: logits not finite")
                if r["dtype"] == "float32":
                    want = s["float32"]
                    err = (got - want).abs()
                    tol = f32_tol[r["key"]]
                    row["max_abs_err"] = float(err.max())
                    row["tol"] = tol
                    check(not bool((err > tol + tol * want.abs()).any()),
                          f"lm_mesh {r['key']} {w['mesh']}: float32 logits "
                          f"off by {row['max_abs_err']}")
                    row["greedy_tokens_equal"] = True
                else:
                    row["max_abs_err_vs_one_process"] = float(
                        (got - s["bfloat16"]).abs().max())
                    row["bf16_noise_vs_f32_max_mean"] = noise_check(
                        torch, r["key"], "bf16", got, s["bfloat16"],
                        s["truth"], LM_BF16_NOISE_RATIO,
                        labels=("mesh", "one_process"))
                checks.append(row)
    check(len(checks) == len(LM_MESH_RUNS) * (2 if bf16_carried else 1),
          f"lm_mesh: {len(checks)} logit checks")
    # -- the launchers under torchrun, two ranks sharing the card, and one
    # process each, all side by side ---------------------------------------
    t0 = time.perf_counter()
    two_args = [["--standalone", "--nproc-per-node", "2", "-m",
                 "repro_torch.launch.serve", *a, "--device",
                 str(torch.device("cuda", 0)), "--backend", "gloo"]
                for a in LM_MESH_LAUNCH]
    n = len(LM_MESH_LAUNCH)
    outs = run_launchers(
        torch,
        ["repro_torch.launch.serve"] * n + ["torch.distributed.run"] * n,
        list(LM_MESH_LAUNCH) + two_args)
    seconds["launcher"] = time.perf_counter() - t0
    launchers = []
    for a, args, (one_out, one_s), (tr_out, tr_s) in zip(
            LM_MESH_LAUNCH, two_args, outs[:n], outs[n:]):
        one = re.findall(r"^sample: (.*)$", one_out, re.M)
        two = re.findall(r"^sample: (.*)$", tr_out, re.M)
        check(len(one) == 1 and two == one, f"torchrun launcher {a} samples "
              f"{two} against one process's {one}:\n{tr_out[-2000:]}")
        check("[serve] mesh: {'data': 2, 'model': 1}" in tr_out,
              f"torchrun launcher output:\n{tr_out[-2000:]}")
        launchers.append({"args": args, "seconds": tr_s,
                          "one_process_seconds": one_s,
                          "sample": json.loads(two[0])})
    train_line["seconds"] = (sum(train_seconds.values())
                             + sum(train_line["rank_seconds"].values()))
    return ({"phase": "lm_mesh", "seconds": time.perf_counter() - t_phase,
             "part_seconds": seconds, "shape": LM_MESH,
             "runs": LM_MESH_RUNS, "tol": LM_MESH_TOL,
             "bf16_noise_ratio": LM_BF16_NOISE_RATIO,
             "gloo_carried_bf16": bf16_carried,
             "single_process": {k: s["times"] for k, s in single.items()},
             "worlds": lines, "checks": checks, "launcher": launchers},
            train_line)


# --------------------------------------------------------------------------
# lm_mesh_train: the language-model train step across ranks
# --------------------------------------------------------------------------


def lm_mesh_train_cfg(lm, run: dict):
    """A train run's config: the arch cut to `run["cut"]`, an MoE arch at
    capacity E / top_k."""
    cfg = dataclasses.replace(lm.registry.ARCHS[run["arch"]], **run["cut"])
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def leaf_samples(torch, lm, t) -> tuple:
    """(sample numbers, float32 values) of leaf `t` on a fixed stride of
    its flattened whole, at most LM_MESH_TRAIN_SAMPLES (sample i is
    element i k); of a DTensor the samples that lie in this rank's shard,
    read from it (no collective)."""
    n = t.numel()
    k = max(1, -(-n // LM_MESH_TRAIN_SAMPLES))
    pos = torch.arange(0, n, k, device=t.device)
    if not lm.sharding.is_dtensor(t):
        vals = t.detach().reshape(-1)[pos]
        return (pos // k).int().cpu().numpy(), vals.float().cpu().numpy()
    local = t.to_local().detach().contiguous()
    sl = lm.sharding.local_slices(t.shape, t.placements, t.device_mesh)
    inside = torch.ones_like(pos, dtype=torch.bool)
    flat = torch.zeros_like(pos)
    rest, stride = pos, 1
    for d in reversed(range(t.dim())):
        c = rest % t.shape[d]
        rest = rest // t.shape[d]
        inside &= (c >= sl[d].start) & (c < sl[d].stop)
        flat += (c - sl[d].start) * stride
        stride *= local.shape[d]
    vals = local.reshape(-1)[flat[inside]]
    return ((pos[inside] // k).int().cpu().numpy(),
            vals.float().cpu().numpy())


def tree_samples(torch, lm, tree) -> list:
    """`leaf_samples` of every leaf, in `named_leaves` order."""
    return [leaf_samples(torch, lm, t) for _, t in named_leaves(tree)]


def leaf_maxes(torch, tree) -> list:
    """max|leaf| of every leaf (float32), in `named_leaves` order; plain
    tensors only (of a DTensor it would be a reduction across ranks)."""
    return [float(t.detach().abs().max().float())
            for _, t in named_leaves(tree)]


def lm_mesh_train_steps(torch, lm, cfg, run, rules, params, seed, dev):
    """One train run from `params` on `rules`' mesh (one process: a
    one-device mesh): step 1 on batch 0 under the profiler, its gradients
    sampled as its `loss_and_grads` returns them (no pass of their own),
    then step 2 on batch 1 in three synchronised parts. Returns (its
    line: losses, grad norms, ms, gloo's spans, bytes; the sample sets:
    the gradients, and after AdamW's step 1 the params and m)."""
    from torch.profiler import ProfilerActivity, profile
    B, S = LM_MESH_TRAIN["batch"], LM_MESH_TRAIN["seq"]
    batches = [lm_train_batch(lm, cfg, B, S, seed, i, dev) for i in range(2)]
    opt = getattr(lm.optim, run["opt"])(
        lr=LM_TRAIN_LR, schedule=lm.optim.cosine_schedule(
            max(LM_TRAIN_STEPS // 20, 1), LM_TRAIN_STEPS))
    state = opt.init(params)
    step = lm.steps.build_train_step(cfg, rules, opt)
    line, sets = {}, {}
    one = not lm.sharding.on_ranks(rules)
    real = lm.steps.loss_and_grads

    def grab(*args):
        out = real(*args)
        sets["grads"] = tree_samples(torch, lm, out[2])
        if one:                 # the scales of the checks
            line["grad_max"] = leaf_maxes(torch, out[2])
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.steps.loss_and_grads = grab
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batches[0])
            torch.cuda.synchronize()
            line["step1_ms_profiled"] = (time.perf_counter() - t0) * 1e3
    finally:
        lm.steps.loss_and_grads = real
    coll = {e.key: (e.count, e.cpu_time_total * 1e-3)
            for e in prof.key_averages()
            if e.key.startswith(("gloo:", "_c10d_functional::"))}
    line["step1"] = {k: float(v) for k, v in metrics.items()}
    line["collectives"] = {k: {"calls": c, "host_ms": ms}
                           for k, (c, ms) in sorted(coll.items())}
    line["gloo_ms_step1"] = sum(ms for k, (c, ms) in coll.items()
                                if k.startswith("gloo:"))
    line["functional_ops"] = sum(c for k, (c, ms) in coll.items()
                                 if k.startswith("_c10d_functional::"))
    if run["opt"] == "adamw":
        sets["params1"] = tree_samples(torch, lm, params)
        sets["m1"] = tree_samples(torch, lm, state["m"])
        if one:
            line["params1_max"] = leaf_maxes(torch, params)
            line["m1_max"] = leaf_maxes(torch, state["m"])
    held = whole = 0
    for _, t in named_leaves({"p": params, "s": {
            k: v for k, v in state.items() if k != "step"}}):
        held += lm.sharding.local_part(t).numel() * t.element_size()
        whole += t.numel() * t.element_size()
    line["bytes_params_state"] = {"rank": held, "whole": whole,
                                  "share": held / whole}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with lm.sharding.use_rules(rules), lm.sharding.mesh_context(rules):
        batch = lm.steps.place_batch(cfg, batches[1], rules)
        tracked, leaves = lm.steps.track(params)
        with torch.enable_grad():
            loss, _ = lm.tf.model_loss(tracked, cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = lm.steps.grads_of(loss, tracked, leaves)
        del tracked, leaves
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads, gn = lm.optim.clip_by_global_norm(grads, lm.steps.GRAD_CLIP)
        params, state = opt.update(grads, state, params)
        del grads
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    line["step2"] = {"loss": float(loss.detach()), "grad_norm": float(gn)}
    line["step2_ms"] = (t3 - t0) * 1e3
    line["step2_split_ms"] = {"forward": (t1 - t0) * 1e3,
                              "backward": (t2 - t1) * 1e3,
                              "clip_update": (t3 - t2) * 1e3}
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(lm.sharding.local_part(p)).all())
                 for _, p in named_leaves(params))
    check(finite, f"lm_mesh_train {cfg.name}: a param is not finite")
    del params, state, step
    torch.cuda.empty_cache()
    return line, sets


def lm_mesh_train_single(torch, lm, run, seed, dev) -> dict:
    """A run in one process on the card, for each of its dtypes: its line
    and sample sets (`lm_mesh_train_steps`); for bf16 also the gradients
    of the pass on the same bf16 params in float32 (the truth of the
    noise rule)."""
    cfg = lm_mesh_train_cfg(lm, run)
    rules = lm.sharding.make_rules(lm.elastic.make_mesh_from([dev], 1))
    out = {}
    for dtype in run["dtypes"]:
        params = lm_mesh_params(torch, lm, cfg, dtype, seed, dev)
        line, sets = lm_mesh_train_steps(torch, lm, cfg, run, rules, params,
                                         seed, dev)
        del params
        torch.cuda.empty_cache()
        if dtype == "bfloat16":
            params = lm.common.tree_map(
                lambda a: a.float(), lm_mesh_params(torch, lm, cfg, dtype,
                                                    seed, dev))
            torch.cuda.empty_cache()
            batch = lm_train_batch(lm, cfg, LM_MESH_TRAIN["batch"],
                                   LM_MESH_TRAIN["seq"], seed, 0, dev)
            with lm.sharding.use_rules(rules):
                _, _, grads = lm.steps.loss_and_grads(cfg, params, batch)
            del params
            sets["truth"] = tree_samples(torch, lm, grads)
            del grads
            torch.cuda.empty_cache()
        out[dtype] = (line, sets)
    return out


def lm_mesh_train_file(key: str, dtype: str, rank: int) -> str:
    return f"{lm_mesh_file(key)}_{dtype}_rank{rank}.npz"


def lm_mesh_train_runs(torch, lm, rules, rank: int, tmp: str, runs: list,
                       seed: int, dev) -> list:
    """In a rank of an lm_mesh world, after its serving runs: per train
    run and dtype, `lm_mesh_train_steps` on params drawn placed
    (`init_model(rules=)`); its samples in an npz of `tmp`. Returns its
    lines."""
    import os
    out = []
    for run in runs:
        cfg = lm_mesh_train_cfg(lm, run)
        for dtype in run["dtypes"]:
            t0 = time.perf_counter()
            params = lm_mesh_params(torch, lm, cfg, dtype, seed, dev, rules)
            r, sets = lm_mesh_train_steps(torch, lm, cfg, run, rules, params,
                                          seed, dev)
            del params
            r.update(key=run["key"], dtype=dtype,
                     seconds=time.perf_counter() - t0)
            np.savez(os.path.join(tmp, lm_mesh_train_file(
                run["key"], dtype, rank)), **{
                    f"{name}.{i}.{w}": a for name, leaves in sets.items()
                    for i, pair in enumerate(leaves)
                    for w, a in zip("iv", pair)})
            out.append(r)
    return out


def assemble_samples(paths, want: dict) -> dict:
    """The ranks' samples (npz files of `lm_mesh_train_runs`) as one
    vector a leaf, each as long as the single process's `want` vector
    (the sets the ranks keep: not the truth); every sample must have come
    from some rank."""
    got = {name: [np.full(v.shape, np.nan, dtype=np.float32)
                  for _, v in leaves] for name, leaves in want.items()
           if name != "truth"}
    for path in paths:
        with np.load(path) as f:
            for key in f.files:
                name, i, w = key.rsplit(".", 2)
                if w == "i" and name in got:
                    got[name][int(i)][f[key]] = f[f"{name}.{i}.v"]
    for name, leaves in got.items():
        missing = sum(int(np.isnan(v).sum()) for v in leaves)
        check(missing == 0, f"lm_mesh_train: {missing} {name} samples "
              f"held by no rank")
    return got


def close_rel(got: float, want: float, tol: float) -> bool:
    return abs(got - want) <= tol * max(1.0, abs(want))


def lm_mesh_train_check(key, dtype, one, one_sets, rk, got) -> dict:
    """One rank's run against the single process: the losses and grad
    norms, every sampled gradient leaf, in float32 the params after
    AdamW's first step, in bf16 the noise rule. Returns the row."""
    name = f"lm_mesh_train {key} {dtype} rank {rk['rank']}"
    row = {"key": key, "dtype": dtype, "rank": rk["rank"]}
    check(rk["functional_ops"] == 0,
          f"{name}: {rk['functional_ops']} functional collectives")
    losses = [(f"{s}.{k}", one[s][k], rk[s][k]) for s in ("step1", "step2")
              for k in ("loss", "grad_norm")]
    row["losses"] = {k: [g, w] for k, w, g in losses}
    if dtype == "float32":
        for k, w, g in losses:
            check(close_rel(g, w, LM_MESH_TRAIN_TOL),
                  f"{name}: {k} {g} against {w}")
        errs = [float(np.abs(g - w).max() / m) if m else 0.0
                for (_, w), g, m in zip(one_sets["grads"], got["grads"],
                                        one["grad_max"])]
        row["grad_leaf_err_max"] = max(errs)
        check(row["grad_leaf_err_max"] <= LM_MESH_TRAIN_TOL,
              f"{name}: a gradient leaf {max(errs)} of its largest")
        b1, eps = LM_TRAIN_ADAMW["b1"], LM_TRAIN_ADAMW["eps"]
        worst = 0.0
        for (_, w), g, (_, m), pmax, mmax in zip(
                one_sets["params1"], got["params1"], one_sets["m1"],
                one["params1_max"], one["m1_max"]):
            gabs = np.abs(m) / (1 - b1)
            bnd = (LM_MESH_TRAIN_TOL * pmax + LM_TRAIN_LR * 4
                   * LM_MESH_TRAIN_TOL * (mmax / (1 - b1)) / (gabs + eps))
            diff = np.abs(g - w)
            worst = max(worst, float(np.where(diff == 0, 0.0,
                                              diff / bnd).max()))
        row["adamw_first_step_ratio"] = worst
        check(worst <= 1.0, f"{name}: params after step 1 at {worst} of "
              f"AdamW's first-step bound")
    else:
        for k, w, g in losses:
            if "loss" in k:
                check(abs(g - w) < LM_MESH_TRAIN_BF16_LOSS_TOL,
                      f"{name}: {k} {g} against {w}")
        noise = []
        for (_, o), g, (_, t) in zip(one_sets["grads"], got["grads"],
                                     one_sets["truth"]):
            e_g, e_o = np.abs(g - t), np.abs(o - t)
            noise.append([float(e_g.max()), float(e_g.mean()),
                          float(e_o.max()), float(e_o.mean())])
            for i, stat in ((0, "max"), (1, "mean")):
                check(noise[-1][i] <= LM_BF16_NOISE_RATIO * noise[-1][i + 2],
                      f"{name}: a gradient leaf farther from the truth "
                      f"than one process's ({stat}): {noise[-1]}")
        row["grad_noise_ratio_max"] = max(
            max(n[0] / n[2] if n[2] else (0.0 if n[0] == 0 else math.inf),
                n[1] / n[3] if n[3] else (0.0 if n[1] == 0 else math.inf))
            for n in noise)
    return row


def lm_mesh_train_single_all(torch, lm, seed, dev) -> dict:
    """`lm_mesh_train_single` once for each arch and cut of
    LM_MESH_TRAIN_RUNS, keyed as `lm_mesh_ref` keys them."""
    single = {}
    for run in LM_MESH_TRAIN_RUNS:
        ref = lm_mesh_ref(dict(run, dispatch=None))
        if ref not in single:
            single[ref] = lm_mesh_train_single(torch, lm, run, seed, dev)
    return single


def lm_mesh_train_results(single: dict, lines: list, dirs: dict) -> list:
    """Each rank's train runs (`lines`: the lm_mesh worlds' rank lines;
    `dirs`: each world's directory of samples) held against the single
    process (`lm_mesh_train_check`); returns the rows."""
    import os
    rows = []
    for w in lines:
        shape = (w["mesh"]["data"], w["mesh"]["model"])
        ranks = w["ranks"]
        for run in LM_MESH_TRAIN_RUNS:
            if tuple(run["world"]) != shape:
                continue
            for dtype in run["dtypes"]:
                one, one_sets = single[lm_mesh_ref(dict(run, dispatch=None))][
                    dtype]
                got = assemble_samples(
                    [os.path.join(dirs[shape], lm_mesh_train_file(
                        run["key"], dtype, r)) for r in range(len(ranks))],
                    one_sets)
                for rk in ranks:
                    r = next(x for x in rk["train"] if x["key"] == run["key"]
                             and x["dtype"] == dtype)
                    rows.append(lm_mesh_train_check(
                        run["key"], dtype, one, one_sets,
                        dict(r, rank=rk["rank"]), got))
    n_want = sum(len(r["dtypes"]) * r["world"][0] * r["world"][1]
                 for r in LM_MESH_TRAIN_RUNS)
    check(len(rows) == n_want, f"lm_mesh_train: {len(rows)} checks")
    return rows


# --------------------------------------------------------------------------
# lm_train: language-model training on the card
# --------------------------------------------------------------------------


def named_leaves(tree, path=""):
    """(path, leaf) of a tree of tensors, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def flat_cpu(torch, tree):
    """A tree's leaves as one float32 vector on the CPU."""
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for _, t in named_leaves(tree)])


def leaf_rel_err(torch, got, want, skip=()) -> tuple:
    """(the largest over leaves of max|got - want| / max|want|, its leaf);
    a leaf that is zero in `want` counts its largest |got|; the paths in
    `skip` are left out."""
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
        if path in skip:
            continue
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        rel = err / scale if scale else (0.0 if err == 0 else math.inf)
        if rel > worst or where is None:
            worst, where = rel, path
    return worst, where


def adamw_first_step_ratio(torch, got, want, m, tol) -> float:
    """The largest ratio over every param of |got - want| to AdamW's
    first-step bound (LM_TRAIN_ADAMW; see the lm_train constants):
    tol x its leaf's largest + lr x 4 tol max|g| / (|g| + eps), g = m /
    (1 - b1). At most 1 passes."""
    b1, eps = LM_TRAIN_ADAMW["b1"], LM_TRAIN_ADAMW["eps"]
    worst = 0.0
    for (_, a), (_, b), (_, mm) in zip(named_leaves(got), named_leaves(want),
                                       named_leaves(m)):
        a, b = a.float().cpu(), b.float().cpu()
        g = mm.float().cpu().abs() / (1 - b1)
        bnd = (tol * b.abs().max()
               + LM_TRAIN_LR * 4 * tol * g.max() / (g + eps))
        diff = (a - b).abs()
        ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / bnd)
        worst = max(worst, float(ratio.max()))
    return worst


def lm_train_opt(lm, n_params: int):
    """The launcher's optimizer for a model of `n_params`: its size rule,
    lr and schedule."""
    return lm.optim.pick_optimizer(
        n_params, lr=LM_TRAIN_LR, schedule=lm.optim.cosine_schedule(
            max(LM_TRAIN_STEPS // 20, 1), LM_TRAIN_STEPS))


def lm_train_batch(lm, cfg, B: int, S: int, seed: int, step: int, dev):
    from repro_torch.configs.base import ShapeConfig
    return lm.tokens.TokenStream(cfg, ShapeConfig("smoke", S, B, "train"),
                                 seed=seed, device=dev).batch(step)


def lm_train_one(torch, lm, cfg, params, batch, dev) -> dict:
    """On `dev`: one `build_train_step` step with AdamW at the launcher's
    lr and schedule (the clip included), and the loss and gradients its
    `steps.loss_and_grads` call returned (kept as it returns them)."""
    rules = lm.sharding.make_rules(lm.elastic.make_mesh_from([dev], 1))
    opt = lm.optim.adamw(lr=LM_TRAIN_LR, schedule=lm.optim.cosine_schedule(
        max(LM_TRAIN_STEPS // 20, 1), LM_TRAIN_STEPS))
    seen, real = [], lm.steps.loss_and_grads

    def grab(*args):
        seen.append(real(*args))
        return seen[-1]

    lm.steps.loss_and_grads = grab
    try:
        new, state, metrics = lm.steps.build_train_step(cfg, rules, opt)(
            params, opt.init(params), batch)
    finally:
        lm.steps.loss_and_grads = real
    check(len(seen) == 1, f"{cfg.name}: {len(seen)} loss_and_grads calls")
    loss, _, grads = seen[0]
    return {"loss": float(loss), "grads": grads, "params": new,
            "m": state["m"],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def lm_routes(torch, lm, cfg, params, batch) -> list:
    """Each MoE router call's top-k experts (CPU tensors) in a forward of
    `model_loss`."""
    got, real = [], lm.moe._router_scores

    def grab(p, c, x):
        out = real(p, c, x)
        got.append(out[1].detach().cpu())
        return out

    lm.moe._router_scores = grab
    try:
        with torch.no_grad():
            lm.tf.model_loss(params, cfg, batch)
    finally:
        lm.moe._router_scores = real
    return got


def lm_train_card_vs_cpu(torch, lm, cfg, dtype, seed, dev) -> dict:
    """One model's params drawn on the CPU from `seed` and copied to the
    card, one TokenStream batch: `lm_train_one` on both devices, the loss,
    every gradient leaf and every updated param compared (the lm_train
    constants' rules)."""
    tdt = getattr(torch, dtype)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    params, _ = lm.common.split_pl(lm.tf.init_model(cfg, gen, dtype=tdt,
                                                    device=cpu))
    B, S = LM_TRAIN_SMALL["batch"], LM_TRAIN_SMALL["seq"]
    batch = lm_train_batch(lm, cfg, B, S, seed, 0, cpu)
    t0 = time.perf_counter()
    want = lm_train_one(torch, lm, cfg, params, batch, cpu)
    t_cpu = time.perf_counter() - t0
    dparams = lm.common.tree_map(lambda a: a.to(dev), params)
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    got = lm_train_one(torch, lm, cfg, dparams, dbatch, dev)
    torch.cuda.synchronize()
    name = f"lm_train {cfg.name} {dtype}"
    check(math.isfinite(got["loss"]) and all(
        bool(torch.isfinite(g).all()) for _, g in named_leaves(got["grads"]))
        and all(bool(torch.isfinite(p).all())
                for _, p in named_leaves(got["params"])),
        f"{name}: card loss, gradients or params are not finite")
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad_err, grad_leaf = leaf_rel_err(torch, got["grads"], want["grads"])
    param_err, param_leaf = leaf_rel_err(torch, got["params"],
                                         want["params"])
    tol = LM_TRAIN_GRAD_TOL[dtype]
    line = {"arch": cfg.name, "dtype": dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "seed": seed, "batch": B, "seq": S,
            "loss": [want["loss"], got["loss"]], "loss_rel_err": loss_err,
            "loss_rtol": LM_TRAIN_LOSS_RTOL[dtype],
            "grad_max_rel_err": grad_err, "grad_worst_leaf": grad_leaf,
            "grad_tol": tol, "param_max_rel_err": param_err,
            "param_worst_leaf": param_leaf,
            "grad_norm": [want["metrics"]["grad_norm"],
                          got["metrics"]["grad_norm"]],
            "cpu_s": t_cpu}
    check(loss_err <= LM_TRAIN_LOSS_RTOL[dtype], f"{name}: loss "
          f"{got['loss']} vs the CPU's {want['loss']}")
    ratio = adamw_first_step_ratio(torch, got["params"], want["params"],
                                   want["m"], tol)
    line["param_vs_first_step_bound"] = ratio
    check(ratio <= 1.0, f"{name}: params past AdamW's first-step bound "
          f"({ratio} of it)")
    if dtype == "float32":
        if cfg.enc_dec:
            path, loose = LM_TRAIN_BF16_CAST_LEAF
            err, _ = leaf_rel_err(torch, *(dict(named_leaves(t["grads"]))[
                path] for t in (got, want)))
            line["bf16_cast_leaf"] = {"leaf": path, "max_rel_err": err,
                                      "tol": loose}
            check(err <= loose, f"{name}: gradient {path} off by {err} of "
                  f"its largest (tol {loose})")
            grad_err, grad_leaf = leaf_rel_err(torch, got["grads"],
                                               want["grads"], skip=(path,))
            line.update(grad_max_rel_err=grad_err, grad_worst_leaf=grad_leaf)
        check(grad_err <= tol, f"{name}: gradient {grad_leaf} off by "
              f"{grad_err} of its largest (tol {tol})")
        return line
    flips = []
    if cfg.is_moe and grad_err > tol:
        for i, (a, b) in enumerate(zip(
                lm_routes(torch, lm, cfg, params, batch),
                lm_routes(torch, lm, cfg, dparams, dbatch))):
            differ = (a.sort(dim=-1).values != b.sort(dim=-1).values).any(-1)
            flips += [{"router_call": i, "token": t}
                      for t in differ.nonzero().tolist()]
        line["route_flips"] = flips
    if cfg.family in LM_RECURRENT or flips:
        truth = lm_train_one(torch, lm, cfg, lm.common.tree_map(
            lambda a: a.float(), params), batch, cpu)
        line["grad_tol"] = (f"no farther from the float32 gradients than "
                            f"the CPU's bf16, x{LM_BF16_NOISE_RATIO}")
        line["bf16_noise_vs_f32_max_mean"] = noise_check(
            torch, cfg.name, "bf16 gradient", flat_cpu(torch, got["grads"]),
            flat_cpu(torch, want["grads"]), flat_cpu(torch, truth["grads"]),
            LM_BF16_NOISE_RATIO, labels=("card", "cpu"))
    else:
        check(grad_err <= tol, f"{name}: gradient {grad_leaf} off by "
              f"{grad_err} of its largest (tol {tol})")
    return line


def lm_train_bound(cfg, params, opt_name: str, tokens: int) -> dict:
    """The least time the card could take for a bf16 training step (H100
    SXM peaks): 6 flops a param a token over the params a token runs (an
    MoE layer's top_k experts of n_experts), against the bytes of the
    clip (reading and writing each bf16 gradient) and the update (AdamW
    reads the bf16 param and gradient and the float32 m and v and writes
    all but the gradient, 22 B a param; adafactor reads the param and
    gradient and writes the param, 6 B, its factored statistics
    negligible)."""
    n_all = tree_numel(params)
    n_exp = (sum(tree_numel(params["moe_layers"]["moe"].get(k))
                 for k in ("w1", "w2", "w3")) if cfg.is_moe else 0)
    n_active = n_all - n_exp + n_exp * cfg.top_k / max(cfg.n_experts, 1)
    ops = 6 * n_active * tokens
    per_param = 4 + {"adamw": 22, "adafactor": 6}[opt_name]
    ms, by = bound(n_all * per_param, ops, PEAK_16BIT_S)
    return {"params": n_all, "active_params": n_active, "bound_ops": ops,
            "bound_bytes": n_all * per_param, "bound_ms": ms,
            "bound_by": by}


def lm_train_full(torch, lm, name: str, spec: dict, seed: int, dev) -> dict:
    """One arch at published widths (depth cut by `spec`) trained on the
    card in bf16 from params drawn there: `spec`'s warm-up steps, then its
    timed steps (median ms a step, tokens a second, peak memory), one step
    split into forward / backward / clip + update, one step under the
    profiler; every loss and param finite, the batch's embedding rows
    moved."""
    uncut = lm.registry.ARCHS[name]
    cfg = dataclasses.replace(uncut, **spec["cut"])
    B, S = spec["batch"], spec["seq"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, _ = lm.common.split_pl(lm.tf.init_model(cfg, gen, device=dev))
    opt = lm_train_opt(lm, lm.steps.count_params(
        lm.steps.abstract_params(uncut)[0]))
    state = opt.init(params)
    rules = lm.sharding.make_rules(lm.elastic.make_mesh_from([dev], 1))
    step = lm.steps.build_train_step(cfg, rules, opt)
    batches = iter(lm_train_batch(lm, cfg, B, S, seed, i, dev)
                   for i in range(10 ** 6))
    first = next(batches)
    rows = torch.unique(first["tokens"])
    embed0 = params["embed"][rows].float()
    torch.cuda.synchronize()
    line = {"arch": cfg.name, "cut": spec["cut"], "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": "bfloat16",
            "dispatch": cfg.resolved_dispatch() if cfg.is_moe else None,
            "capacity_factor": cfg.capacity_factor if cfg.is_moe else None,
            "optimizer": opt.name, "batch": B, "seq": S,
            "tokens_per_step": B * S, "seed": seed,
            "init_s": time.perf_counter() - t0}
    losses = []

    def run_step(batch):
        nonlocal params, state
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()          # the update after the loss

    run_step(first)
    for _ in range(spec["warmup"] - 1):
        run_step(next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(spec["steps"]):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(batch)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    # one step in three synchronised parts, as build_train_step runs it
    batch = next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with lm.sharding.use_rules(rules):
        tracked, leaves = lm.steps.track(params)
        with torch.enable_grad():
            loss, _ = lm.tf.model_loss(tracked, cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = lm.steps.grads_of(loss, tracked, leaves)
        del tracked, leaves
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads, _ = lm.optim.clip_by_global_norm(grads, lm.steps.GRAD_CLIP)
        params, state = opt.update(grads, state, params)
        del grads
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    losses.append(float(loss.detach()))
    del loss
    batch = next(batches)
    prof = profile_run(torch, lambda: run_step(batch))
    moved = float((params["embed"][rows].float() - embed0).abs().max())
    check(all(math.isfinite(x) for x in losses),
          f"lm_train {cfg.name}: losses {losses}")
    check(all(bool(torch.isfinite(p).all())
              for _, p in named_leaves(params)),
          f"lm_train {cfg.name}: a param is not finite")
    check(moved > 0, f"lm_train {cfg.name}: the embedding did not move")
    med = sorted(ms)[len(ms) // 2]
    line.update(
        step_ms=med, step_ms_all=ms, tok_s=B * S / med * 1e3,
        split_ms={"forward": (t1 - t0) * 1e3, "backward": (t2 - t1) * 1e3,
                  "clip_update": (t3 - t2) * 1e3},
        peak_memory_gb=peak / 1e9, loss_first=losses[0],
        loss_last=losses[-1], losses=losses, embed_rows_moved=moved,
        profile_step=prof,
        kernels_a_step=prof["kernels_launched"],
        device_busy_share=prof["device_busy_share"],
        **lm_train_bound(cfg, params, opt.name, B * S))
    del params, state, step
    torch.cuda.empty_cache()
    return line


def lm_train_launch(torch, *arg_lists) -> list:
    """`python -m repro_torch.launch.train <args>` as a user runs it, on
    the card, for each of `arg_lists` (started together): exit 0, the
    card's name, the trained-steps and loss lines (finite), and its
    events, one dict each."""
    return [lm_train_result(args, out, seconds) for args, (out, seconds) in
            zip(arg_lists, run_launchers(
                torch, "repro_torch.launch.train", arg_lists,
                LM_TRAIN_LAUNCH_TIMEOUT_S))]


def lm_train_result(args, out: str, seconds: float) -> dict:
    import ast
    import re
    trained = re.findall(r"^trained (\d+) steps in ([\d.]+)s "
                         r"\(([\d.]+)s/step\)$", out, re.M)
    loss = re.findall(r"^loss: first=(\S+) last=(\S+)$", out, re.M)
    check(len(trained) == 1 and len(loss) == 1,
          f"train launcher {args} output:\n{out[-2000:]}")
    first, last = float(loss[0][0]), float(loss[0][1])
    check(math.isfinite(first) and math.isfinite(last),
          f"train launcher {args}: losses {first}, {last}")
    return {"args": args, "exit_code": 0, "seconds": seconds,
            "steps": int(trained[0][0]), "train_s": float(trained[0][1]),
            "loss_first": first, "loss_last": last,
            "events": [ast.literal_eval(e) for e in
                       re.findall(r"^event: (.*)$", out, re.M)]}


def ckpt_tensors(torch, directory: str, step: int) -> list:
    """A checkpoint's leaves as float32 CPU tensors (bf16 ones from their
    bits), read from the files."""
    import os
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    out = []
    for i, meta in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        t = torch.from_numpy(arr.view(np.int16) if meta["dtype"] ==
                             "bfloat16" else np.array(arr))
        out.append((t.view(torch.bfloat16) if meta["dtype"] == "bfloat16"
                    else t).float())
    return out


def ckpt_bytes(directory: str, step: int) -> dict:
    import os
    path = os.path.join(directory, f"step_{step:08d}")
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def memory_gb() -> dict:
    """The machine's available memory and this process's resident set,
    from /proc (GB)."""
    out = {}
    for path, key, name in (("/proc/meminfo", "MemAvailable:", "available"),
                            ("/proc/self/status", "VmRSS:", "rss")):
        with open(path) as f:
            for line in f:
                if line.startswith(key):
                    out[f"{name}_gb"] = int(line.split()[1]) * 1024 / 1e9
    return out


def lm_train_launch_phase(torch, lm) -> dict:
    """The training launcher as users run it (LM_TRAIN_LAUNCH*): the
    injected failure's events, and its final checkpoint against the
    uninterrupted run's (bit for bit; else within the spread of two
    uninterrupted runs); the full-size run into a temporary directory,
    removed afterwards, with each checkpoint's bytes and write seconds
    (from the first leaf file's mtime to the manifest's: the first leaf's
    own write is not counted); the reduced MoE + MTP and enc-dec archs."""
    import os
    import shutil
    out = {}
    n = int(LM_TRAIN_LAUNCH[LM_TRAIN_LAUNCH.index("--steps") + 1])
    every = int(LM_TRAIN_LAUNCH[LM_TRAIN_LAUNCH.index("--ckpt-every") + 1])
    restored = LM_TRAIN_FAIL_AT - 1 - (LM_TRAIN_FAIL_AT - 1) % every
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # the two runs, and the reduced archs', side by side: the card
        # idles through their start-up; only the full-size run is timed
        # alone
        fail, whole, *reduced = lm_train_launch(
            torch, LM_TRAIN_LAUNCH + [
                "--inject-failure", str(LM_TRAIN_FAIL_AT), "--ckpt-dir",
                os.path.join(tmp, "fail")],
            LM_TRAIN_LAUNCH + ["--ckpt-dir", os.path.join(tmp, "whole")],
            *[["--arch", arch, "--reduced", "--steps", "4", "--ckpt-dir",
               os.path.join(tmp, arch)] for arch in LM_TRAIN_LAUNCH_ARCHS])
        want = [("failure", LM_TRAIN_FAIL_AT,
                 f"injected loss at step {LM_TRAIN_FAIL_AT}"),
                ("remesh", restored + 1, 1)]
        check([e for e in fail["events"] if e[0] != "straggler"] == want,
              f"train launcher events {fail['events']}, not {want}")
        check(fail["steps"] == n + LM_TRAIN_FAIL_AT - restored - 1
              and whole["steps"] == n, f"steps {fail['steps']}, "
              f"{whole['steps']}")
        same = (ckpt_bytes(os.path.join(tmp, "fail"), n - 1)
                == ckpt_bytes(os.path.join(tmp, "whole"), n - 1))
        recovery = {"events": fail["events"], "final_checkpoint_equal": same,
                    "loss_last": [fail["loss_last"], whole["loss_last"]],
                    "seconds": [fail["seconds"], whole["seconds"]]}
        if not same:
            again, = lm_train_launch(torch, LM_TRAIN_LAUNCH + [
                "--ckpt-dir", os.path.join(tmp, "again")])
            a, b, c = (ckpt_tensors(torch, os.path.join(tmp, d), n - 1)
                       for d in ("fail", "whole", "again"))
            diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
            spread = max(float((y - z).abs().max()) for y, z in zip(b, c))
            recovery.update(max_abs_diff=diff, uninterrupted_spread=spread,
                            again_seconds=again["seconds"])
            check(spread > 0 and diff <= spread, f"train launcher: the "
                  f"recovered run's final params differ from the "
                  f"uninterrupted run's by {diff}, two uninterrupted runs "
                  f"by {spread}")
        else:
            check(fail["loss_last"] == whole["loss_last"],
                  f"train launcher last losses {recovery['loss_last']}")
        out["recovery"] = recovery
        for r in reduced:
            check(r["steps"] == 4 and not r["events"],
                  f"train launcher {r['args']}: {r}")
        out["reduced"] = reduced
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_full_") as d:
        free = shutil.disk_usage(d).free
        mem = memory_gb()
        check(mem["available_gb"] >= LM_TRAIN_FULL_RUN_RAM_GB,
              f"full-size train launcher: {mem} available, it needs "
              f"{LM_TRAIN_FULL_RUN_RAM_GB} GB")
        r, = lm_train_launch(torch, LM_TRAIN_LAUNCH_FULL + ["--ckpt-dir", d])
        check(not r["events"], f"full-size train launcher events "
              f"{r['events']}")
        saves = []
        for st in lm.ckpt.latest_steps(d):
            path = os.path.join(d, f"step_{st:08d}")
            names = os.listdir(path)
            saves.append({
                "step": st,
                "bytes": sum(os.path.getsize(os.path.join(path, x))
                             for x in names),
                "write_s": (os.path.getmtime(os.path.join(
                    path, "manifest.json")) - os.path.getmtime(
                        os.path.join(path, "leaf_00000.npy")))})
        check(len(saves) == 2, f"full-size checkpoints {saves}")
        r.update(disk_free_gb=free / 1e9, memory_before=mem,
                 checkpoints=saves)
        out["full_size"] = r
    return out


def lm_train_phase(torch, seed, dev) -> dict:
    """Language-model training on the card. (1) Each arch's reduced config
    in float32 and bf16, and LM_TRAIN_WIDE_CUTS in float32: one step card
    against the CPU (`lm_train_card_vs_cpu`). (2) LM_TRAIN_FULL at
    published widths in bf16, timed (`lm_train_full`, one `lm_train_full`
    line each). (3) The training launcher as users run it
    (`lm_train_launch_phase`)."""
    lm = lm_modules()
    t_phase = time.perf_counter()
    seconds = {}
    memory = {"start": memory_gb()}
    t0 = time.perf_counter()
    parity = []
    for i, name in enumerate(LM_ARCHS):
        for dtype in ("float32", "bfloat16"):
            parity.append(lm_train_card_vs_cpu(
                torch, lm, lm.registry.reduced(lm.registry.ARCHS[name]),
                dtype, seed + i, dev))
    seconds["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = []
    for name, cut in LM_TRAIN_WIDE_CUTS.items():
        row = lm_train_card_vs_cpu(torch, lm, dataclasses.replace(
            lm.registry.ARCHS[name], **cut), "float32", seed, dev)
        row["cut"] = cut
        wide.append(row)
        torch.cuda.empty_cache()
    seconds["full_width"] = time.perf_counter() - t0
    full = []
    for name, spec in LM_TRAIN_FULL.items():
        t0 = time.perf_counter()
        row = lm_train_full(torch, lm, name, spec, seed, dev)
        row["seconds"] = time.perf_counter() - t0
        emit({"phase": "lm_train_full", **row})
        full.append(row)
    seconds["full_size"] = sum(r["seconds"] for r in full)
    t0 = time.perf_counter()
    launch = lm_train_launch_phase(torch, lm)
    seconds["launch"] = time.perf_counter() - t0
    memory["end"] = memory_gb()
    return {"phase": "lm_train", "seconds": time.perf_counter() - t_phase,
            "part_seconds": seconds, "memory": memory,
            "card_vs_cpu": parity,
            "full_width": wide,
            "full_size": [{k: r[k] for k in (
                "arch", "cut", "optimizer", "step_ms", "split_ms", "tok_s",
                "peak_memory_gb", "loss_first", "loss_last", "bound_ms",
                "bound_by", "kernels_a_step", "device_busy_share")}
                for r in full],
            "launch": launch}


def kernel_ops_inputs(torch, field, cfg, cam, rendering, sparse, seed, dev):
    """The kernel_ops phase's inputs, made before its launch counts are
    reset: the bitmap operand per dtype, the volume samples per case (the
    first VR_RAYS rays of `cam`; the middle ones, their density scaled by
    VR_OPAQUE_SCALE), and q, k, v per dtype."""
    rng = np.random.default_rng(seed + 12)
    w = field.factors["app_planes"][0].decode().cpu().numpy()
    x = rng.standard_normal((w.shape[1], BITMAP_N), dtype=np.float32)
    bitmap = {}
    for dt in (np.float32, np.float16):
        enc = sparse.encode_bitmap(w.astype(dt), device=dev)
        bitmap[np.dtype(dt).name] = (
            enc, torch.from_numpy(x.astype(dt)).to(dev),
            torch.from_numpy(w.astype(dt)).to(dev))
    origins, dirs = rendering.camera_rays(cam)
    side = math.isqrt(VR_RAYS)
    rows = torch.arange(side, device=dev) + (cam.h - side) // 2
    cols = torch.arange(side, device=dev) + (cam.w - side) // 2
    middle = (rows[:, None] * cam.w + cols[None, :]).reshape(-1)
    sig_mid, rgb_mid = uniform_samples(torch, field, cfg, rendering,
                                       origins[middle], dirs[middle])
    volume = {"first_rays": uniform_samples(torch, field, cfg, rendering,
                                            origins[:VR_RAYS],
                                            dirs[:VR_RAYS]),
              "middle_rays_opaque": (sig_mid * VR_OPAQUE_SCALE, rgb_mid)}
    B, H, Hkv, S, D = (FLASH_SHAPE[k] for k in ("B", "H", "kv_heads", "S",
                                                 "D"))

    def heads(n):
        a = rng.standard_normal((B, n, S, D), dtype=np.float32)
        return torch.from_numpy(a).to(dev)
    q = heads(H)
    k, v = (heads(Hkv).repeat_interleave(H // Hkv, dim=1).contiguous()
            for _ in range(2))
    flash = {"float32": (q, k, v),
             "bfloat16": tuple(t.to(torch.bfloat16) for t in (q, k, v))}
    return bitmap, volume, flash


def sdpa_backend(torch, q, k, v) -> dict:
    """The SDPA backend that the default call runs on these inputs: each
    backend alone (`torch.nn.attention.sdpa_kernel`), the ones that run,
    and the one whose output equals the default call's bit for bit."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    default = sdpa(q, k, v, is_causal=True)
    runs, same = [], []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                out = sdpa(q, k, v, is_causal=True)
        except RuntimeError:
            continue
        runs.append(b.name)
        if torch.equal(out, default):
            same.append(b.name)
        del out
    return {"library_backend": same[0] if len(same) == 1 else
            (same or "not identified"), "library_backends_that_run": runs}


def kernel_ops_rows(torch, mods, inputs, cfg, rendering, launches, hgmma):
    """One {"kernels"} row per kernel of the kernel_ops phase: the first
    dtype in the row, the other under "cases". `hgmma`: HGMMA lines in the
    SASS of each flash kernel, by dtype."""
    bitmap_decode, volume_render, flash_attention = mods
    bitmap, volume, flash = inputs
    rows = []

    cases = []
    for dt, (enc, x, w_dense) in bitmap.items():
        cols = enc.shape[1]
        args = (enc.words, enc.rowptr, enc.values, x)
        want = bitmap_decode.bitmap_matmul_ref(*args, cols)
        got = bitmap_decode.bitmap_matmul(*args, cols=cols)
        scale = 1.0 + bitmap_decode.bitmap_matmul_ref(
            enc.words, enc.rowptr, enc.values.abs(), x.abs(), cols).float()
        torch.cuda.synchronize()
        ea, er = errors(torch, got, want)
        es = float(((got.float() - want.float()).abs() / scale).max())
        tol = BITMAP_TOL[dt]
        if dt == "float32":
            frac, tol_on = es / tol, "1 + |W| @ |x|"
        else:
            frac = over_limit(got, want, tol, tol)
            tol_on = "result (rtol = atol)"
        check(frac <= 1.0, f"bitmap_matmul {dt} vs plain: abs {ea} rel {er}, "
              f"over |W|@|x| {es}, {frac} of the limit")
        esz = x.element_size()
        b_bytes = (nbytes(enc.words, enc.rowptr) + enc.nnz * esz
                   + nbytes(x) + enc.shape[0] * x.shape[1] * esz)
        b_ops = 2 * enc.nnz * x.shape[1]
        b_ms, b_by = bound(b_bytes, b_ops,
                           PEAK_FP32_S if dt == "float32" else PEAK_16BIT_S)
        cases.append({
            "dtype": dt, "max_abs_err": ea, "max_rel_err": er,
            "max_err_over_abs_product": es, "tol": tol, "tol_on": tol_on,
            "max_err_over_limit": frac,
            **timing_keys(torch, lambda: bitmap_decode.bitmap_matmul(
                *args, cols=cols),
                lambda: bitmap_decode.bitmap_matmul_ref(*args, cols)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.matmul(w_dense, x),
                                  50)[0],
            "library": "torch.matmul on the decoded dense W",
            "shape": {"rows": enc.shape[0], "cols": cols, "n": x.shape[1],
                      "nnz": enc.nnz, "density": enc.nnz / (enc.shape[0]
                                                             * cols)},
            "plan": bitmap_decode.matmul_plan(
                enc.shape[0], enc.words.shape[1], x.shape[1],
                bitmap_decode.sm_count(x.device))._asdict(),
            "bytes": b_bytes, "ops": b_ops})
    rows.append({"name": "bitmap_matmul", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/bitmap_matmul.cu",
                 "replaces": "src/repro/kernels/bitmap_decode.py:96",
                 "launches": launches["bitmap_matmul"], **cases[0],
                 "cases": cases[1:]})

    delta, eps = rendering.step_world(cfg), cfg.term_eps
    cases = []
    for case, (sigma, rgb) in volume.items():
        got = volume_render.volume_render(sigma, rgb, delta=delta,
                                          term_eps=eps)
        want = volume_render.volume_render_ref(sigma, rgb, delta, eps)
        torch.cuda.synchronize()
        ea, er = errors(torch, got[:2], want[:2])
        check(all(torch.allclose(g, w, rtol=0.0, atol=VR_TOL)
                  for g, w in zip(got[:2], want[:2])),
              f"volume_render {case} vs plain: abs {ea} rel {er}")
        ok, n_diff, at_eps = nproc_ok(torch, got[2], want[2], sigma, delta,
                                      eps)
        check(ok, f"volume_render {case} nproc {float(got[2])} vs "
              f"{float(want[2])}, {at_eps} samples at term_eps")
        R, N = sigma.shape
        nproc = int(got[2])
        terminated = int((got[1] <= eps).sum())
        if case == "middle_rays_opaque":
            check(terminated > 0 and nproc < R * N,
                  f"volume_render {case}: {terminated} rays terminated, "
                  f"nproc {nproc} of {R * N}")
        v_bytes = nproc * 16 + R * 16
        v_ops = nproc * 20
        b_ms, b_by = bound(v_bytes, v_ops)
        tau = sigma * delta
        alive = (torch.exp(-(torch.cumsum(tau, dim=-1) - tau)) > eps).sum(-1)
        vec = volume_render.vector_loads(sigma, rgb)
        # the bytes the kernel's copies read, as it counts them (a launch
        # of its counting build), against what the design should read
        counted, read = volume_render.volume_render_read(
            sigma, rgb, delta=delta, term_eps=eps)
        predicted = volume_render.read_bytes(alive, N, vec)
        # a sample at term_eps that the kernel's sum order keeps alive (or
        # not) moves its rgb and, at a segment's end, the next segment's
        # sigma: exact otherwise
        slack = at_eps * (4 * volume_render.SEGMENT + 16)
        check(abs(read - predicted) <= slack and all(
            torch.equal(g, w) for g, w in zip(counted, got)),
              f"volume_render {case}: the kernel read {read} bytes, the "
              f"design {predicted} (slack {slack}), or its counting launch "
              f"differs")
        cases.append({
            "case": case, "max_abs_err": ea, "max_rel_err": er,
            "tol": VR_TOL, "nproc": nproc, "nproc_plain": float(want[2]),
            "nproc_diff": n_diff, "samples_at_term_eps": at_eps,
            **timing_keys(torch, lambda: volume_render.volume_render(
                sigma, rgb, delta=delta, term_eps=eps),
                lambda: volume_render.volume_render_ref(sigma, rgb, delta,
                                                        eps)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "full_read_bytes": R * N * 16 + R * 16,
            "read_bytes": read, "read_bytes_predicted": predicted,
            "vector_loads": vec,
            "shape": {"R": R, "N": N, "delta": delta, "term_eps": eps,
                      "terminated_rays": terminated},
            "bytes": v_bytes, "ops": v_ops})
        cases[-1]["share_of_bound"] = b_ms / cases[-1]["ms"]
    rows.append({"name": "volume_render", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/volume_render.cu",
                 "replaces": "src/repro/kernels/volume_render.py:56",
                 "launches": launches["volume_render"], **cases[0],
                 "cases": cases[1:]})

    cases = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dt, (q, k, v) in flash.items():
        got = flash_attention.flash_attention(q, k, v, causal=True)
        want = flash_attention.flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        ea, er = errors(torch, got, want)
        rtol, atol = FLASH_TOL[dt]
        frac = over_limit(got, want, rtol, atol)
        check(frac <= 1.0, f"flash_attention {dt} vs plain: abs {ea} rel "
              f"{er}, {frac} of the limit")
        B, H, S, D = q.shape
        f_ops = 4 * B * H * S * S * D // 2
        f_bytes = 4 * nbytes(q)
        peak = PEAK_FP32_S if dt == "float32" else PEAK_16BIT_S
        b_ms, b_by = bound(f_bytes, f_ops, peak)
        bounds = {}
        if dt == "float32":
            # fp32's precision costs three TF32 products on the tensor
            # cores, the route the kernel takes, or one fp32 FMA each on
            # the CUDA cores: the lesser time bounds it
            tc_ms, tc_by = bound(f_bytes, 3 * f_ops, PEAK_TF32_S)
            bounds = {"bound_cuda_cores_ms": b_ms, "bound_3xtf32_ms": tc_ms,
                      "bound_used": "3xtf32: 3 x ops at 495 TFLOP/s (TF32 "
                                    "tensor cores)"}
            b_ms, b_by, peak = tc_ms, tc_by, PEAK_TF32_S / 3
        cases.append({
            "dtype": dt, "max_abs_err": ea, "max_rel_err": er,
            "tol": atol, "rtol": rtol, "max_err_over_limit": frac,
            **timing_keys(torch, lambda: flash_attention.flash_attention(
                q, k, v, causal=True),
                lambda: flash_attention.flash_attention_ref(q, k, v,
                                                            causal=True),
                plain_iters=3),
            "bound_ms": b_ms, "bound_by": b_by, "peak_ops_s": peak, **bounds,
            "library_ms": time_ms(torch, lambda: sdpa(q, k, v,
                                                      is_causal=True), 50)[0],
            **sdpa_backend(torch, q, k, v),
            "shape": {"B": B, "H": H, "S": S, "D": D,
                      "kv_heads": FLASH_SHAPE["kv_heads"], "causal": True},
            "bytes": f_bytes, "ops": f_ops})
        cases[-1].update({"share_of_bound": b_ms / cases[-1]["ms"],
                          "sass_hgmma": hgmma[dt] > 0,
                          "sass_hgmma_lines": hgmma[dt]})
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:64",
                 "launches": launches["flash_attention"], **cases[0],
                 "cases": cases[1:]})
    return rows


def bitmap_gather_row(torch, bitmap_decode, captured, launches) -> dict:
    """The bitmap gather kernel on the serve path's largest call."""
    (words, rowptr, values, q), kw, nq = captured
    cols, rank = kw["cols"], kw["rank"]

    def run_k():
        return bitmap_decode.bitmap_gather(words, rowptr, values, q,
                                           cols=cols, rank=rank)

    def run_p():
        return bitmap_decode.bitmap_gather_ref(words, rowptr, values, q, cols,
                                               rank=rank)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "bitmap_gather kernel differs from plain")
    ea, er = errors(torch, got, want)
    stream_bytes = nbytes(words, rowptr, values, rank)
    g_bytes, g_ops = nq * 8 + stream_bytes, nq * 12
    b_ms, b_by = bound(g_bytes, g_ops)
    return {"name": "bitmap_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitmap_gather.cu",
            "replaces": "src/repro/kernels/bitmap_decode.py:68",
            "launches": launches, "max_abs_err": ea, "max_rel_err": er,
            "tol": 0.0, **timing_keys(torch, run_k, run_p), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": {"Q": nq, "stream_bytes": stream_bytes},
            "bytes": g_bytes, "ops": g_ops}


def coo_gather_row(torch, coo_gather, cap, launches, seed) -> dict:
    """The COO gather kernel on the serve path's first largest call
    (occupancy chunk 0, at the grid's edge), with cases: the same slice's
    call in the middle occupancy chunk, and a shuffled copy of the first
    call's queries (every tile wide). Each case is checked bit-exact
    against the plain version before it is timed. `staged_tile_share` is
    the kernel's own count of the tiles it staged in shared memory, held
    against the count that the windows of the inputs predict
    (`tile_windows`, which also gives `window_mean` and `window_max`)."""
    (coords, values, q0), _kw, _nq = cap.gathers["coo"]
    check(cap.coo_at_call is not None
          and cap.coo_at_call[2].shape == q0.shape,
          "the middle occupancy chunk's COO call was not captured")
    perm = torch.from_numpy(np.random.default_rng(seed + 14).permutation(
        q0.shape[0])).to(q0.device)
    cases = [("occupancy_chunk_0", cap.gathers["coo"][0]),
             ("occupancy_chunk_middle", cap.coo_at_call),
             ("shuffled_chunk_0", (coords, values, q0[perm].contiguous()))]
    out = []
    for case, (c, v, q) in cases:
        got, staged = coo_gather.coo_gather_staged(c, v, q)
        want = coo_gather.coo_gather_ref(c, v, q)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"coo_gather kernel differs from plain ({case})")
        ea, er = errors(torch, got, want)
        win = coo_gather.tile_windows(c, q)
        predicted = int((win <= coo_gather.CAPACITY).sum())
        check(staged == predicted,
              f"coo_gather staged {staged} tiles, the windows predict "
              f"{predicted} ({case})")
        nq = q.shape[0]
        stream_bytes = nbytes(c, v)
        g_bytes = nq * 8 + stream_bytes
        g_ops = nq * 4 * coo_gather.search_steps(c.shape[0])
        b_ms, b_by = bound(g_bytes, g_ops)
        out.append({
            "case": case, "max_abs_err": ea, "max_rel_err": er, "tol": 0.0,
            **timing_keys(torch, lambda: coo_gather.coo_gather(c, v, q),
                          lambda: coo_gather.coo_gather_ref(c, v, q)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "staged_tile_share": staged / win.shape[0],
            "window_mean": float(win.double().mean()),
            "window_max": int(win.max()), "capacity": coo_gather.CAPACITY,
            "shape": {"Q": nq, "tiles": win.shape[0],
                      "stream_entries": c.shape[0],
                      "stream_bytes": stream_bytes},
            "bytes": g_bytes, "ops": g_ops})
    return {"name": "coo_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/coo_gather.cu",
            "replaces": "src/repro/kernels/coo_gather.py:40",
            "launches": launches, **out[0], "cases": out[1:]}


def profile_chunk(torch, engine, rendering, dev) -> dict:
    """One 64 x 64 view (one ray chunk) under torch.profiler: wall time,
    the device's busy share (summed kernel time over wall time) and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    cam = rendering.look_at_camera([3.0, -2.5, 1.8], [0.0, 0.0, 0.0], 76.8,
                                   64, 64, device=dev)
    engine.submit(cam).result()                  # ordering cached, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.submit(cam).result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, stages = [], {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.key.startswith("rtnerf."):
            # the renderer's record_function ranges: their device time
            # spans the kernels inside them, so it is not added again
            stages[e.key] = {"device_ms": us * 1e-3,
                             "host_ms": e.cpu_time_total * 1e-3,
                             "calls": e.count}
        elif e.device_type.name == "CUDA" and us > 0:
            rows.append((us, e.key, e.count))
    busy_s = sum(r[0] for r in rows) * 1e-6
    rows.sort(reverse=True)
    return {"phase": "profile", "wall_s": wall,
            "steps": engine.cfg.max_cubes // engine.cube_chunk,
            "device_busy_s": busy_s if rows else "not measured",
            "device_busy_share": busy_s / wall if rows else "not measured",
            "top_kernels": [{"name": k[:80], "device_ms": us * 1e-3,
                             "calls": n} for us, k, n in rows[:8]],
            "stages": stages}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--res", type=int, default=200)
    args = ap.parse_args()
    if args.res < 64:
        ap.error("--res must be at least 64 (the middle 64 x 64 rays feed "
                 "the kernel_ops phase)")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.rtnerf import NeRFConfig
    from repro_torch.core import field as field_lib
    from repro_torch.core import occupancy as occ_lib
    from repro_torch.core import pipeline, rendering, sparse, tensorf, train
    from repro_torch.data import rays
    from repro_torch.kernels import (_build, bitmap_decode, coo_gather,
                                     flash_attention, fused_sample, ops,
                                     volume_render)
    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.serving import FineTuneLoop, FleetRouter, RenderEngine
    from repro_torch.serving import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- device -----------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log = _build.build_log()
    hgmma = {dt: sass_count(lib, _build.find_nvcc(), f"flash_{name}_kernel",
                            "HGMMA")
             for dt, name in (("bfloat16", "bf16"), ("float32", "f32"))}
    for dt, n in hgmma.items():
        check(n > 0, f"no HGMMA in the SASS of the {dt} flash kernel")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
          "flash_bf16_hgmma": hgmma["bfloat16"],
          "flash_f32_hgmma": hgmma["float32"],
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    # -- lm_train: language-model training on the card, first: its
    # full-size launcher run needs the machine's memory (LM_TRAIN_FULL_*)
    emit(lm_train_phase(torch, args.seed, dev))
    torch.cuda.empty_cache()

    # -- lm: language-model serving of the ten archs on the card, its six
    # launcher runs side by side while the machine's memory is free ------
    emit(lm_phase(torch, args.seed, dev))
    torch.cuda.empty_cache()

    # -- lm_mesh: language-model serving across ranks sharing the card,
    # and in the same ranks the train step (its lm_mesh_train line) ------
    for line in lm_mesh_phase(torch, args.seed, dev):
        emit(line)
    torch.cuda.empty_cache()

    # -- field ------------------------------------------------------------
    t0 = time.perf_counter()
    cfg = NeRFConfig()
    params = {k: torch.from_numpy(v).to(dev)
              for k, v in object_field(cfg, args.seed).items()}
    field = field_lib.DenseField(params, cfg).prune(tol=1e-3).encode()
    fmts = field.formats()
    flat_fmts = {f for fs in fmts.values() for f in fs}
    sigma_fmts = set(fmts["sigma_planes"] + fmts["sigma_lines"])
    check({"bitmap", "coo"} <= flat_fmts and flat_fmts <= {
        "bitmap", "coo", "dense"}, f"formats {fmts}")
    check({"bitmap", "coo"} <= sigma_fmts,
          f"occupancy must gather both formats, sigma slices are {sigma_fmts}")
    occ = occ_lib.build_occupancy(field, cfg)
    n_cubes = occ_lib.extract_cubes(occ, cfg).count
    check(100 <= n_cubes < cfg.max_cubes, f"{n_cubes} cubes")
    emit({"phase": "field", "seconds": time.perf_counter() - t0,
          "formats": fmts, "factor_bytes": field.factor_bytes(),
          "dense_factor_bytes": field.dense_factor_bytes(),
          "compression_ratio": field.compression_ratio(), "cubes": n_cubes,
          "window": tensorf.fused_window(cfg),
          "samples_per_segment": pipeline.samples_per_segment(cfg)})

    # -- serve: the main path, with every launch counter read around it ---
    kernels = {"fused_sigma_app": fused_sample.fused_sigma_app,
               "bitmap_gather": bitmap_decode.bitmap_gather,
               "coo_gather": coo_gather.coo_gather}
    cams = [rendering.look_at_camera(
        [4.0 * math.cos(a) * math.cos(0.5), 4.0 * math.sin(a) * math.cos(0.5),
         4.0 * math.sin(0.5)], [0.0, 0.0, 0.0], 1.2 * args.res, args.res,
        args.res, device=dev)
        for a in 2 * math.pi * (np.arange(args.views) + 0.125) / args.views]
    # the occupancy build gathers every COO sigma slice once per chunk of
    # OCC_CHUNK grid points, plane 0 first: the middle chunk's first call,
    # for the coo row
    n_chunks = -(-cfg.occ_res ** 3 // OCC_CHUNK)
    coo_per_chunk = (fmts["sigma_planes"] + fmts["sigma_lines"]).count("coo")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Capture(torch, ops, pipeline,
                 n_chunks // 2 * coo_per_chunk) as cap:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        engine = RenderEngine(cfg, field, device=dev)
        torch.cuda.synchronize()
        t_engine = time.perf_counter() - t0
        futs = [engine.submit(c) for c in cams]
        engine.flush()
        results = [f.result() for f in futs]
        launches = {name: k.launches for name, k in kernels.items()}
    t_serve = time.perf_counter() - t0
    st = engine.stats()
    steps = (len(cams) * -(-args.res ** 2 // engine.ray_chunk)
             * (cfg.max_cubes // engine.cube_chunk))
    emit({"phase": "serve", "engine_setup_s": t_engine, "serve_s": t_serve,
          "scan_steps": steps,
          "step_ms": t_serve / steps * 1e3,
          "cubes": engine.cubes.count, "views": len(results),
          "res": args.res, "fps": st["fps"],
          "latency_p50_s": st["latency_p50_s"],
          "latency_p99_s": st["latency_p99_s"], "flushes": st["flushes"],
          "pair_budget": st["pair_budget"],
          "pair_budget_initial": st["pair_budget_initial"],
          "dropped_pairs": st["dropped_pairs"],
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(engine.cubes.count == n_cubes, "engine built another cube set")
    for r in results:
        img = r.img
        fg = float(np.mean(np.abs(img - 1.0).max(axis=-1) > 0.05))
        emit({"phase": "view", "view_id": r.view_id,
              "latency_s": r.latency_s, "fps": st["fps"],
              "active_pairs_max": r.stats["active_pairs_max"],
              "dropped_pairs": r.stats["dropped_pairs"],
              "processed_samples": r.stats["processed_samples"],
              "dispatch_path": r.stats["dispatch_path"],
              "foreground_fraction": fg,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        check(r.stats["dispatch_path"] == "fused",
              f"view {r.view_id} took {r.stats['dispatch_path']}")
        check(img.shape == (args.res * args.res, 3)
              and bool(np.isfinite(img).all()), f"view {r.view_id} image")
        check(fg > 0.01, f"view {r.view_id} is all background ({fg})")
        check(isinstance(r.stats["active_pairs_max"], int)
              and isinstance(r.stats["dropped_pairs"], int)
              and r.stats["active_pairs_max"] > 0,
              f"view {r.view_id} counters {r.stats}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched while serving")
    check(launches["coo_gather"] == n_chunks * coo_per_chunk,
          f"coo_gather launched {launches['coo_gather']} times, not once per "
          f"occupancy chunk and COO sigma slice ({n_chunks} x "
          f"{coo_per_chunk})")

    # -- parity: a small view, card against the CPU plain versions --------
    # same config, field and cubes; a 128-ray chunk keeps the CPU side to
    # seconds (the ray chunk is traffic, not model width)
    t0 = time.perf_counter()
    small = rendering.look_at_camera([3.2, 2.0, 1.6], [0.0, 0.0, 0.0], 12.0,
                                     10, 10, device="cpu")
    got = RenderEngine(cfg, field, engine.cubes, device=dev,
                       ray_chunk=128).submit(small).result()
    want = RenderEngine(cfg, field.to("cpu"), engine.cubes, device="cpu",
                        ray_chunk=128).submit(small).result()
    img_err = float(np.abs(got.img - want.img).max())
    emit({"phase": "parity", "seconds": time.perf_counter() - t0,
          "res": 10, "max_abs_err": img_err, "tol": PARITY_TOL,
          "active_pairs_max": [got.stats["active_pairs_max"],
                               want.stats["active_pairs_max"]],
          "cpu_dispatch_path": want.stats["dispatch_path"]})
    check(want.stats["dispatch_path"] == "fused_ref", "CPU path")
    check(got.stats["active_pairs_max"] > 0, "parity view is empty")
    check(img_err <= PARITY_TOL, f"card vs CPU image error {img_err}")

    # -- profile: where one 4096-ray chunk's 1024 scan steps spend time ---
    emit(profile_chunk(torch, engine, rendering, dev))

    # -- the serving tier: store, delta, auto-flush, per-op route, geometry
    m = types.SimpleNamespace(
        field_lib=field_lib, occ_lib=occ_lib, rendering=rendering,
        tensorf=tensorf, fused_sample=fused_sample, pipeline=pipeline,
        train=train, rays=rays, ops=ops, coo_gather=coo_gather,
        RenderEngine=RenderEngine, FineTuneLoop=FineTuneLoop, fleet=fleet,
        FleetRouter=FleetRouter, ckpt=ckpt_lib)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spill_") as spill:
        line, store_engine = store_phase(torch, m, cfg, args.seed, dev, spill,
                                         kernels)
        emit(line)
        emit(delta_phase(torch, m, cfg, field, engine.cubes, dev, kernels))
        emit(auto_flush_phase(torch, m, store_engine, ("s0", "s1"), dev,
                              kernels))
        del store_engine
    emit(per_op_route_phase(torch, m, cfg, field, dev, kernels))
    emit(geometry_phase(torch, m, cfg, field, cams, dev))

    # -- eval: render_rtnerf, the uniform baseline and the ground truth at
    # 800 x 800, each against the CPU; the kernels at the eval shapes ----
    line, captured = eval_phase(torch, m, cfg, field, engine.cubes, dev,
                                kernels)
    t0 = time.perf_counter()
    eval_entries = eval_kernel_entries(
        torch, (fused_sample, bitmap_decode, coo_gather), captured, cfg)
    line["kernel_timing_s"] = time.perf_counter() - t0
    emit(line)
    del captured

    # -- kernel_ops: the ops entry points beside the serve path -----------
    t0 = time.perf_counter()
    op_inputs = kernel_ops_inputs(torch, field, cfg, cams[0], rendering,
                                  sparse, args.seed, dev)
    bitmap_in, volume_in, flash_in = op_inputs
    all_kernels = {**kernels,
                   "bitmap_matmul": bitmap_decode.bitmap_matmul,
                   "volume_render": volume_render.volume_render,
                   "flash_attention": flash_attention.flash_attention}
    torch.cuda.synchronize()
    for k in all_kernels.values():
        k.launches = 0
    for enc, x, _w in bitmap_in.values():
        ops.bitmap_matmul(enc.words, enc.rowptr, enc.values, x,
                          cols=enc.shape[1])
    for sigma, rgb in volume_in.values():
        ops.volume_render(sigma, rgb, delta=rendering.step_world(cfg),
                          term_eps=cfg.term_eps)
    for q, k, v in flash_in.values():
        ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ops_launches = {name: k.launches for name, k in all_kernels.items()}
    emit({"phase": "kernel_ops", "seconds": time.perf_counter() - t0,
          "launches": ops_launches,
          "bitmap_operand": {"shape": list(bitmap_in["float32"][0].shape),
                             "nnz": bitmap_in["float32"][0].nnz,
                             "formats_in_field": fmts["app_planes"]},
          "volume_samples": {case: list(v[0].shape)
                             for case, v in volume_in.items()},
          "volume_opaque_scale": VR_OPAQUE_SCALE,
          "flash_shape": FLASH_SHAPE})
    for name in ("bitmap_matmul", "volume_render", "flash_attention"):
        check(ops_launches[name] > 0,
              f"{name} was not launched through kernel_ops")
    ops_rows = kernel_ops_rows(torch, (bitmap_decode, volume_render,
                                       flash_attention), op_inputs, cfg,
                               rendering, ops_launches, hgmma)
    del op_inputs, bitmap_in, volume_in, flash_in

    # -- train: NerfTrainer, the backward kernels, card against CPU, train
    # then serve, FineTuneLoop ---------------------------------------------
    line, train_entries, bwd_rows = train_phase(
        torch, m, cfg, field, engine, dev, (ops, bitmap_decode, coo_gather))
    emit(line)

    # -- fleet: worker processes on the card behind the consistent-hash
    # router; launch: the serving launcher, three runs as a user's --------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as root:
        line, fleet_entries = fleet_phase(torch, m, cfg, args.seed, dev,
                                          kernels, root)
        emit(line)
        line = launch_phase(torch, root)
        emit(line)
        # -- mesh: the engine across ranks, gpipe, the launcher under
        # torchrun (restoring the launch phase's lego) ---------------------
        train_psnr = {k: v for k, v in line["runs"][0]["psnr"].items()
                      if k.startswith("lego ")}
        line, mesh_entries = mesh_phase(torch, m, cfg, field, dev, root,
                                        train_psnr)
        emit(line)


    # -- kernels: each against its plain version on captured inputs ------
    rows = []
    fargs, fkw, hits = cap.fused_inputs()
    spec, streams, basis, pts, base, cid = fargs
    got = fused_sample.fused_sigma_app(*fargs, **fkw)
    want = fused_sample.fused_sigma_app_ref(*fargs, **fkw)
    torch.cuda.synchronize()
    ea, er = errors(torch, got, want)
    for g, w in zip(got, want):
        check(torch.allclose(g, w, rtol=FUSED_TOL, atol=FUSED_TOL),
              f"fused kernel vs plain: abs {ea} rel {er}")
    runs = cube_runs(cid)
    check(runs <= 2, f"captured cube_id in {runs} ascending runs, not the "
          f"serve step's two")
    # the same points in a shuffled order: up to C cubes per tile
    perm = torch.from_numpy(np.random.default_rng(args.seed + 13)
                            .permutation(pts.shape[0])).to(dev)
    sargs = (spec, streams, basis, pts[perm].contiguous(), base,
             cid[perm].contiguous())
    got_s = fused_sample.fused_sigma_app(*sargs, **fkw)
    want_s = fused_sample.fused_sigma_app_ref(*sargs, **fkw)
    torch.cuda.synchronize()
    ea_s, er_s = errors(torch, got_s, want_s)
    for g, w in zip(got_s, want_s):
        check(torch.allclose(g, w, rtol=FUSED_TOL, atol=FUSED_TOL),
              f"fused kernel vs plain, shuffled cube_id: abs {ea_s} rel "
              f"{er_s}")
    shuffled = {"max_abs_err": ea_s, "max_rel_err": er_s,
                "cube_runs": cube_runs(sargs[5]),
                "ms": time_ms(torch, lambda: fused_sample.fused_sigma_app(
                    *sargs, **fkw), 50)[0]}
    del got_s, want_s, sargs
    N, C, W = pts.shape[0], base.shape[0], fkw["window"]
    Rs, Rc, A = spec[0][1], spec[6][1], fkw["app_dim"]
    R = Rs + Rc
    decoded = C * 3 * (W * W + W) * R
    f_bytes = (nbytes(pts, cid, base, basis) + decoded * 4
               + N * 4 + N * A * 4)
    f_ops = N * (3 * (R * 11 + Rs + Rc * A * 2) + 40)
    b_ms, b_by = bound(f_bytes, f_ops)
    rows.append({
        "name": "fused_sigma_app", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sample.cu",
        "replaces": "src/repro/kernels/fused_sample.py:281",
        "launches": launches["fused_sigma_app"], "max_abs_err": ea,
        "max_rel_err": er, "tol": FUSED_TOL,
        **timing_keys(torch, lambda: fused_sample.fused_sigma_app(
            *fargs, **fkw), lambda: fused_sample.fused_sigma_app_ref(
            *fargs, **fkw)),
        "host_ms": host_ms(torch, lambda: fused_sample.fused_sigma_app(
            *fargs, **fkw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": N, "C": C, "W": W, "R": R, "app_dim": A,
                  "active_pairs": hits, "cube_runs": runs},
        "shuffled_cube_id": shuffled,
        "smem_bytes": fused_sample.fused_smem_bytes(W, Rs, Rc),
        "bytes": f_bytes, "ops": f_ops})

    rows.append(bitmap_gather_row(torch, bitmap_decode, cap.gathers["bitmap"],
                                  launches["bitmap_gather"]))
    rows.append(coo_gather_row(torch, coo_gather, cap, launches["coo_gather"],
                               args.seed))
    for row in rows:
        row["eval"] = eval_entries[row["name"]]
        row["fleet"] = fleet_entries[row["name"]]
        row["mesh"] = mesh_entries[row["name"]]
        if row["name"] in train_entries:
            row["train"] = train_entries[row["name"]]
    rows += ops_rows + bwd_rows
    check(len(rows) == 8, f"{len(rows)} kernel rows")
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", file=sys.stderr)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
