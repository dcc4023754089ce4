#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--views 4] [--res 200]

Serves novel views from a compressed TensoRF field at the full width of
`NeRFConfig()` (grid 160, R 16 + 48, app_dim 27, 8192 cubes) through the
port's entry points, and holds every CUDA kernel on that path against its
plain PyTorch version on inputs captured from the run. Phases, one JSON
line each:

  device   the card (torch and nvidia-smi);
  build    the kernels compiled from src/repro_torch/kernels/csrc;
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
           (render_rtnerf at 64 x 64, the baseline on 1,024 strided rays
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
           replicated scene served by both workers; the same 8 views
           through one worker and across two; a worker SIGKILLed with
           views queued behind an injected stall, every future resolved
           and the live ones replayed; each worker's device, dispatch
           path and kernel launches from its `stats` reply; the `fleet_*`
           metric families; close() leaving no child process;
  launch   `python -m repro_torch.launch.serve --arch rtnerf` run three
           times on one checkpoint root (train, restore, fleet of two
           workers with the hot scene on both): exit codes, seconds, the
           device each printed, views, fps, kernel launches, and PSNRs
           equal to 0.01 dB across the runs;
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
           parent's exports. Rows 7 and 8 are the gathers' backward
           kernels at that call, held against their plain versions
           within the reordering bound of fp32 sums, with `index_add_`
           on the precomputed slots as the library call.

Then the card's name and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
nonzero and prints no result, as it does without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import argparse
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
# (1,024 rays), the ground truth at the full view
EVAL_RES = 800
EVAL_ANGLE = 0.3
EVAL_CHUNK = 8
EVAL_SCENE = "lego"
EVAL_PARITY_RES = 64
EVAL_UNIFORM_STRIDE = 625
GT_TOL = 1e-4         # ground-truth colours off the tie pixels
GT_TIE = 1e-5         # a final SDF this close to the hit threshold is a tie
GT_TIE_SHARE = 1e-3   # ... and at most this share of pixels may flip
# the gather rows' eval timing: the first EVAL_GATHER_ROWS of the 48 rows
# of one render_uniform pass's appearance-plane call (its plain version
# over the whole call would hold about 38 GB of int64 temporaries)
EVAL_GATHER_ROWS = 12
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
FLEET_TIMED_VIEWS = 8
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
    import dataclasses

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


def gather_bwd_row(torch, mods, fmt, call, samples, cfg, launches) -> dict:
    """The backward kernel of one gather on the training step's captured
    appearance-plane call (its first EVAL_GATHER_ROWS rows, as the
    forward entries): held against its plain version within `bwd_tol`,
    exact zeros where no query reads; timed as the forward rows are, with
    `index_add_` on the precomputed slots as the library call. The bound
    counts the incoming gradient (4 bytes a query), the queries of nonzero
    gradient (4 bytes each: the kernel skips the rest), the stream's
    metadata and each value's read-modify-write (8 bytes)."""
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
        q, g = q_full[:n], g_full[:n]

        def run_k():
            return bitmap_decode.bitmap_gather_bwd(
                words, rowptr, q, g, nvalues=nvalues, cols=cols, rank=rank)

        def run_p():
            return bitmap_decode.bitmap_gather_bwd_ref(
                words, rowptr, q, g, nvalues, cols, rank=rank)
        slot, hit = bitmap_decode.bitmap_slots(words, rowptr, nvalues, q,
                                               cols, rank)
        meta = nbytes(words, rowptr, rank)
        name, source = ("bitmap_gather_bwd",
                        "src/repro_torch/kernels/csrc/bitmap_gather.cu")
        replaces, oracle = ("src/repro/kernels/bitmap_decode.py:68",
                            "src/repro/kernels/ref.py:28")
    else:
        coords, q_full, g_full = args
        nvalues = coords.shape[0]
        q, g = q_full[:n], g_full[:n]

        def run_k():
            return coo_gather.coo_gather_bwd(coords, q, g)

        def run_p():
            return coo_gather.coo_gather_bwd_ref(coords, q, g)
        slot, hit = coo_gather.coo_slots(coords, q)
        meta = nbytes(coords)
        name, source = ("coo_gather_bwd",
                        "src/repro_torch/kernels/csrc/coo_gather.cu")
        replaces, oracle = ("src/repro/kernels/coo_gather.py:40",
                            "src/repro/kernels/ref.py:41")
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    tol, k = bwd_tol(torch, slot, hit, g, nvalues)
    diff = (got.double() - want.double()).abs()
    over = float((diff - tol).max())
    unread = k == 0
    check(over <= 0.0, f"{name} differs from plain beyond the reordering "
          f"bound by {over}")
    check(bool((got[unread] == 0).all()) and bool((want[unread] == 0).all()),
          f"{name}: a value slot no query reads is not 0")
    ea = float(diff.max())
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
           **timing_keys(torch, run_k, run_p),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, run_lib, 50)[0],
           "library_call": "torch.zeros(n).index_add_ on precomputed slots",
           "shape": {"Q": n, "call_queries": nq, "timed_rows":
                     EVAL_GATHER_ROWS, "nonzero_grad_queries": nz,
                     "hit_queries": int(hit.sum()), "values": nvalues,
                     "slots_read": int((~unread).sum()),
                     "max_queries_a_slot": int(k.max())},
           "bytes": b_bytes}
    del got, want, diff, tol, k, slot, hit, vals
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
    three times as a user would on one checkpoint root: (1) trains each
    scene and checkpoints it, then serves; (2) restores and serves, its
    PSNRs within LAUNCH_PSNR_DB of (1); (3) restores and serves through
    the fleet (two workers, the hot scene on both), within LAUNCH_PSNR_DB
    of (2). Each run must exit 0 on the card's device."""
    import os
    import re

    t_phase = time.perf_counter()
    base = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_ARGS,
            "--ckpt-dir", os.path.join(root, "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    kind = torch.cuda.get_device_name(0)
    runs = []
    for label, extra in (("train", []), ("restore", []),
                         ("fleet", LAUNCH_FLEET_ARGS)):
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
    train, restore, fleet = runs
    check(train["trained"] == 2 and train["restored"] == 0,
          f"run 1 trained {train['trained']}")
    for r in (restore, fleet):
        check(r["restored"] == 2 and r["trained"] == 0,
              f"run {r['run']} did not restore both scenes")
    diffs = {}
    for a, b in ((restore, train), (fleet, restore)):
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
    for r in (train, restore):
        check(r["kernel_launches"]["fused_sigma_app"] > 0,
              f"run {r['run']} launched no fused kernel")
    return {"phase": "launch", "seconds": time.perf_counter() - t_phase,
            "runs": runs, "psnr_max_diff": diffs, "tol_db": LAUNCH_PSNR_DB}


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
    ap.add_argument("--views", type=int, default=4)
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
        FleetRouter=FleetRouter)
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
        emit(launch_phase(torch, root))

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
