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
  kernels  {"kernels": [...]}: per kernel its launches on its path (serve
           or kernel_ops), the largest error against its plain version
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
           one 800 x 800 view.

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
    that device counter while `tiles` adds up its query tiles."""

    def __init__(self, ops, coo_gather, fused_call=None, staged=None):
        self.ops, self.coo_gather = ops, coo_gather
        self.orig = (ops.fused_sigma_app, ops.bitmap_gather, ops.coo_gather)
        self.fused_call, self.fused_calls, self.fused = fused_call, 0, None
        self.staged, self.tiles = staged, 0
        self.gathers = {}       # fmt -> (args, kwargs, nq)

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
            if self.fused_call is None and (prev is None
                                            or q.shape[0] > prev[2]):
                self.gathers[fmt] = (args, kw, q.shape[0])
            if fmt == "coo" and self.staged is not None \
                    and kw.get("force") is None:
                self.tiles += self.coo_gather.coo_plan(q.shape[0]).blocks
                return self.coo_gather.coo_gather(*args,
                                                  staged=self.staged)
            return fn(*args, **kw)
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
        fargs, fkw, nq = g
        rows = nq // (4 * S)
        check(nq == rows * 4 * S and rows == cfg.r_color,
              f"{fmt} call of {nq} queries is not an appearance plane's "
              f"({cfg.r_color} rows x 4 x {S})")
        q_full = fargs[3] if fmt == "bitmap" else fargs[2]
        q = q_full[: EVAL_GATHER_ROWS * 4 * S]
        entry = {"path": "render_uniform pass, appearance-plane call",
                 "launches_per_view": captured["launches_uni"][name],
                 "call_queries": nq, "call_rows": rows,
                 "timed_rows": EVAL_GATHER_ROWS, "timed_queries": q.shape[0]}
        if fmt == "bitmap":
            words, rowptr, values = fargs[:3]
            cols, rank = fkw["cols"], fkw["rank"]

            def run_k():
                return bitmap_decode.bitmap_gather(words, rowptr, values, q,
                                                   cols=cols, rank=rank)

            def run_p():
                return bitmap_decode.bitmap_gather_ref(words, rowptr, values,
                                                       q, cols, rank=rank)
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
            check(staged == predicted, f"coo_gather staged {staged} tiles "
                  f"at the eval shape, the windows predict {predicted}")
            entry.update({"staged_tile_share": staged / win.shape[0],
                          "window_mean": float(win.double().mean()),
                          "window_max": int(win.max())})
            stream_bytes = nbytes(coords, values)
            g_ops = q.shape[0] * 4 * coo_gather.search_steps(coords.shape[0])
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} differs from plain at the "
              f"eval shape")
        del got, want
        g_bytes = q.shape[0] * 8 + stream_bytes
        b_ms, b_by = bound(g_bytes, g_ops)
        entry.update({"max_abs_err": 0.0, "tol": 0.0,
                      **timing_keys(torch, run_k, run_p),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None, "bytes": g_bytes, "ops": g_ops})
        out[name] = entry
    return out


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
    from repro_torch.serving import RenderEngine

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
        RenderEngine=RenderEngine)
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
    rows += ops_rows
    check(len(rows) == 6, f"{len(rows)} kernel rows")
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", file=sys.stderr)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
