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
  kernels  {"kernels": [...]}: per kernel its launches while serving, the
           largest error against its plain version, its device time and
           the plain version's (CUDA events over a CUDA graph of repeated
           calls; `wall_ms`, over eager calls, includes the wrapper's host
           time) and the least time the card could take.

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
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

FUSED_TOL = 1e-4      # summation order differs (per-channel vs one matmul)
PARITY_TOL = 1e-3     # image: atomics order + kernel sums over 1024 steps


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
    (kept on the device by `torch.where`), and the largest gather call of
    each format."""

    def __init__(self, torch, ops, pipeline):
        self.torch, self.ops, self.pipeline = torch, ops, pipeline
        self.orig = (ops.fused_sigma_app, ops.bitmap_gather, ops.coo_gather,
                     pipeline.compact_select)
        self.n_hit = None
        self.best = {}          # N -> {"hits", "pts", "base", "cid"}
        self.fused_static = None
        self.gathers = {}       # fmt -> (args, kwargs)

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


def timing_keys(torch, kernel_fn, plain_fn) -> dict:
    ms, wall = time_ms(torch, kernel_fn, 50)
    plain_ms, plain_wall = time_ms(torch, plain_fn, 10)
    return {"ms": ms, "plain_ms": plain_ms, "wall_ms": wall,
            "plain_wall_ms": plain_wall}


def bound(nbytes: float, nops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_FP32_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def errors(torch, got, want) -> tuple:
    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    want = [w.float() for w in (want if isinstance(want, tuple) else (want,))]
    abs_err = max(float((g - w).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp(min=1e-6)).max())
                  if g.numel() else 0.0 for g, w in zip(got, want))
    return abs_err, rel_err


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
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type.name == "CUDA" and us > 0:
            rows.append((us, e.key, e.count))
    busy_s = sum(r[0] for r in rows) * 1e-6
    rows.sort(reverse=True)
    return {"phase": "profile", "wall_s": wall,
            "steps": engine.cfg.max_cubes // engine.cube_chunk,
            "device_busy_s": busy_s if rows else "not measured",
            "device_busy_share": busy_s / wall if rows else "not measured",
            "top_kernels": [{"name": k[:80], "device_ms": us * 1e-3,
                             "calls": n} for us, k, n in rows[:8]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--res", type=int, default=200)
    args = ap.parse_args()

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
    from repro_torch.core import pipeline, rendering, tensorf
    from repro_torch.kernels import (_build, bitmap_decode, coo_gather,
                                     fused_sample, ops)
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Capture(torch, ops, pipeline) as cap:
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
    emit({"phase": "serve", "engine_setup_s": t_engine, "serve_s": t_serve,
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
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": N, "C": C, "W": W, "R": R, "app_dim": A,
                  "active_pairs": hits}, "bytes": f_bytes, "ops": f_ops})

    for name, fmt, src, rep in (
            ("bitmap_gather", "bitmap", "bitmap_gather.cu",
             "src/repro/kernels/bitmap_decode.py:68"),
            ("coo_gather", "coo", "coo_gather.cu",
             "src/repro/kernels/coo_gather.py:40")):
        gargs, gkw, nq = cap.gathers[fmt]
        kernel, plain = kernels[name], (
            bitmap_decode.bitmap_gather_ref if fmt == "bitmap"
            else coo_gather.coo_gather_ref)
        if fmt == "bitmap":
            words, rowptr, values, q = gargs
            rank = gkw["rank"]

            def run_k():
                return kernel(words, rowptr, values, q, cols=gkw["cols"],
                              rank=rank)

            def run_p():
                return plain(words, rowptr, values, q, gkw["cols"], rank=rank)
            stream_bytes = nbytes(words, rowptr, values, rank)
            g_ops = nq * 12
        else:
            coords, values, q = gargs

            def run_k():
                return kernel(coords, values, q)

            def run_p():
                return plain(coords, values, q)
            stream_bytes = nbytes(coords, values)
            g_ops = nq * 4 * coo_gather.search_steps(coords.shape[0])
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} kernel differs from plain")
        ea, er = errors(torch, got, want)
        b_ms, b_by = bound(nq * 8 + stream_bytes, g_ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": rep,
            "launches": launches[name], "max_abs_err": ea, "max_rel_err": er,
            "tol": 0.0, **timing_keys(torch, run_k, run_p), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": {"Q": nq, "stream_bytes": stream_bytes},
            "bytes": nq * 8 + stream_bytes, "ops": g_ops})
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", file=sys.stderr)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
