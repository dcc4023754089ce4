"""Serving launcher: batched novel-view rendering (rtnerf) on the card.
The port of `repro/launch/serve.py`'s NeRF paths.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rtnerf \
        --scene lego --views 2 --res 64 \
        --prune-sparsity 0.9 --ckpt-dir /tmp/lego-ckpt
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rtnerf \
        --scene lego --finetune-steps 200 --finetune-every 50
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rtnerf \
        --scenes lego,chair,mic --fleet-workers 2 --max-resident-mb 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rtnerf \
        --scene lego --views 1 --res 16 --train-steps 2 --device cpu

`--device` (default `cuda`) is where fields train and views render; the
CPU runs only when asked for (`--device cpu`, the plain PyTorch versions
of the kernels), and without a card the default raises. Fleet workers
get the same device through their engine arguments. Both paths use the
reference launcher's `NeRFConfig`, so a checkpoint written by either
package's launcher restores in the other. Only `--arch rtnerf` is
served: the language-model launcher (`serve_lm`) needs the port's
`models/` and `launch/steps.py`, which do not exist yet.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile

import torch

from repro_torch.configs.base import mib_to_bytes
from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.device import resolve_device


def launcher_config(max_resident_mb) -> NeRFConfig:
    """The reference launcher's hard-coded config (both of its paths)."""
    return NeRFConfig(grid_res=48, occ_res=48, cube_size=4, max_cubes=1024,
                      r_sigma=8, r_color=16, app_dim=12, mlp_hidden=32,
                      max_samples_per_ray=128, train_rays=1024,
                      max_resident_bytes=mib_to_bytes(max_resident_mb))


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@contextlib.contextmanager
def profile_to(profile_dir, dev: torch.device):
    """Record the block under `torch.profiler` (the card's kernels too on
    a CUDA device) and write a Chrome trace into `profile_dir`; the
    renderer's `record_function` ranges tag its stages."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[obs] torch.profiler trace written to {path}")


def _scenes(args):
    return ([s for s in args.scenes.split(",") if s] if args.scenes
            else [args.scene])


def _ground_truth(scenes, args, dev):
    """The orbit cameras and each scene's ground-truth images (host)."""
    from repro_torch.data import rays as rays_lib

    cams = rays_lib.make_cameras(args.views, args.res, args.res, device=dev)
    gts = {name: [rays_lib.render_gt(rays_lib.make_scene(name), cam)
                  .cpu().numpy() for cam in cams] for name in scenes}
    return cams, gts


def serve_nerf(args):
    """Streaming multi-view serving from a store of resident compressed
    fields.

    --scenes a,b,c serves several named scenes from ONE process: each is
    restored from its per-scene subdirectory of --ckpt-dir when a
    checkpoint exists (trained once, compressed-native, and saved there
    in encoded form otherwise), registered in the engine's SceneStore, and
    every queued view is rendered by the engine's micro-batched renderer,
    grouped per scene at flush time. --max-resident-mb bounds the encoded
    bytes resident at once: cold scenes are LRU-evicted to encoded
    checkpoints and revived when their next request arrives. --deadline
    fails stale requests instead of rendering them late. --finetune-steps
    starts the online fine-tuning service (serving.FineTuneLoop): one
    background trainer PER RESIDENT SCENE refreshes its field through the
    store every --finetune-every steps while the request streams keep
    rendering.
    """
    from repro_torch.obs import (MetricsRegistry, MetricsServer,
                                 StatsReporter, snapshot_json)
    from repro_torch.serving import FineTuneLoop, RenderEngine
    from repro_torch.serving.fleet import kernel_launches

    dev = resolve_device(args.device)
    name_of_device = device_name(dev)
    print(f"[serve] device: {name_of_device}", flush=True)
    scenes = _scenes(args)
    cfg = launcher_config(args.max_resident_mb)

    # the registry is created BEFORE the engine (which may train scenes for
    # minutes) so the exposition endpoint answers scrapes from the start;
    # the engine and every fine-tune loop record into this same registry
    registry = MetricsRegistry()
    holder = {"engine": None}

    def _extra_stats():
        eng = holder["engine"]
        return eng.stats() if eng is not None else {"phase": "loading"}

    mserver = None
    if args.metrics_port is not None:
        mserver = MetricsServer(registry, port=args.metrics_port,
                                extra=_extra_stats)
        print(f"[obs] metrics: http://127.0.0.1:{mserver.port}/metrics "
              f"(Prometheus) and /metrics.json (snapshot)", flush=True)

    engine = RenderEngine.from_scenes(
        cfg, scenes, ckpt_root=args.ckpt_dir,
        train_steps=args.train_steps, n_views=8, image_hw=args.res,
        prune_sparsity=args.prune_sparsity, encode=not args.dense,
        ray_chunk=args.res * args.res, max_batch_views=args.views,
        auto_flush_interval=(0.25 if args.finetune_steps else None),
        registry=registry, device=dev)
    holder["engine"] = engine

    reporter = None
    if args.stats_interval:
        def _stats_line():
            s = engine.stats()
            return (f"[obs] views={s['views_served']} fps={s['fps']:.3f} "
                    f"p50={s['latency_p50_s'] * 1e3:.0f}ms "
                    f"p99={s['latency_p99_s'] * 1e3:.0f}ms "
                    f"flushes={s['flushes']} timeouts={s['timeouts']} "
                    f"dropped={s['dropped_pairs']} swaps={s['field_swaps']}")
        reporter = StatsReporter(_stats_line, args.stats_interval)
    for name in scenes:
        s = engine.stats(scene=name)
        print(f"scene '{name}': {s['field_kind']}, "
              f"{s['factor_bytes']:.0f} B factors "
              f"(dense {s['factor_bytes_dense']:.0f} B, "
              f"{s['compression_ratio']:.2f}x)")
    if engine.store.max_resident_bytes:
        print(f"resident budget {engine.store.max_resident_bytes} B, "
              f"resident now: {engine.store.resident_scenes()}")

    loops = []
    if args.finetune_steps:
        # one trainer thread per resident scene, all publishing through
        # the store
        loops = [FineTuneLoop.attach(engine.store, name,
                                     steps=args.finetune_steps,
                                     publish_every=args.finetune_every,
                                     n_views=8, image_hw=args.res,
                                     verbose=True).start()
                 for name in scenes]

    cams, gts = _ground_truth(scenes, args, dev)
    rounds = 1 if not loops else max(args.finetune_rounds, 1)
    with profile_to(args.profile_dir, dev):
        for rnd in range(rounds):
            futures = [(name, engine.submit(cam, gt, scene=name,
                                            deadline_s=args.deadline))
                       for name in scenes
                       for cam, gt in zip(cams, gts[name])]
            for i, (name, fut) in enumerate(futures):
                r = fut.result()
                if r.timed_out:
                    print(f"{name} view {i}: TIMED OUT after "
                          f"{r.latency_s:.2f}s")
                    continue
                print(f"{name} view {i}: psnr={r.psnr:.2f} "
                      f"latency={r.latency_s:.2f}s "
                      f"occ_accesses={r.stats['occ_accesses']:.0f} "
                      f"factor_bytes={r.stats['factor_bytes']:.0f}")
    if loops:
        for loop in loops:
            loop.join()
        engine.close()
        total_steps = sum(loop.trainer.step_count for loop in loops)
        total_swaps = sum(len(loop.swaps) for loop in loops)
        print(f"fine-tuned {total_steps} steps over {len(loops)} scenes, "
              f"{total_swaps} live swaps "
              f"(max swap {engine.stats()['swap_latency_s_max'] * 1e3:.1f}ms)")
    s = engine.stats()
    print(f"served {s['views_served']} views over {s['n_scenes']} scenes, "
          f"{s['fps']:.3f} FPS ({name_of_device}), "
          f"p50={s['latency_p50_s']:.2f}s p95={s['latency_p95_s']:.2f}s, "
          f"ordering-cache hits={s['ordering_cache']['hits']}, "
          f"timeouts={s['timeouts']}, swaps={s['field_swaps']}, "
          f"evictions={s['evictions']}, revivals={s['revivals']}, "
          f"pair_budget={s['pair_budget']} "
          f"(init {s['pair_budget_initial']}, "
          f"{s['pair_budget_resizes']} resizes)")
    br = engine.stage_breakdown()
    if br:
        print("stage breakdown (per request):")
        for stage, d in br.items():
            print(f"  {stage:>10s}  n={d['count']:4d} "
                  f"p50={d['p50_s'] * 1e3:8.2f}ms "
                  f"p99={d['p99_s'] * 1e3:8.2f}ms "
                  f"total={d['total_s']:7.3f}s")
    print(f"[serve] kernel launches: {json.dumps(kernel_launches())}")
    if args.metrics_dump:
        snap = snapshot_json(registry, extra=s)
        with open(args.metrics_dump, "w") as f:
            json.dump(snap, f, indent=2)
        print(f"[obs] metrics snapshot written to {args.metrics_dump}")
    if reporter is not None:
        reporter.close()
    if mserver is not None:
        mserver.close()


def serve_fleet(args):
    """Fleet tier: shard --scenes across --fleet-workers worker processes
    by consistent hashing (serving.FleetRouter).

    Each worker is a full RenderEngine in its own process, on the
    launcher's device; scenes are trained/restored once in the launcher
    (same --ckpt-dir contract as the single-process path), exported in
    encoded form, and registered lazily on their owning worker.
    --max-resident-mb applies PER WORKER. --fleet-replicas R replicates
    the first scene (the designated hot scene) on R workers behind one
    key; the router picks the least-loaded replica per request.
    --deadline, --metrics-port and --metrics-dump behave as in the
    single-process path, with the fleet_* metric families on top.
    --profile-dir records the launcher's process only (the workers render
    in their own).
    """
    from repro_torch.obs import MetricsRegistry, MetricsServer, snapshot_json
    from repro_torch.serving import FleetRouter, export_scene, prepare_field
    from repro_torch.serving.fleet import kernel_launches

    if args.finetune_steps:
        raise SystemExit(
            "--fleet-workers does not combine with --finetune-steps yet: "
            "fleet workers own their engines, so the fine-tune loop would "
            "train a field no worker serves (ROADMAP: fleet fine-tuning)")
    dev = resolve_device(args.device)
    print(f"[serve] device: {device_name(dev)}", flush=True)
    scenes = _scenes(args)
    cfg = launcher_config(args.max_resident_mb)

    registry = MetricsRegistry()
    holder = {"router": None}

    def _extra_stats():
        r = holder["router"]
        return r.stats() if r is not None else {"phase": "loading"}

    mserver = None
    if args.metrics_port is not None:
        mserver = MetricsServer(registry, port=args.metrics_port,
                                extra=_extra_stats)
        print(f"[obs] metrics: http://127.0.0.1:{mserver.port}/metrics "
              f"(Prometheus) and /metrics.json (snapshot)", flush=True)

    # Train/restore in the launcher (reuses --ckpt-dir exactly like the
    # single-process path), then export each scene's encoded streams +
    # cubes once; workers register from these paths, so every replica and
    # every re-registration after a crash serves the same representation.
    export_root = tempfile.mkdtemp(prefix="repro-fleet-")
    router = None
    try:
        paths = {}
        for name in scenes:
            ckpt = os.path.join(args.ckpt_dir, name) if args.ckpt_dir \
                else None
            field = prepare_field(cfg, name, ckpt_dir=ckpt,
                                  train_steps=args.train_steps, n_views=8,
                                  image_hw=args.res, device=dev)
            if args.prune_sparsity > 0.0:
                field = field.prune(sparsity=args.prune_sparsity)
            paths[name] = export_scene(os.path.join(export_root, name),
                                       field, cfg=cfg, scene=name)

        router = FleetRouter(
            cfg, paths, n_workers=args.fleet_workers,
            engine_kwargs=dict(ray_chunk=args.res * args.res,
                               max_batch_views=args.views, device=str(dev)),
            registry=registry)
        holder["router"] = router
        for name in scenes:
            print(f"scene '{name}' -> worker {router.owner_of(name)}")
        if args.fleet_replicas > 1:
            hot = scenes[0]
            router.set_replicas(hot, args.fleet_replicas)
            print(f"hot scene '{hot}' replicated on "
                  f"{router.replica_workers(hot)}")

        cams, gts = _ground_truth(scenes, args, dev)
        with profile_to(args.profile_dir, dev):
            futures = [(name, router.submit(cam, gt, scene=name,
                                            deadline_s=args.deadline))
                       for name in scenes
                       for cam, gt in zip(cams, gts[name])]
            for i, (name, fut) in enumerate(futures):
                r = fut.result()
                if r.timed_out:
                    print(f"{name} view {i}: TIMED OUT after "
                          f"{r.latency_s:.2f}s")
                    continue
                print(f"{name} view {i}: psnr={r.psnr:.2f} "
                      f"latency={r.latency_s:.2f}s worker={r.worker}"
                      f"{' (replayed)' if r.replayed else ''}")

        s = router.stats()
        print(f"fleet: {s['results_total']} results over "
              f"{len(scenes)} scenes / {s['workers_alive']} workers, "
              f"p95={s['latency_p95_s']:.2f}s, "
              f"timeouts={s['timeouts_total']}, "
              f"replays={s['replays_total']}, "
              f"deaths={s['worker_deaths']}, "
              f"routing v{s['routing_version']}")
        for wname, ws in sorted(s["workers"].items()):
            print(f"  {wname}: views={ws.get('views_served', 0)} "
                  f"fps={ws.get('fps', 0.0):.3f} "
                  f"device={ws.get('device')} "
                  f"resident={ws.get('resident_scenes', [])} "
                  f"evictions={ws.get('evictions', 0)} "
                  f"revivals={ws.get('revivals', 0)} "
                  f"launches={json.dumps(ws.get('launches', {}))}")
        # the launcher's own: training, restore and each export's
        # occupancy build
        print(f"[serve] kernel launches: {json.dumps(kernel_launches())}")
        if args.metrics_dump:
            snap = snapshot_json(registry, extra=s)
            with open(args.metrics_dump, "w") as f:
                json.dump(snap, f, indent=2)
            print(f"[obs] metrics snapshot written to {args.metrics_dump}")
    finally:
        if router is not None:
            router.close()
        shutil.rmtree(export_root, ignore_errors=True)
        if mserver is not None:
            mserver.close()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve novel views of RT-NeRF scenes (the PyTorch "
                    "port; --arch rtnerf only)")
    ap.add_argument("--arch", required=True,
                    help="rtnerf (the language-model archs are not ported)")
    ap.add_argument("--device", default="cuda",
                    help="where fields train and views render: cuda "
                         "(default; raises without a card) or cpu (the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="language-model archs only (not ported)")
    ap.add_argument("--batch", type=int, default=4,
                    help="language-model archs only (not ported)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="language-model archs only (not ported)")
    ap.add_argument("--gen", type=int, default=16,
                    help="language-model archs only (not ported)")
    ap.add_argument("--scene", default="lego")
    ap.add_argument("--scenes", default=None,
                    help="comma-separated scene list to serve from one "
                         "process (e.g. lego,chair,mic); overrides "
                         "--scene. Each scene checkpoints under its own "
                         "subdirectory of --ckpt-dir")
    ap.add_argument("--max-resident-mb", type=float, default=None,
                    help="device-memory budget (MiB) for resident encoded "
                         "fields across scenes; cold scenes are "
                         "LRU-evicted to encoded checkpoints and revived "
                         "on their next request (default: unlimited)")
    ap.add_argument("--fleet-workers", type=int, default=0,
                    help="serve through K worker processes sharded by "
                         "consistent hashing instead of one in-process "
                         "engine (serving.FleetRouter); --max-resident-mb "
                         "then applies per worker (0 = single-process "
                         "path)")
    ap.add_argument("--fleet-replicas", type=int, default=1,
                    help="with --fleet-workers: replicate the first "
                         "--scenes entry (the hot scene) on this many "
                         "workers behind one key; the router "
                         "load-balances across the replicas")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--dense", action="store_true",
                    help="serve the raw factor arrays instead of the "
                         "hybrid bitmap/COO compressed stream (Sec. 4.2.2)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds; stale requests "
                         "fail with a timeout result instead of rendering "
                         "late")
    ap.add_argument("--finetune-steps", type=int, default=0,
                    help="run the online fine-tuning service for this "
                         "many background training steps while serving "
                         "(0 = off); refreshed fields are published live "
                         "via swap_field")
    ap.add_argument("--finetune-every", type=int, default=50,
                    help="publish the refreshed field to the running "
                         "engine every N fine-tune steps")
    ap.add_argument("--finetune-rounds", type=int, default=3,
                    help="how many passes over the view set to stream "
                         "while the fine-tuner runs")
    ap.add_argument("--prune-sparsity", type=float, default=0.0,
                    help="magnitude-prune factors to this sparsity before "
                         "serving (0 = training prune only)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose the metrics registry over HTTP on "
                         "127.0.0.1:<port> (/metrics Prometheus text, "
                         "/metrics.json snapshot); 0 picks an ephemeral "
                         "port (printed at startup)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print a one-line serving summary every N "
                         "seconds while serving (0 = off)")
    ap.add_argument("--metrics-dump", default=None,
                    help="write the final metrics snapshot (JSON, schema "
                         "repro.obs/v1) to this path on exit")
    ap.add_argument("--profile-dir", default=None,
                    help="record the serving rounds under torch.profiler "
                         "and write a Chrome trace (trace.json) into this "
                         "directory; the renderer's record_function "
                         "ranges tag the pipeline stages")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore trained fields from per-scene "
                         "subdirectories of this root when checkpoints "
                         "exist; otherwise train once and save there "
                         "(repeated serves reuse them instead of "
                         "retraining)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.fleet_workers and args.arch != "rtnerf":
        ap.error("--fleet-workers requires --arch rtnerf")
    if args.arch != "rtnerf":
        ap.error(f"--arch {args.arch}: the port serves --arch rtnerf only; "
                 f"the language-model launcher (serve_lm) waits for the "
                 f"port's models/ and launch/steps.py")
    if args.fleet_workers:
        serve_fleet(args)
    else:
        serve_nerf(args)


if __name__ == "__main__":
    main()
