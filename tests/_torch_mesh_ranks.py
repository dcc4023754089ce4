"""Spawned ranks for the port's mesh tests: each is a CPU process over
gloo that imports torch and the port, never jax. Inputs cross from the
test process as pickled numpy (a payload file); each rank pickles its
results back. `spawn` runs one world under a time limit of its own and
stops every process it starts."""
import contextlib
import io
import multiprocessing
import os
import pickle
import time
import traceback

import torch

COLLECTIVE_TIMEOUT_S = 60.0


def spawn(job, world: int, tmp, payload, timeout_s: float = 120.0):
    """Run `job(rank, world, payload)` in `world` spawned ranks and return
    their results in rank order; a rank's exception raises here with its
    traceback, and a world past `timeout_s` is killed and raises."""
    return join(start(job, world, tmp, payload), timeout_s)


def start(job, world: int, tmp, payload):
    """Start the ranks of `spawn` and return at once (`join` collects)."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(job, r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp, time.monotonic()


def join(started, timeout_s: float = 120.0):
    """The results of `start`'s ranks, within `timeout_s` of their start."""
    procs, tmp, t0 = started
    try:
        for p in procs:
            p.join(max(t0 + timeout_s - time.monotonic(), 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10.0)
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors:
        raise RuntimeError(
            f"{len(alive)} of {len(procs)} ranks were still running after "
            f"{timeout_s} s\n" + "\n".join(errors))
    out = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank(job, rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_ranks
    import torch.distributed as dist
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        init_ranks("cpu", init_method="file://" + os.path.join(tmp, "init"),
                   rank=rank, world_size=world,
                   timeout_s=COLLECTIVE_TIMEOUT_S)
        try:
            result = job(rank, world, payload)
            # no rank tears its connections down under another's last op
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# -- jobs ---------------------------------------------------------------------


def _field(p, key="scene"):
    from repro_torch.configs.rtnerf import NeRFConfig
    from repro_torch.core import field as tfield
    from repro_torch.core import occupancy as tocc
    cfg = NeRFConfig(**p["cfg"])
    spec, arrays, cubes = p[key]
    field = tfield.field_from_state(spec, arrays, cfg, device="cpu")
    return cfg, field, tocc.cubes_from_arrays(*cubes, device="cpu")


def _cams(p):
    from repro_torch.core.rendering import Camera
    return [Camera(torch.from_numpy(c2w), torch.from_numpy(o), f, h, w)
            for c2w, o, f, h, w in p["cams"]]


def _views(engine, cams):
    futs = [engine.submit(c) for c in cams]
    engine.flush()
    return [{"img": r.img, "depth": r.depth, "opacity": r.opacity,
             "stats": dict(r.stats)} for r in (f.result() for f in futs)]


ENGINE_STATS = ("views_served", "flushes", "dropped_pairs", "pair_budget",
                "pair_budget_resizes", "pair_occupancy_last", "n_devices")


def engine_job(rank, world, p):
    """The engine on the world mesh at `p["ray_chunk"]` (twice through
    the views: the second flush sees the first's budget) and at
    `p["odd_chunk"]`, which does not divide the data axis."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import RenderEngine
    cfg, field, cubes = _field(p)
    cams = _cams(p)
    mesh = make_host_mesh("cpu")
    out = {}
    for key, chunk in (("sharded", p["ray_chunk"]),
                       ("replicated", p["odd_chunk"])):
        eng = RenderEngine(cfg, field, cubes, ray_chunk=chunk, mesh=mesh,
                           trace_requests=False)
        views = _views(eng, cams) + _views(eng, cams)
        st = eng.stats()
        out[key] = {"views": views,
                    "stats": {k: st[k] for k in ENGINE_STATS}}
    # the flush thread: rank 0 times the flushes, the other ranks follow
    eng = RenderEngine(cfg, field, cubes, ray_chunk=p["ray_chunk"],
                       mesh=mesh, trace_requests=False, max_batch_views=2,
                       auto_flush_interval=0.05)
    futs = [eng.submit(c) for c in cams]
    views = [f.result(timeout=60.0) for f in futs]
    eng.close(timeout=60.0)
    out["auto_flush"] = {"imgs": [r.img for r in views],
                         "views_served": eng.stats()["views_served"],
                         "running": eng.stats()["auto_flush_running"]}
    return out


def store_job(rank, world, p):
    """The store sequence on the world mesh: after each operation the
    resident scenes and bytes; at the end the eviction and revival
    totals and where this rank spilled."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import make_rules
    from repro_torch.serving import SceneStore
    scenes = {k: _field(p, k)[1:] for k in p["store_scenes"]}
    cfg = _field(p, p["store_scenes"][0])[0]
    store = SceneStore(cfg, rules=make_rules(make_host_mesh("cpu")),
                       max_resident_bytes=p["store_budget"],
                       spill_dir=p["spill_dir"])
    seq = []
    for op, name, *arg in p["store_ops"]:
        if op == "register":
            store.register(name, *scenes[arg[0]])
        else:
            getattr(store, op)(name)
        seq.append((store.resident_scenes(), store.resident_bytes()))
    return {"seq": seq, "evictions": store.evictions_total,
            "revivals": store.revivals_total, "spill_dir": store.spill_dir,
            "device": str(store.device)}


def steps_job(rank, world, p):
    """`build_render_step` and one `build_nerf_train_step` on the world
    mesh."""
    from repro_torch.configs.rtnerf import NeRFConfig
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import make_rules
    from repro_torch.optim import adamw
    rules = make_rules(make_host_mesh("cpu"))
    t = {k: torch.from_numpy(v) for k, v in p["render_params"].items()}
    cfg = NeRFConfig(**p["step_cfg"])
    rgb = tdist.build_render_step(cfg, rules)(
        t, torch.from_numpy(p["occ"]), torch.from_numpy(p["render_o"]),
        torch.from_numpy(p["render_d"]))
    opt = adamw(lr=cfg.lr_grid, b2=0.99)
    params = {k: torch.from_numpy(v) for k, v in p["train_params"].items()}
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    params, state, loss = tdist.build_nerf_train_step(cfg, opt, rules)(
        params, opt.init(params), batch)
    return {"rgb": rgb.numpy(), "loss": float(loss),
            "params": {k: v.detach().numpy() for k, v in params.items()},
            "step": int(state["step"])}


def launch_job(rank, world, p):
    """The serving launcher as `torchrun` runs it, on the initialised
    process group; returns what the rank printed."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(p["launch_args"])
    return buf.getvalue()


def world_job(rank, world, p):
    """Every job of a world, one after another (each world is spawned
    once)."""
    return {name: globals()[name + "_job"](rank, world, p)
            for name in p["jobs"]}


def gpipe_job(rank, world, p):
    """`gpipe(mlp_stage)` on a (stage, data) mesh of the world."""
    from repro_torch.launch import pipeline
    from repro_torch.launch.mesh import make_pipeline_mesh
    mesh = make_pipeline_mesh(**p["mesh"], device="cpu")
    params = {k: torch.from_numpy(v) for k, v in p["params"].items()}
    y = pipeline.gpipe(pipeline.mlp_stage, mesh)(params,
                                                torch.from_numpy(p["x"]))
    return {"y": y.numpy(), "coords": {a: mesh.coordinate(a)
                                       for a in mesh.axis_names}}
