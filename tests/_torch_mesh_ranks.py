"""Spawned ranks for the port's mesh tests: each is a CPU process over
gloo that imports torch and the port, never jax. Inputs cross from the
test process as pickled numpy (a payload file); each rank pickles its
results back. `spawn` runs one world under a time limit of its own and
stops every process it starts."""
import contextlib
import dataclasses
import io
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
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


@contextlib.contextmanager
def _counted(*fns):
    """Count the calls of each `(module, name)` function while inside:
    yields {name: calls}."""
    calls, saved = {}, []
    for mod, name in fns:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        calls[name] = 0

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        setattr(mod, name, wrapper)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _steps_on(cfg, rules, p, split):
    """`build_render_step` (the scene's dense params, whole; a dict, or
    a DenseField on a mesh whose data axis is split) and one
    `build_nerf_train_step` on `rules`' mesh. On a "model" axis
    (`split`) also: the render step of the encoded `p["step_field"]`
    and the calls of the gathers' plain versions in it, each leaf's
    placements and local shapes (params, AdamW's m and v), the local
    parts of the returned params, and the collectives the split steps
    ran."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import distributed as tdist
    from repro_torch.core import field as tfield
    from repro_torch.kernels import bitmap_decode, coo_gather
    from repro_torch.optim import adamw
    t = {k: torch.from_numpy(v) for k, v in p["render_params"].items()}
    occ, ro, rd = (torch.from_numpy(p[k]) for k in ("occ", "render_o",
                                                     "render_d"))
    opt = adamw(lr=cfg.lr_grid, b2=0.99)
    params = {k: torch.from_numpy(v) for k, v in p["train_params"].items()}
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    if split and rules.mesh.shape["data"] == 1:
        # placed by the caller; on the other meshes by the step, and the
        # render step takes a DenseField there
        params = tdist.place_nerf_params(cfg, params, rules)
    elif split:
        t = tfield.DenseField(t, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rgb = tdist.build_render_step(cfg, rules)(t, occ, ro, rd)
        params, state, loss = tdist.build_nerf_train_step(cfg, opt, rules)(
            params, opt.init(params), batch)
    out = {"rgb": rgb.numpy(), "loss": float(loss), "step": int(
        state["step"]), "params": {k: v.detach().numpy() for k, v in
                                   tdist.whole_nerf_params(params).items()}}
    if not split:
        return out
    out["collectives"] = sorted(
        e.key for e in prof.key_averages()
        if e.key.startswith(("gloo:", "_c10d_functional::")))
    out["local"] = {k: v.to_local().detach().numpy()
                    for k, v in params.items()}
    out["placed"] = {
        f"{tree}/{k}": (tuple(v.shape), tuple(v.to_local().shape),
                        tuple(repr(x) for x in v.placements))
        for tree, leaves in (("params", params), ("m", state["m"]),
                             ("v", state["v"]))
        for k, v in leaves.items()}
    _, field, _ = _field(p, "step_field")
    with _counted((bitmap_decode, "bitmap_gather_ref"),
                  (coo_gather, "coo_gather_ref")) as calls:
        out["rgb_encoded"] = tdist.build_render_step(cfg, rules)(
            field, occ, ro, rd).numpy()
    out["gather_calls"] = dict(calls)
    return out


def steps_job(rank, world, p):
    """`_steps_on` on each mesh shape of `p["step_meshes"][world]`: the
    world's host mesh for (world, 1), a (data, model) mesh otherwise."""
    from repro_torch.configs.rtnerf import NeRFConfig
    from repro_torch.models.sharding import make_rules
    cfg = NeRFConfig(**p["step_cfg"])
    return {shape: _steps_on(cfg, make_rules(_lm_mesh(shape)), p,
                             split=shape[1] > 1)
            for shape in p["step_meshes"][world]}


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


# -- language models on a (data, model) mesh ----------------------------------


def _lm_mesh(shape):
    """The world as a (data, model) mesh: the launcher's host mesh for
    (world, 1), `make_mesh_from`'s live mesh for the square, and
    `make_mesh` otherwise."""
    from repro_torch.launch import elastic, mesh
    data, model = shape
    if model == 1:
        return mesh.make_host_mesh("cpu")
    if data == model:
        return elastic.make_mesh_from(list(range(data * model)), model,
                                      device="cpu")
    return mesh.make_mesh(data, model, device="cpu")


def _whole(t):
    """A DTensor's whole value (a plain tensor, such as a dense arch's
    zero aux loss, as it is)."""
    from repro_torch.models.sharding import whole
    return whole(t)


def _local_shapes(tree):
    """Each leaf's (global shape, local shape, bytes of its local
    storage)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: (tuple(t.shape), tuple(t.to_local().shape),
                               t.to_local().untyped_storage().nbytes()),
                    tree)


def _drawn_vs_placed(tf, cfg, rules):
    """`init_model(rules=)` (each leaf placed as it is drawn) against
    `place_params` of the whole tree from the same seed, leaf by leaf:
    (leaves, the paths whose placements or local shards differ, the paths
    that are not DTensors)."""
    from repro_torch.models.common import split_pl, tree_map
    from repro_torch.models.sharding import is_dtensor, place_params
    drawn, _ = split_pl(tf.init_model(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu", rules=rules))
    whole, logical = split_pl(tf.init_model(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu"))
    placed = place_params(whole, logical, rules)
    flat = []
    tree_map(lambda d, p_, log: flat.append((log, d, p_)), drawn, placed,
             logical)
    differ, plain = [], []
    for i, (log, d, p_) in enumerate(flat):
        if not is_dtensor(d):
            plain.append(f"{i}:{log}")
        elif (tuple(d.placements) != tuple(p_.placements)
              or d.shape != p_.shape
              or not torch.equal(d.to_local(), p_.to_local())):
            differ.append(f"{i}:{log}")
    return len(flat), differ, plain


def lm_job(rank, world, p):
    """Per arch and dtype on the world's mesh: each param leaf's global and
    local shapes after `place_params`; prefill's last logits (the prompt,
    and an enc-dec arch's encoder frames `enc_frames`); the cache grown
    to the horizon (the cross K/V at the frames' length), then
    teacher-forced decode steps' logits; the cache's shapes after them;
    `model_loss` on a train batch (a hybrid arch's also with the chunked
    SSD); float32 `serve_lm`'s greedy tokens; `init_model(rules=)`
    against `place_params` of the whole draw; whether `build_train_step`
    builds for reduced rwkv6-1.6b on the mesh; then the train cases of
    p["train"] (`train_cases`) on the archs' params and loss batches."""
    from repro_torch.configs import registry as treg
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import (make_rules, place_params,
                                             use_rules)
    from repro_torch.optim import adamw
    mesh = _lm_mesh(p["mesh"])
    rules = make_rules(mesh)
    B, P, N = p["B"], p["P"], p["n_decode"]
    out = {"mesh": dict(mesh.shape), "archs": {}, "drawn": {}}
    for name, case in p["archs"].items():
        cfg = dataclasses.replace(treg.reduced(treg.ARCHS[name]),
                                  capacity_factor=case["capacity_factor"])
        _, logical = steps.abstract_params(cfg)
        out["drawn"][name] = _drawn_vs_placed(tf, cfg, rules)
        for dtype in case["dtypes"]:
            tdt = getattr(torch, dtype)
            params = tf.params_from_numpy(case["params"], device="cpu",
                                          dtype=tdt)
            placed = place_params(params, logical, rules)
            del params
            r = {"params": _local_shapes(placed)}
            prefill = steps.build_prefill_step(cfg, rules)
            decode = steps.build_decode_step(cfg, rules, P + N)
            prompt = {"tokens": torch.from_numpy(case["tokens"])}
            frames = case.get("enc_frames")
            if frames is not None:
                prompt["enc_frames"] = torch.from_numpy(frames).to(
                    torch.bfloat16)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                logits, cache = prefill(placed, prompt)
            keys = {e.key for e in prof.key_averages()}
            r["prefill"] = _whole(logits).float().numpy()
            cache = tf.grow_cache(cache, tf.serve_cache_spec(
                cfg, B, P + N,
                enc_len=0 if frames is None else frames.shape[1])[0])
            r["decode"] = []
            for i in range(N):
                logits, cache = decode(placed, torch.from_numpy(
                    case["decode_tokens"][:, i:i + 1]), P + i, cache)
                r["decode"].append(_whole(logits).float().numpy())
            # one more step under the profiler: the collectives that it
            # and the prefill ran
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                decode(placed, torch.from_numpy(
                    case["decode_tokens"][:, N - 1:N]), P + N - 1, cache)
            keys |= {e.key for e in prof.key_averages()}
            r["collectives"] = sorted(k for k in keys if k.startswith(
                ("gloo:", "_c10d_functional::")))
            r["cache"] = _local_shapes(cache)
            del cache
            batch = steps.place_batch(cfg, {
                k: torch.from_numpy(v) for k, v in case["loss_batch"].items()},
                rules)
            with use_rules(rules), torch.no_grad():
                loss, metrics = tf.model_loss(placed, cfg, batch)
                if cfg.family == "hybrid":
                    r["loss_chunked"] = float(_whole(tf.model_loss(
                        placed, dataclasses.replace(cfg, ssm_impl="chunked"),
                        batch)[0]))
            r["loss"] = float(_whole(loss))
            r["metrics"] = {k: float(_whole(v)) for k, v in metrics.items()}
            if dtype == "float32":
                args = serve.build_parser().parse_args(
                    ["--arch", name, "--device", "cpu", "--batch", str(B),
                     "--prompt-len", str(P), "--gen", str(p["gen"])])
                buf, seen = io.StringIO(), []
                with contextlib.redirect_stdout(buf):
                    toks = serve.serve_lm(
                        args, params=tf.params_from_numpy(
                            case["params"], device="cpu",
                            dtype=torch.float32),
                        tokens=torch.from_numpy(case["tokens"]),
                        enc_frames=prompt.get("enc_frames"), mesh=mesh,
                        cfg=cfg, logits_out=seen)
                r["serve"] = toks.numpy()
                r["serve_logits"] = [t.float().numpy() for t in seen]
                r["serve_out"] = buf.getvalue()
            out["archs"][f"{name}/{dtype}"] = r
    out["train_step"] = callable(steps.build_train_step(
        treg.reduced(treg.ARCHS["rwkv6-1.6b"]), rules, adamw(1e-3)))
    # the train cases (`train_cases`) on the same mesh, each arch's params
    # and loss batch
    out["cases"] = train_cases(rules, {
        name: {"params": a["params"], "batch": a["loss_batch"],
               "capacity_factor": a["capacity_factor"]}
        for name, a in p["archs"].items()}, p.get("train", {}))
    return out


# -- language-model training on a (data, model) mesh --------------------------

# the optimizers of the train-step tests, as `tests/test_torch_lm_train.py`
# makes them: the launcher's schedule over 20 steps
TRAIN_STEPS = 20
TRAIN_OPTS = {"adamw": {"lr": 1e-3}, "adafactor": {"lr": 1e-2},
              "sgd": {"lr": 0.1}}


def train_opt(m, which):
    """Optimizer `which` of the optim package `m` (the port's or the
    reference's), as the tests make it."""
    if which == "sgd":
        return m.sgd(**TRAIN_OPTS["sgd"])
    sched = m.cosine_schedule(max(TRAIN_STEPS // 20, 1), TRAIN_STEPS)
    return getattr(m, which)(schedule=sched, **TRAIN_OPTS[which])


def _numpy_whole(tree):
    """Every leaf whole, as float32 numpy (a collective on the mesh)."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.sharding import whole
    return tree_map(lambda t: whole(t).detach().float().numpy(), tree)


def _functional(fn):
    """(fn(), the collectives it issued: gloo's and any functional one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted({e.key for e in prof.key_averages() if e.key.startswith(
        ("gloo:", "_c10d_functional::"))})


def lm_train_job(rank, world, p):
    """`train_cases` of p["cases"] on the world's (data, model) mesh."""
    from repro_torch.models.sharding import make_rules
    mesh = _lm_mesh(p["mesh"])
    return {"mesh": dict(mesh.shape),
            "cases": train_cases(make_rules(mesh), p["archs"], p["cases"])}


def train_cases(rules, archs, cases):
    """Each of `cases` on the mesh of `rules`: the arch's reduced config
    (capacity `capacity_factor`, `grad_accum`), its params (`archs`) in
    `dtype` placed by `place_params` and its batch by `batch_spec`; with
    `grads`, `loss_and_grads` (the loss, metrics, every gradient whole
    and each gradient's local shape); with `opt`, one `build_train_step`
    step of that optimizer on placed params and state (its metrics, the
    new params and state whole, the local shapes of the state before and
    after, the bytes of this rank's params and state against the whole).
    The collectives of each are recorded."""
    from repro_torch import optim
    from repro_torch.configs import registry as treg
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.models.sharding import (is_dtensor, place_params,
                                             use_rules)
    out = {}
    for key, case in cases.items():
        a = archs[case["arch"]]
        cfg = dataclasses.replace(treg.reduced(treg.ARCHS[case["arch"]]),
                                  capacity_factor=a["capacity_factor"],
                                  grad_accum=case.get("accum", 1))
        _, logical = steps.abstract_params(cfg)
        params = place_params(tf.params_from_numpy(
            a["params"], device="cpu", dtype=getattr(torch, case["dtype"])),
            logical, rules)
        batch = {k: torch.from_numpy(v) for k, v in a["batch"].items()}
        r = {}
        if case.get("grads"):
            with use_rules(rules):
                (loss, metrics, grads), keys = _functional(
                    lambda: steps.loss_and_grads(
                        cfg, params, steps.place_batch(cfg, batch, rules)))
            r.update(loss=float(loss), metrics={
                k: float(v) for k, v in metrics.items()},
                grads=_numpy_whole(grads), grad_shapes=_local_shapes(grads),
                grad_collectives=keys,
                plain=[i for i, g in enumerate(tree_leaves(grads))
                       if not is_dtensor(g)])
        if case.get("opt"):
            opt = train_opt(optim, case["opt"])
            state = opt.init(params)
            r["state_shapes"] = _local_shapes(
                {k: v for k, v in state.items() if k != "step"})
            step = steps.build_train_step(cfg, rules, opt)
            (new_p, new_s, metrics), keys = _functional(
                lambda: step(params, state, batch))
            r.update(step_metrics={k: float(v) for k, v in metrics.items()},
                     params=_numpy_whole(new_p),
                     state=_numpy_whole({k: v for k, v in new_s.items()
                                         if k != "step"}),
                     step=int(new_s["step"]),
                     new_state_shapes=_local_shapes(
                         {k: v for k, v in new_s.items() if k != "step"}),
                     placements_kept=all(
                         tuple(n.placements) == tuple(o.placements)
                         for n, o in zip(tree_leaves(new_p),
                                         tree_leaves(params))),
                     step_collectives=keys)
            held = whole = 0
            for t in tree_leaves(params) + tree_leaves(
                    {k: v for k, v in state.items() if k != "step"}):
                held += t.to_local().numel() * t.element_size()
                whole += t.numel() * t.element_size()
            r["bytes"] = (held, whole)
        out[key] = r
    return out


# -- gradients of the mesh primitives -----------------------------------------


def _placement(code):
    """"S<d>", "R" or "P" as a DTensor placement."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if code == "R":
        return Replicate()
    if code == "P":
        return Partial()
    return Shard(int(code[1:]))


def _on_mesh(t, logical, rules, param):
    """`t` (numpy) as a leaf that autograd tracks: on the mesh a DTensor
    placed by the param rules (`param`) or the activation rules over its
    logical axes, in one process a plain tensor."""
    from repro_torch.models.sharding import place, placements, resolve_spec
    x = torch.from_numpy(t)
    if rules is not None:
        spec = resolve_spec(x.shape, logical, rules.param_rules if param
                            else rules.act_rules, rules)
        x = place(x, placements(spec, rules.mesh), rules.mesh)
    return x.detach().requires_grad_(x.is_floating_point())


def _loss(*pairs):
    """sum(whole(y) * w) over (y, w) pairs: a plain scalar, the same on
    every rank."""
    from repro_torch.models.sharding import whole
    total = 0.0
    for y, w in pairs:
        total = total + (whole(y) * torch.from_numpy(w)).sum()
    return total


def _redistribute_case(case, rules):
    """The input held by its placements `pin` (a Partial mesh dim holds
    one of `pieces`, indexed by this rank's coordinate there), then
    `redistribute` to every valid output placement, each backward on its
    own: this rank's local leaf gradient for each output. One process:
    the input is the sum of the pieces, and the gradient of each piece."""
    from repro_torch.models.sharding import (from_local_like, local_slices,
                                             redistribute)
    pieces = torch.from_numpy(case["pieces"])
    shape = tuple(pieces.shape[2:])
    out = {}
    if rules is None:
        for pout in case["pouts"]:
            leaf = pieces.clone().requires_grad_(True)
            y = leaf.sum(dim=(0, 1))
            _loss((y, case["w"])).backward()
            out["/".join(pout)] = leaf.grad.numpy()
        return out
    dm = rules.mesh.device_mesh
    pin = tuple(_placement(c) for c in case["pin"])
    idx = tuple(dm.get_local_rank(i) if p.is_partial() else 0
                for i, p in enumerate(pin))
    sl = local_slices(shape, tuple(p if p.is_shard() else None
                                   for p in pin), dm)
    for pout in case["pouts"]:
        leaf = pieces[idx][sl].clone().requires_grad_(True)
        y = redistribute(from_local_like(leaf, pin, shape, dm),
                         tuple(_placement(c) for c in pout))
        _loss((y, case["w"])).backward()
        out["/".join(pout)] = (idx, tuple((s.start, s.stop) for s in sl),
                               leaf.grad.numpy())
    return out


def _grad_case(case, rules):
    """The case's function on its inputs and the gradient of each input
    (whole, numpy): on the mesh of `rules`, or in one process with
    rules None."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import contract, pick_last, whole
    kind = case["kind"]
    if kind == "redistribute":
        return _redistribute_case(case, rules)
    if kind == "contract":
        ops = [_on_mesh(o, log, rules, param) for o, log, param in
               zip(case["ops"], case["logical"], case["param"])]
        loss = _loss((contract(case["eq"], *ops), case["w"]))
        leaves = dict(enumerate(ops))
    elif kind == "pick_last":
        x = _on_mesh(case["x"], ("batch", "seq", "vocab"), rules, False)
        idx = _on_mesh(case["idx"], ("batch", "seq"), rules, False)
        picked = (pick_last(x, idx) if rules is not None else
                  torch.gather(x, -1, idx.long()[..., None])[..., 0])
        loss = _loss((picked, case["w"]))
        leaves = {"x": x}
    elif kind == "embed":
        table = _on_mesh(case["table"], ("vocab", "embed"), rules, True)
        tokens = _on_mesh(case["tokens"], ("batch", "seq"), rules, False)
        e = (tf._embed_shards(table, tokens) if rules is not None
             else table[tokens.long()])
        pairs = [(e, case["w"])]
        if case["tied"]:
            pairs.append((contract("bsd,dv->bsv", e, table.t()),
                          case["w2"]))
        loss = _loss(*pairs)
        leaves = {"table": table}
    elif kind == "attn":
        q = _on_mesh(case["q"], ("batch", "seq_model", "kv_heads", "heads",
                                 "head_dim"), rules, False)
        k, v = (_on_mesh(case[n], ("batch", "seq", "kv_heads", "head_dim"),
                         rules, False) for n in ("k", "v"))
        pos = torch.arange(q.shape[1])
        o = attn._attn_dispatch(q, k, v, pos, pos, 0.25, True, 0, "naive")
        loss = _loss((o, case["w"]))
        leaves = {"q": q, "k": k, "v": v}
    elif kind == "moe":
        cfg = dataclasses.replace(
            _reduced(case), moe_dispatch=case["dispatch"],
            capacity_factor=case["capacity"])
        p, leaves = _params_on_mesh(case, rules)
        x = _on_mesh(case["x"], ("batch", "seq", None), rules, False)
        y, aux = moe.moe_forward(p, cfg, x)
        loss = _loss((y, case["w"])) + case["aux_weight"] * whole(aux)
        leaves["x"] = x
    elif kind == "mamba":
        from repro_torch.models import ssm
        p, leaves = _params_on_mesh(case, rules)
        x = _on_mesh(case["x"], ("batch", "seq", None), rules, False)
        y, _ = ssm.mamba2_forward(p, _reduced(case), x, impl=case["impl"])
        loss = _loss((y, case["w"]))
        leaves["x"] = x
    elif kind == "wkv":
        from repro_torch.models import rwkv
        p, leaves = _params_on_mesh(case, rules)
        act = ("batch", "seq", "heads", "head_dim")
        names = ("r", "k", "v", "decay", "g")
        rkvwg = [_on_mesh(case[n], act, rules, False) for n in names]
        y, _ = rwkv._wkv_shards(p, *rkvwg, None, 1e-5, torch.float32)
        loss = _loss((y, case["w"]))
        leaves.update(zip(names, rkvwg))
    elif kind == "rwkv_layer":
        from repro_torch.models import rwkv
        p, leaves = _params_on_mesh(case, rules)
        x = _on_mesh(case["x"], ("batch", "seq", None), rules, False)
        y, _ = rwkv.rwkv6_forward(p, _reduced(case), x)
        loss = _loss((y, case["w"]))
        leaves["x"] = x
    elif kind == "encode":
        p, leaves = _params_on_mesh(case, rules)
        frames = torch.from_numpy(case["frames"])
        if rules is not None:
            frames = _on_mesh(case["frames"], ("batch", "seq", None), rules,
                              False).detach()
        loss = _loss((tf._encode(p, _reduced(case), frames), case["w"]))
    elif kind == "cross":
        p, leaves = _params_on_mesh(case, rules)
        x = _on_mesh(case["x"], ("batch", "seq_model", None), rules, False)
        memory = _on_mesh(case["memory"], ("batch", "seq", None), rules,
                          False)
        y = attn.cross_forward(p, _reduced(case), x, memory)
        loss = _loss((y, case["w"]))
        leaves.update(x=x, memory=memory)
    else:
        raise ValueError(kind)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return {n: whole(g).detach().numpy() for n, g in zip(names, grads)}


def _reduced(case):
    """The reduced config of the case's arch."""
    from repro_torch.configs import registry as treg
    return treg.reduced(treg.ARCHS[case["arch"]])


def _params_on_mesh(case, rules):
    """The case's param tree (numpy) as leaves that autograd tracks,
    placed by `place_params` on the mesh of `rules` (None: one process),
    and those leaves by path ("p/<key>/<key>...")."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.sharding import place_params
    p = tree_map(lambda a: torch.from_numpy(a), case["params"])
    if rules is not None:
        p = place_params(p, case["logical"], rules)
    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    leaves = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}/{k}", v)
        else:
            leaves[prefix] = t
    walk("p", p)
    return p, leaves


def grad_cases(cases, rules):
    """Every case under `rules` (None: one process), each with the
    collectives it issued: {key: (result, collectives)}."""
    from repro_torch.models.sharding import mesh_context, use_rules
    out = {}
    for key, case in cases.items():
        with use_rules(rules), mesh_context(rules):
            out[key] = _functional(lambda: _grad_case(case, rules))
    return out


def mesh_grads_job(rank, world, p):
    """`grad_cases` on the world's (data, model) mesh."""
    from repro_torch.models.sharding import make_rules
    mesh = _lm_mesh(p["mesh"])
    return {"mesh": dict(mesh.shape),
            "cases": grad_cases(p["cases"], make_rules(mesh))}


# -- the elastic runner and checkpoints of placed state -----------------------

ELASTIC_STEPS = 6
ELASTIC_CKPT_EVERY = 2
ELASTIC_FAIL_AT = 3
ELASTIC_LR = 1e-3


def elastic_opt(m):
    """The runner tests' AdamW, of the optim package `m` (the port's or
    the reference's): its lr, cosine over the run's steps."""
    return m.adamw(lr=ELASTIC_LR, schedule=m.cosine_schedule(1, ELASTIC_STEPS))


def _whole_numpy(tree):
    """Every leaf's whole value as numpy in its own dtype (a collective on
    the mesh for each DTensor leaf)."""
    from repro_torch.ckpt.checkpoint import flatten, unflatten
    from repro_torch.models.sharding import local_part, whole_on_mesh
    return unflatten(tree, [local_part(whole_on_mesh(t.detach())).numpy()
                            for t in flatten(tree)[0]])


def _elastic_build(p, log_meshes=None):
    """The runner's `build` for reduced llama3.2-1b on p["params"]
    (float32, placed by the mesh's rules) with `elastic_opt`."""
    from repro_torch import optim
    from repro_torch.configs import registry as treg
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import make_rules, place_params
    cfg = treg.reduced(treg.ARCHS["llama3.2-1b"])
    _, logical = steps.abstract_params(cfg)

    def build(mesh):
        if log_meshes is not None:
            log_meshes.append((dict(mesh.shape), mesh.ranks))
        rules = make_rules(mesh)
        params = place_params(tf.params_from_numpy(
            p["params"], device="cpu", dtype=torch.float32), logical, rules)
        opt = elastic_opt(optim)
        fn = steps.build_train_step(cfg, rules, opt)

        def step_fn(state, batch):
            new_p, new_s, metrics = fn(*state, batch)
            return (new_p, new_s), metrics
        return step_fn, (params, opt.init(params))
    return build


def _batches(p):
    return lambda s: {k: torch.from_numpy(v)
                      for k, v in p["batches"][s].items()}


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _saved_on(mesh, p, tmp, name):
    """(a) One AdamW step on `mesh` from p["params"], then (params, state)
    saved by the manager (save_async) and by `save_checkpoint`: the
    directories and the whole values (numpy, on the mesh's rank 0)."""
    from repro_torch.ckpt import CheckpointManager, save_checkpoint
    step_fn, state = _elastic_build(p)(mesh)
    state, _ = step_fn(state, _batches(p)(0))
    out = {}
    mgr = CheckpointManager(os.path.join(tmp, f"manager_{name}"))
    mgr.save_async(1, state)
    mgr.wait()
    out["manager"] = mgr.directory
    out["direct"] = os.path.join(tmp, f"direct_{name}")
    out["direct_returned"] = save_checkpoint(out["direct"], 1, state)
    out["whole"] = _whole_numpy(state)
    out["timings"] = mgr.timings
    return out


def _restored_on(mesh, p, directory):
    """(b) The latest step of `directory` restored onto `mesh` by the
    manager, like the state that `build` places there: per leaf whether
    it equals `sharding.place` of the whole value read from the file
    (values, placements, local shape), and the step picked."""
    from repro_torch.ckpt import CheckpointManager, read_manifest
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.models.sharding import is_dtensor, place
    _, like = _elastic_build(p)(mesh)
    step, got = CheckpointManager(directory).restore_latest(like,
                                                            device="cpu")
    manifest = read_manifest(directory, step)
    flat_like, _ = flatten(like)
    flat_got, _ = flatten(got)
    differ = []
    for i, (meta, ref, g) in enumerate(zip(manifest["leaves"], flat_like,
                                           flat_got)):
        arr = np.load(os.path.join(directory, f"step_{step:08d}",
                                   f"leaf_{i:05d}.npy"))
        want = torch.from_numpy(np.array(arr))
        if is_dtensor(ref):
            want = place(want, ref.placements, mesh)
            same = (is_dtensor(g) and tuple(g.placements) == tuple(
                ref.placements) and g.shape == want.shape
                and g.to_local().shape == want.to_local().shape
                and torch.equal(g.to_local(), want.to_local()))
        else:
            same = not is_dtensor(g) and torch.equal(g, want)
        if not same:
            differ.append(i)
    return {"step": step, "differ": differ, "leaves": len(flat_got)}


def _runner_on(p, directory, log_meshes, **run):
    from repro_torch.launch import elastic
    runner = elastic.ElasticRunner(
        _elastic_build(p, log_meshes), directory,
        model_axis=p["model_axis"], ckpt_every=ELASTIC_CKPT_EVERY,
        device="cpu")
    state, log = runner.run(ELASTIC_STEPS, _batches(p), **run)
    return runner, state, log


def elastic_job(rank, world, p):
    """On this world: (a) saves on each of p["meshes"] (name -> (ranks,
    model_axis), every rank building each mesh in the same order), (b)
    each of those checkpoints and p["restore_dirs"] restored onto each
    mesh, (c) `ElasticRunner` with a failure injected (the survivors'
    final params whole; with p["resume_check"] the survivor's steps after
    the restore beside one process resumed from a copy of the same
    checkpoint), (d) with p["resume_dir"] a copy of a one-process
    checkpoint resumed on the world's ranks."""
    import shutil

    import torch.distributed as dist
    from repro_torch.launch import elastic
    tmp = os.path.join(p["tmp"], f"rank{rank}")
    os.makedirs(tmp, exist_ok=True)
    shared = p["tmp"]
    out = {"saved": {}, "restored": {}}
    meshes = {name: elastic.make_mesh_from(list(ranks), axis, device="cpu")
              for name, (ranks, axis) in p["meshes"].items()}
    out["meshes"] = {name: (dict(m.shape), m.ranks, m.member,
                            m.rank if m.member else None)
                     for name, m in meshes.items()}
    for name, mesh in meshes.items():
        if mesh.member:
            r = _saved_on(mesh, p, shared if mesh.rank == 0 else tmp, name)
            out["saved"][name] = r if mesh.rank == 0 else {
                k: r[k] for k in ("direct_returned", "timings")}
    dist.barrier()
    dirs = dict(p["restore_dirs"])
    dirs.update({f"save_{n}": os.path.join(shared, f"manager_{n}")
                 for n in meshes})
    for name, mesh in meshes.items():
        if mesh.member:
            out["restored"][name] = {k: _restored_on(mesh, p, d)
                                     for k, d in dirs.items()}
    dist.barrier()
    # (c) the runner
    run_dir = os.path.join(shared, "run")
    built = []
    runner, state, log = _runner_on(p, run_dir, built,
                                    inject_failure_at=ELASTIC_FAIL_AT)
    out.update(log=log, built=built, survivor=state is not None,
               timings=runner.manager.timings)
    if state is not None:
        whole = _whole_numpy(state[0])
        if rank == 0:
            out["final_params"] = whole
    if p.get("resume_check") and state is not None and rank == 0:
        restored = [e for e in log if e[0] == "remesh"][0][1] - 1
        again = os.path.join(tmp, "resumed")
        shutil.copytree(os.path.join(run_dir, f"step_{restored:08d}"),
                        os.path.join(again, f"step_{restored:08d}"))
        _, _, log1 = _runner_on(p, again, None,
                                devices=[torch.device("cpu")])
        last = f"step_{ELASTIC_STEPS - 1:08d}"
        out["resume"] = {
            "log": log1, "restored": restored,
            "files_equal": _files(os.path.join(run_dir, last))
            == _files(os.path.join(again, last))}
    dist.barrier()
    # (d) a copy of a one-process checkpoint resumed on every rank
    if p.get("resume_dir"):
        d = os.path.join(shared, "resume_world")
        if rank == 0:
            shutil.copytree(p["resume_dir"], d)
        dist.barrier()
        _, _, log2 = _runner_on(p, d, None)
        out["resumed_world"] = log2
    return out
