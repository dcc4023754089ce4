"""The port's mesh layer against the reference: the placements of
`param_sharding`, `nerf_param_sharding` and `ray_sharding` equal the
reference's PartitionSpecs, and `make_mesh_from` gives its shapes; on
2 and 4 CPU ranks over gloo, `RenderEngine(mesh=)` renders the views of
the reference's single-device engine on the tiny field of
`tests/test_serving.py::test_stream_sharding_multidevice` within 1e-4,
with its counters exactly, through sharded chunks and through a chunk
that does not divide the ranks (99 rays: the reference's 100-ray chunk
on 8 devices divides 2 and 4); on 2 ranks the store evicts as the
reference's store does, `build_render_step` and `build_nerf_train_step`
give the reference's one-device step on the (2, 1) host mesh and, with
the field's R channels split over "model", on 1 x 2, 2 x 2 and 1 x 4
(where r_sigma = 2 stays whole), and the serving launcher prints the
PSNRs of one rank. Each world is spawned once (`_torch_mesh_ranks`)
and its results asserted case by case. The reference's own engine on a
mesh fails here (ROADMAP.md Queue 3 item 26), so its single-device
engine is the oracle: GSPMD's sharded engine computes exactly that."""
import contextlib
import dataclasses
import io
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_mesh_ranks as ranks
from _lm_parity import close_adamw_first_step
from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           numpy_params, torch_cfg)
from repro.configs import registry as jreg
from repro.configs.rtnerf import NeRFConfig
from repro.core import distributed as jdist
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.core import rendering as jrender
from repro.core import tensorf as jtensorf
from repro.data import rays as jrays
from repro.launch import steps as jsteps
from repro.models import sharding as jsharding
from repro.optim import adamw as jadamw
from repro.serving import RenderEngine as JaxEngine
from repro.serving import SceneStore as JaxStore
from repro_torch.configs import registry as treg
from repro_torch.core import distributed as tdist
from repro_torch.launch import elastic as telastic
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as tsharding
from repro_torch.serving import RenderEngine

CFG = NeRFConfig(grid_res=16, occ_res=16, cube_size=4, max_cubes=64,
                 r_sigma=2, r_color=4, app_dim=4, mlp_hidden=8,
                 max_samples_per_ray=32, train_rays=64)
RAY_CHUNK = 256
ODD_CHUNK = 99
WORLDS = (2, 4)
STEP_RES = 12
TRAIN_RAYS = 96
# the meshes of the render and train steps in each world: (data, model)
STEP_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
SPLIT = [(w, shape) for w, shapes in STEP_MESHES.items()
         for shape in shapes if shape[1] > 1]
SPLIT_IDS = [f"{w}ranks-{d}x{m}" for w, (d, m) in SPLIT]
# the encoded field of the render step: the scene's slices lie 0.875 to
# 0.9375 sparse, so at this threshold some are bitmap and some COO
STEP_THRESHOLD = 0.9
LAUNCH_ARGS = ["--arch", "rtnerf", "--scene", "lego", "--views", "1",
               "--res", "16", "--train-steps", "2", "--device", "cpu"]
STORE_OPS = [("register", "a", "s0"), ("register", "b", "s1"),
             ("snapshot", "a"), ("register", "c", "s2"),   # evicts b
             ("snapshot", "b"),                            # revives b
             ("snapshot", "a"), ("evict", "c"), ("snapshot", "c")]


# -- specs: no ranks ----------------------------------------------------------


class _Sharding:
    """Stands in for NamedSharding on a mesh that has no devices here."""

    def __init__(self, mesh, spec):
        self.spec = spec


def _placements_of(spec, axis_names):
    """A reference PartitionSpec as DTensor placements, one per mesh dim."""
    out = []
    for axis in axis_names:
        dims = [d for d, e in enumerate(tuple(spec))
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


MESHES = [{"data": 2, "model": 2}, {"data": 4, "model": 1}]


def _rules(shape, monkeypatch):
    for mod in (jsharding, jdist):
        monkeypatch.setattr(mod, "NamedSharding", _Sharding)
    fake = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    return (jsharding.make_rules(fake), tsharding.make_rules(
        tmesh.HostMesh(dict(shape), tuple(shape), None)))


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1"])
def test_param_sharding_placements_are_the_references(shape, monkeypatch):
    """Every arch at full size: each leaf's placements are the reference's
    PartitionSpec on a mesh of that shape."""
    jr, tr = _rules(shape, monkeypatch)
    for name in sorted(treg.ARCHS):
        jsds, jlog = jsteps.abstract_params(jreg.ARCHS[name])
        tspecs, tlog = tsteps.abstract_params(treg.ARCHS[name])
        want = jax.tree.map(lambda s: _placements_of(s.spec, tuple(shape)),
                            jsharding.param_sharding(jsds, jlog, jr),
                            is_leaf=lambda x: isinstance(x, _Sharding))
        got = tsharding.param_sharding(tspecs, tlog, tr)
        assert jax.tree.leaves(got, is_leaf=lambda x: isinstance(
            x, tuple)) == jax.tree.leaves(want, is_leaf=lambda x: isinstance(
                x, tuple)), name


@pytest.mark.parametrize("shape", MESHES + [{"data": 8, "model": 1}],
                         ids=["2x2", "4x1", "8x1"])
def test_nerf_and_ray_sharding_are_the_references(shape, monkeypatch):
    jr, tr = _rules(shape, monkeypatch)
    names = tuple(shape)
    params = jax.eval_shape(lambda k: jtensorf.init_field(CFG, k),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    want = jdist.nerf_param_sharding(CFG, params, jr)
    got = tdist.nerf_param_sharding(CFG, params, tr)
    assert got == {k: _placements_of(v.spec, names) for k, v in want.items()}
    for n in (256, 100, 4096, 3):
        assert tdist.ray_sharding(tr, n) == _placements_of(
            jdist.ray_sharding(jr, n).spec, names), n
    assert tdist.stream_sharding(tr) == _placements_of(
        jdist.stream_sharding(jr).spec, names)


def test_make_mesh_from_gives_the_references_shapes():
    """`tests/test_sharding.py::test_elastic_remesh_8_to_4_devices`'s
    shapes from ranks and from devices; repeats count once; devices of
    two types raise."""
    for devices, want in ((range(8), (4, 2)), (range(4), (2, 2)),
                          (range(3), (3, 1)), (range(1), (1, 1)),
                          (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], (2, 2))):
        mesh = telastic.make_mesh_from(list(devices), model_axis=2)
        assert mesh.shape == {"data": want[0], "model": want[1]}
        assert mesh.axis_names == ("data", "model")
    assert telastic.make_mesh_from(range(8), 1).shape == {"data": 8,
                                                          "model": 1}
    one = telastic.make_mesh_from(["cpu", torch.device("cpu")], 2)
    assert one.size == 1 and one.device == torch.device("cpu")
    with pytest.raises(ValueError, match="one device type"):
        telastic.make_mesh_from(["cpu", "meta"], 1)
    with pytest.raises(ValueError, match="model_axis"):
        telastic.make_mesh_from(range(4), 0)


def test_meshes_without_a_process_group(tmp_path):
    """The host mesh is one device without a process group; a pipeline
    mesh of several ranks needs one; a mesh of shapes alone refuses to
    communicate; and the elastic runner on several devices raises (no
    run quietly trains on one)."""
    m = tmesh.make_host_mesh("cpu")
    assert (m.shape, m.size, m.rank, m.group("data")) == (
        {"data": 1, "model": 1}, 1, 0, None)
    p = tmesh.make_pipeline_mesh(stages=1, data=1, model=1, device="cpu")
    assert p.axis_names == ("stage", "data", "model") and p.size == 1
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_pipeline_mesh(stages=4, data=2, model=1, device="cpu")
    spec = telastic.make_mesh_from(range(4), 2)
    assert spec.device is None and spec.device_mesh is None
    with pytest.raises(ValueError, match="shape only"):
        spec.coordinate("data")
    with pytest.raises(ValueError, match="rank and world_size"):
        tmesh.init_ranks("cpu", init_method="file:///nonexistent")
    runner = telastic.ElasticRunner(build=None, ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="needs a process group"):
        runner.run(1, lambda s: {}, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="needs a process group"):
        runner.run(1, lambda s: {}, devices=range(4))


# -- the worlds ---------------------------------------------------------------


def _state(field, cubes):
    spec, arrays = jfield.field_state(field)
    return (spec, {k: np.asarray(v) for k, v in arrays.items()},
            (np.asarray(cubes.centers), np.asarray(cubes.valid), cubes.count,
             cubes.radius, np.asarray(cubes.occ)))


def _scene():
    """`tests/test_serving.py::test_stream_sharding_multidevice`'s field
    (pruned dense), its occupancy grid and cube set."""
    field = jfield.DenseField(jtensorf.init_field(CFG, jax.random.PRNGKey(0)),
                              CFG).prune(sparsity=0.9)
    occ = jocc.build_occupancy(field, CFG, sigma_thresh=0.01)
    return field, occ, jocc.extract_cubes(occ, CFG)


def _store_scene(seed):
    params = {k: jnp.asarray(v) for k, v in numpy_params(CFG, seed).items()}
    field = jfield.DenseField(params, CFG).prune(sparsity=0.9)
    return field, jocc.extract_cubes(jocc.build_occupancy(
        field, CFG, sigma_thresh=0.01), CFG)


def _one_device_engine(cf, cubes, cams, chunk):
    """The port's engine on one device: its per-view counters (the
    reference's views carry none; `tests/test_torch_engine.py` holds this
    engine to the reference's)."""
    eng = RenderEngine(torch_cfg(CFG), carry_field(cf, CFG),
                       carry_cubes(cubes), ray_chunk=chunk, device=CPU,
                       trace_requests=False)
    cams = [carry_camera(c) for c in cams]
    return [v["stats"] for v in ranks._views(eng, cams)
            + ranks._views(eng, cams)]


def _reference_engine(cf, cubes, cams, chunk):
    eng = JaxEngine(CFG, cf, cubes, ray_chunk=chunk, trace_requests=False)
    views = []
    for _ in range(2):
        futs = [eng.submit(c) for c in cams]
        eng.flush()
        views += [f.result() for f in futs]
    st = eng.stats()
    return {"views": [{"img": r.img, "depth": r.depth, "opacity": r.opacity,
                       "stats": dict(r.stats)} for r in views],
            "stats": {k: st[k] for k in ranks.ENGINE_STATS}}


def _reference_store(scenes, budget, spill):
    store = JaxStore(CFG, max_resident_bytes=budget, spill_dir=spill)
    seq = []
    for op, name, *arg in STORE_OPS:
        if op == "register":
            store.register(name, *scenes[arg[0]])
        else:
            getattr(store, op)(name)
        seq.append((store.resident_scenes(), store.resident_bytes()))
    return {"seq": seq, "evictions": store.evictions_total,
            "revivals": store.revivals_total}


def _ray_arrays(cam):
    o, d = jrender.camera_rays(cam)
    return np.array(o), np.array(d)


def _steps(field, occ):
    """The inputs of the render and train steps: the scene's dense
    params, occupancy and a view's rays; numpy params of seed 3 and 96
    rays of another view with target colours from a seed."""
    o, d = _ray_arrays(jrays.make_cameras(2, STEP_RES, STEP_RES)[1])
    to, td = _ray_arrays(jrays.make_cameras(3, STEP_RES, STEP_RES)[2])
    rng = np.random.default_rng(0)
    sel = rng.choice(to.shape[0], TRAIN_RAYS, replace=False)
    batch = {"rays_o": to[sel], "rays_d": td[sel],
             "rgb": rng.uniform(0, 1, (TRAIN_RAYS, 3)).astype(np.float32)}
    return {"step_cfg": dataclasses.asdict(CFG),
            "render_params": {k: np.asarray(v)
                              for k, v in field.params.items()},
            "occ": np.asarray(occ), "render_o": o, "render_d": d,
            "train_params": numpy_params(CFG, 3), "batch": batch}


def _reference_steps(p, cf):
    """The reference's one-device render step (of the dense params and
    of the encoded field `cf`) and train step."""
    jnp_ = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    render = jdist.build_render_step(CFG)
    rays = (jnp.asarray(p["occ"]), jnp.asarray(p["render_o"]),
            jnp.asarray(p["render_d"]))
    rgb = render(jnp_(p["render_params"]), *rays)
    rgb_encoded = render(cf, *rays)
    opt = jadamw(lr=CFG.lr_grid, b2=0.99)
    jp = jnp_(p["train_params"])
    jp1, jstate, jloss = jdist.build_nerf_train_step(CFG, opt)(
        jp, opt.init(jp), jnp_(p["batch"]))
    return {"rgb": np.asarray(rgb), "rgb_encoded": np.asarray(rgb_encoded),
            "loss": float(jloss), "params": jp1, "m": jstate["m"],
            "lr": CFG.lr_grid}


def _psnrs(out: str):
    return [float(x) for x in re.findall(r"view \d+: psnr=([-\d.]+)", out)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run while this process computes the reference's
    outputs."""
    field, occ, cubes = _scene()
    cf = field.encode()
    cams = jrays.make_cameras(3, 16, 16)
    store_scenes = {f"s{i}": _store_scene(i) for i in range(3)}
    budget = int(2.5 * jfield.as_backend(store_scenes["s0"][0], CFG)
                 .encode().factor_bytes())
    steps_in = _steps(field, occ)
    step_cf = field.encode(STEP_THRESHOLD)
    tmp = tmp_path_factory.mktemp("mesh")
    payload = {"cfg": dataclasses.asdict(CFG), "scene": _state(cf, cubes),
               "cams": [(np.array(c.c2w), np.array(c.origin), c.focal, c.h,
                         c.w) for c in cams],
               "ray_chunk": RAY_CHUNK, "odd_chunk": ODD_CHUNK,
               "store_scenes": list(store_scenes), "store_ops": STORE_OPS,
               "store_budget": budget, "spill_dir": str(tmp / "spill"),
               "launch_args": LAUNCH_ARGS + ["--ckpt-dir",
                                             str(tmp / "ckpt2")],
               **{k: _state(*v) for k, v in store_scenes.items()},
               **steps_in, "step_meshes": STEP_MESHES,
               "step_field": _state(step_cf, cubes)}
    started = {}
    for world in WORLDS:
        wdir = tmp / f"world{world}"
        wdir.mkdir()
        jobs = ["engine", "steps"] + (["store", "launch"] if world == 2
                                      else [])
        started[world] = ranks.start(ranks.world_job, world, wdir,
                                     {**payload, "jobs": jobs})
    try:
        want = {}
        for key, chunk in (("sharded", RAY_CHUNK), ("replicated", ODD_CHUNK)):
            want[key] = _reference_engine(cf, cubes, cams, chunk)
            want[key]["one_device"] = _one_device_engine(cf, cubes, cams,
                                                         chunk)
        store = _reference_store(store_scenes, budget, str(tmp / "jspill"))
        steps = _reference_steps(steps_in, step_cf)
        from repro_torch.launch import serve as tserve
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tserve.main(LAUNCH_ARGS + ["--ckpt-dir", str(tmp / "ckpt1")])
    finally:
        out = {w: ranks.join(s, timeout_s=240.0) for w, s in started.items()}
    return {"ranks": out, "want": want, "store": store, "steps": steps,
            "launch_one_rank": buf.getvalue()}


CASES = [(w, k) for w in WORLDS for k in ("sharded", "replicated")]
IDS = [f"{w}ranks-{k}" for w, k in CASES]


@pytest.mark.parametrize("world,key", CASES, ids=IDS)
def test_engine_images_match_the_reference(worlds, world, key):
    want = worlds["want"][key]["views"]
    for rank, res in enumerate(worlds["ranks"][world]):
        got = res["engine"][key]["views"]
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            for k in ("img", "depth", "opacity"):
                assert g[k].shape == w[k].shape, (rank, k)
                np.testing.assert_allclose(g[k], w[k], atol=1e-4,
                                           err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("world,key", CASES, ids=IDS)
def test_engine_counters_are_exact(worlds, world, key):
    """dropped_pairs, processed_samples and active_pairs_max a view as one
    device counts them, and the engine's counters, budget and last pair
    occupancy (the largest active pairs over the budget) as the
    reference's engine has them. The reference drops no pair at this
    budget, so the per-rank budget drops none either."""
    want = worlds["want"][key]
    assert want["stats"]["dropped_pairs"] == 0
    assert want["stats"]["pair_occupancy_last"] > 0
    for res in worlds["ranks"][world]:
        got = res["engine"][key]
        for g, w in zip(got["views"], want["one_device"]):
            for k in ("dropped_pairs", "processed_samples",
                      "active_pairs_max", "occ_accesses"):
                assert g["stats"][k] == w[k], k
        for g, w in zip(got["views"], want["views"]):
            assert g["stats"]["occ_accesses"] == w["stats"]["occ_accesses"]
        for k in ("views_served", "flushes", "dropped_pairs",
                  "pair_budget", "pair_budget_resizes",
                  "pair_occupancy_last"):
            assert got["stats"][k] == want["stats"][k], k


@pytest.mark.parametrize("world", WORLDS)
def test_engine_n_devices_is_the_world(worlds, world):
    for res in worlds["ranks"][world]:
        for key in ("sharded", "replicated"):
            assert res["engine"][key]["stats"]["n_devices"] == world
    assert worlds["want"]["sharded"]["stats"]["n_devices"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_engine_auto_flush_follows_rank_0(worlds, world):
    """With the flush thread on every rank (rank 0's times the flushes,
    the others follow), every view resolves to the reference's image and
    close() stops every thread."""
    want = worlds["want"]["sharded"]["views"]
    for res in worlds["ranks"][world]:
        got = res["engine"]["auto_flush"]
        assert got["views_served"] == len(got["imgs"]) == 3
        assert not got["running"]
        for g, w in zip(got["imgs"], want):
            np.testing.assert_allclose(g, w["img"], atol=1e-4)


def test_store_evicts_as_the_reference_on_each_rank(worlds):
    want = worlds["store"]
    assert want["evictions"] >= 2 and want["revivals"] >= 2
    dirs = set()
    for rank, res in enumerate(worlds["ranks"][2]):
        got = res["store"]
        assert got["seq"] == want["seq"], rank
        assert (got["evictions"], got["revivals"]) == (want["evictions"],
                                                       want["revivals"])
        assert got["spill_dir"].endswith(f"rank{rank}")
        dirs.add(got["spill_dir"])
    assert len(dirs) == 2


def test_render_step_on_two_ranks(worlds):
    want = worlds["steps"]["rgb"]
    for res in worlds["ranks"][2]:
        got = res["steps"][(2, 1)]["rgb"]
        assert got.shape == want.shape == (STEP_RES ** 2, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_train_step_on_two_ranks(worlds):
    """The loss within 1e-5 relative of the reference's one-device step;
    the params after it by AdamW's first-step rule, equal on both ranks."""
    want = worlds["steps"]
    got = [res["steps"][(2, 1)] for res in worlds["ranks"][2]]
    for g in got:
        assert abs(g["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert g["step"] == 1
        close_adamw_first_step(g["params"], want["params"], want["m"],
                               want["lr"], 0.9, 1e-8, 1e-5)
    for k in got[0]["params"]:
        np.testing.assert_array_equal(got[0]["params"][k],
                                      got[1]["params"][k])


def _split_runs(worlds, world, shape):
    return [res["steps"][shape] for res in worlds["ranks"][world]]


@pytest.mark.parametrize("world,shape", SPLIT, ids=SPLIT_IDS)
def test_split_render_step_matches_the_reference(worlds, world, shape):
    """The dense params split over "model": every rank returns the
    reference's one-device image within 1e-4."""
    want = worlds["steps"]["rgb"]
    for rank, got in enumerate(_split_runs(worlds, world, shape)):
        assert got["rgb"].shape == want.shape == (STEP_RES ** 2, 3)
        np.testing.assert_allclose(got["rgb"], want, atol=1e-4,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("world,shape", SPLIT, ids=SPLIT_IDS)
def test_split_render_step_of_an_encoded_field(worlds, world, shape):
    """An encoded field (bitmap and COO slices) on a "model" axis stays
    whole on every rank and renders the reference's image within 1e-4
    through the gathers' plain versions (on the CPU), each called on
    every rank."""
    want = worlds["steps"]["rgb_encoded"]
    for rank, got in enumerate(_split_runs(worlds, world, shape)):
        np.testing.assert_allclose(got["rgb_encoded"], want, atol=1e-4,
                                   err_msg=f"rank {rank}")
        assert got["gather_calls"]["bitmap_gather_ref"] > 0, rank
        assert got["gather_calls"]["coo_gather_ref"] > 0, rank


@pytest.mark.parametrize("world,shape", SPLIT, ids=SPLIT_IDS)
def test_split_train_step_matches_the_reference(worlds, world, shape):
    """The loss within 1e-5 relative of the reference's one-device step
    on every rank; the params, made whole from the ranks' shards, by
    AdamW's first-step rule at 1e-5."""
    want = worlds["steps"]
    for got in _split_runs(worlds, world, shape):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert got["step"] == 1
        close_adamw_first_step(got["params"], want["params"], want["m"],
                               want["lr"], 0.9, 1e-8, 1e-5)


@pytest.mark.parametrize("world,shape", SPLIT, ids=SPLIT_IDS)
def test_split_leaves_hold_their_channels(worlds, world, shape):
    """Each plane and line whose R divides the model axis holds R / m
    channels on dim 1 of every rank, and so do its AdamW moments; every
    other leaf (on 1 x 4 the sigma head, r_sigma = 2) is whole."""
    m = shape[1]
    whole = {k: tuple(np.shape(v)) for k, v in
             worlds["steps"]["params"].items()}
    for got in _split_runs(worlds, world, shape):
        for tree in ("params", "m", "v"):
            for k, full in whole.items():
                gshape, lshape, pls = got["placed"][f"{tree}/{k}"]
                assert gshape == full, (tree, k)
                split = "planes" in k or "lines" in k
                if split and full[1] % m == 0:
                    assert lshape == (full[0], full[1] // m) + full[2:], (
                        tree, k)
                    assert pls == ("Replicate()", "Shard(dim=1)"), (tree, k)
                else:
                    assert lshape == full, (tree, k)
                    assert pls == ("Replicate()", "Replicate()"), (tree, k)
    heads = {k: got["placed"][f"params/{k}"][1][1]
             for k in ("sigma_planes", "app_planes")}
    assert heads == {"sigma_planes": CFG.r_sigma // m if CFG.r_sigma % m == 0
                     else CFG.r_sigma, "app_planes": CFG.r_color // m}


@pytest.mark.parametrize("world,shape", SPLIT, ids=SPLIT_IDS)
def test_split_leaves_agree_across_ranks(worlds, world, shape):
    """After the step, every whole leaf is equal bit for bit on every
    rank, and a split leaf's shard on the ranks that share its model
    coordinate; the shards of one model group make the whole leaf."""
    runs = _split_runs(worlds, world, shape)
    m = shape[1]
    for k, first in runs[0]["local"].items():
        for rank, got in enumerate(runs):
            if first.shape == got["params"][k].shape:
                np.testing.assert_array_equal(got["local"][k], first,
                                              err_msg=f"{k} rank {rank}")
            else:
                np.testing.assert_array_equal(
                    got["local"][k], runs[rank % m]["local"][k],
                    err_msg=f"{k} rank {rank}")
                np.testing.assert_array_equal(
                    np.concatenate([r["local"][k] for r in runs[:m]], 1),
                    got["params"][k], err_msg=k)


@pytest.mark.parametrize("world,shape", SPLIT, ids=SPLIT_IDS)
def test_split_steps_run_no_functional_collective(worlds, world, shape):
    """The split steps' collectives are gloo's `dist` ones (the sums over
    "model"), never DTensor's functional collectives."""
    for got in _split_runs(worlds, world, shape):
        assert "gloo:all_reduce" in got["collectives"], got["collectives"]
        assert not [c for c in got["collectives"]
                    if c.startswith("_c10d_functional::")]


def test_launcher_on_two_ranks_prints_one_ranks_psnr(worlds):
    one = _psnrs(worlds["launch_one_rank"])
    out = [res["launch"] for res in worlds["ranks"][2]]
    assert len(one) == 1
    assert _psnrs(out[0]) == one
    assert "2 ranks" in out[0]
    assert out[1] == ""                       # rank 0 prints
