"""`repro_torch.core.distributed` against `repro.core.distributed` on one
device: placement keeps the field's outputs, rays land on the device,
the uniform render step within 1e-4 of the reference's, and one train
step's loss within 1e-5 relative and parameters within 1e-4. The store
and the engine place through it, as the reference's do."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           jax_case, n, numpy_params, t, tiny_cfg,
                           torch_cfg)
from repro.core import distributed as jdist
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.core import rendering as jrender
from repro.data import rays as jrays
from repro.optim import adamw as jadamw
from repro_torch.core import distributed as tdist
from repro_torch.core import field as tfield
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import RenderEngine, SceneStore

RES = 12


def _tensors(field):
    out = list(field.extras.values()) if hasattr(field, "extras") else []
    if hasattr(field, "factors"):
        for efs in field.factors.values():
            for ef in efs:
                for part in (ef.dense, ef.bitmap, ef.coo):
                    if part is None:
                        continue
                    if isinstance(part, torch.Tensor):
                        out.append(part)
                    else:
                        out += [v for v in vars(part).values()
                                if isinstance(v, torch.Tensor)]
    else:
        out += list(field.params.values())
    return out


@pytest.mark.parametrize("kind", ["dense", "bitmap", "coo"])
def test_place_field_keeps_outputs_and_moves_every_tensor(kind):
    if kind == "dense":
        cfg = tiny_cfg()
        f = tfield.DenseField({k: t(v) for k, v in
                               numpy_params(cfg, 0).items()},
                              torch_cfg(cfg))
    else:
        cfg, cf, *_ = jax_case(0.6 if kind == "bitmap" else 0.9,
                               threshold=0.99 if kind == "bitmap" else 0.80)
        f = carry_field(cf, cfg)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.4, 1.4, (200, 3)).astype(np.float32))
    placed = tdist.place_field(f, "cpu")
    assert type(placed) is type(f)
    torch.testing.assert_close(placed.sigma(pts), f.sigma(pts), rtol=0,
                               atol=0)
    for a, b in zip(placed.sigma_app(pts), f.sigma_app(pts)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    meta = tdist.place_field(f, "meta")
    tensors = _tensors(meta)
    assert len(tensors) == len(_tensors(f)) > 0
    assert all(x.device.type == "meta" for x in tensors)
    assert tfield.field_state(placed)[0] == tfield.field_state(f)[0]


def test_place_field_takes_a_params_dict():
    cfg = tiny_cfg()
    params = numpy_params(cfg, 1)
    placed = tdist.place_field(params, "cpu")
    assert sorted(placed) == sorted(params)
    for k, v in params.items():
        assert placed[k].device == CPU
        np.testing.assert_array_equal(n(placed[k]), v)


def test_shard_rays_places_numpy_and_tensors(monkeypatch):
    rng = np.random.default_rng(0)
    o, d = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    for args in ((o, d), (torch.from_numpy(o), torch.from_numpy(d))):
        ro, rd = tdist.shard_rays("cpu", *args)
        assert ro.device == rd.device == CPU
        np.testing.assert_array_equal(n(ro), o)
        np.testing.assert_array_equal(n(rd), d)
    ro, rd = tdist.shard_rays("meta", o, d)
    assert ro.device.type == rd.device.type == "meta"
    assert ro.shape == (64, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.shard_rays(None, o, d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.place_field(numpy_params(tiny_cfg(), 0), None)


def _rays(cam):
    o, d = jrender.camera_rays(cam)
    return np.array(o), np.array(d)


def test_render_step_matches_reference():
    cfg, cf, *_ = jax_case(0.9, threshold=0.80)
    jf = cf.decode()
    occ = jocc.build_occupancy(jf, cfg, sigma_thresh=0.01)
    o, d = _rays(jrays.make_cameras(2, RES, RES)[1])
    want = jdist.build_render_step(cfg)(jf.params, occ, jnp.asarray(o),
                                        jnp.asarray(d))
    params = {k: t(v) for k, v in jf.params.items()}
    got = tdist.build_render_step(torch_cfg(cfg))(
        params, t(occ), torch.from_numpy(o), torch.from_numpy(d))
    assert got.shape == (RES * RES, 3)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    # an encoded field renders the same image through the gathers
    enc = tdist.build_render_step(torch_cfg(cfg))(
        carry_field(cf, cfg), t(occ), torch.from_numpy(o),
        torch.from_numpy(d))
    np.testing.assert_allclose(n(enc), np.asarray(want), atol=1e-4)


def test_train_step_matches_reference():
    cfg = tiny_cfg()
    scene = jrays.make_scene("lego")
    cam = jrays.make_cameras(3, RES, RES)[2]
    o, d = _rays(cam)
    rgb = np.asarray(jrays.render_gt(scene, cam))
    sel = np.random.default_rng(0).choice(o.shape[0], 96, replace=False)
    batch = {"rays_o": o[sel], "rays_d": d[sel], "rgb": rgb[sel]}
    params = numpy_params(cfg, 3)

    jopt = jadamw(lr=cfg.lr_grid, b2=0.99)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp1, jstate, jloss = jdist.build_nerf_train_step(cfg, jopt)(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})

    topt = tadamw(lr=cfg.lr_grid, b2=0.99)
    tp = {k: t(v) for k, v in params.items()}
    step = tdist.build_nerf_train_step(torch_cfg(cfg), topt)
    tp1, tstate, tloss = step(tp, topt.init(tp),
                              {k: t(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert sorted(tp1) == sorted(jp1)
    for k in jp1:
        np.testing.assert_allclose(n(tp1[k]), np.asarray(jp1[k]),
                                   atol=1e-4, err_msg=k)
    assert int(tstate["step"]) == int(jstate["step"]) == 1


def test_store_and_engine_place_through_distributed(monkeypatch, tmp_path):
    cfg, cf, *_ = jax_case(0.9, threshold=0.80)
    occ = jocc.build_occupancy(cf, cfg, sigma_thresh=0.01)
    cubes = carry_cubes(jocc.extract_cubes(occ, cfg))
    calls = {"place_field": 0, "shard_rays": 0}

    def counted(name):
        inner = getattr(tdist, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return inner(*a, **kw)
        return wrapper
    for name in calls:
        monkeypatch.setattr(tdist, name, counted(name))
    store = SceneStore(torch_cfg(cfg), device=CPU, spill_dir=str(tmp_path))
    store.register("a", carry_field(cf, cfg), cubes)
    assert calls["place_field"] == 1
    before = {k: n(v) for k, v in
              tfield.field_state(store.get_field("a"))[1].items()}
    store.evict("a")
    store.ensure_resident("a")                   # the revive path
    assert calls["place_field"] == 2
    after = tfield.field_state(store.get_field("a"))[1]
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        np.testing.assert_array_equal(n(after[k]), v)
    eng = RenderEngine(torch_cfg(cfg), store=store, ray_chunk=RES * RES)
    cams = jrays.make_cameras(2, RES, RES)
    res = [eng.submit(carry_camera(c), scene="a") for c in cams]
    eng.flush()
    assert all(r.result().img.shape == (RES * RES, 3) for r in res)
    assert calls["shard_rays"] == 2                # one per ray chunk
    assert jfield.field_state(cf)[0] == tfield.field_state(
        store.get_field("a"))[0]
