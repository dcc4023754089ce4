"""The port's evaluation path against the reference on the CPU, at
`demo_config(tiny=True)`: `occupancy_query`, `auto_tile` and
`_cube_samples`, `render_rtnerf`, `render_uniform`, `eval_view` and
`sparsity_report`. Inputs are made with numpy from a seed; both packages
get the same field, cube set and cameras (images within 1e-4, counts
and reports exact)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (carry_camera, carry_cubes, carry_field, n,
                           numpy_params, t, tiny_cfg, torch_cfg)
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.core import pipeline as jpipe
from repro.core import rendering as jrender
from repro.core import train as jtrain
from repro.data import rays as jrays
from repro_torch.core import occupancy as tocc
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rendering as trender
from repro_torch.core import train as ttrain

IMG_TOL = 1e-4
STAT_KEYS_RT = ("occ_accesses", "candidate_samples", "processed_samples",
                "n_cubes", "tile", "factor_bytes", "factor_bytes_dense")
STAT_KEYS_UNI = ("occ_accesses", "candidate_samples", "preexisting_samples",
                 "processed_samples")


def blob_params(cfg, seed):
    """Tiny field params whose density is a constant below the occupancy
    cutoff plus two dense Gaussian blobs (so the cube set is partial and
    rays through the blobs terminate early); the other factors are the
    numpy draws of `numpy_params`."""
    rng = np.random.RandomState(seed + 100)
    p = numpy_params(cfg, seed)
    G = cfg.grid_res
    g = np.arange(G, dtype=np.float32)
    p["sigma_planes"][0] = 0.0
    p["sigma_lines"][0] = 0.0
    p["sigma_planes"][0, 0], p["sigma_lines"][0, 0] = -2.0, 1.0
    for j, c in enumerate(rng.uniform(0.3, 0.7, size=(2, 3)) * (G - 1)):
        s = 2.5
        p["sigma_planes"][0, 1 + j] = 60.0 * np.exp(
            -((g[:, None] - c[1]) ** 2 + (g[None, :] - c[2]) ** 2)
            / (2 * s * s))
        p["sigma_lines"][0, 1 + j] = np.exp(-(g - c[0]) ** 2 / (2 * s * s))
    return p


@pytest.fixture(scope="module")
def scene():
    """(cfg, dense field, mixed bitmap/COO field, cube set, cameras) of
    the reference; the cameras' tiles are wider (16 x 16) or taller
    (24 x 40) than their images."""
    cfg = tiny_cfg()
    dense = jfield.DenseField({k: jnp.asarray(v) for k, v in
                               blob_params(cfg, 0).items()}, cfg)
    bm = dense.prune(sparsity=0.6).encode(0.99)
    co = bm.decode().encode(0.0)
    mixed = jfield.CompressedField(
        {"sigma_planes": bm.factors["sigma_planes"],
         "sigma_lines": co.factors["sigma_lines"],
         "app_planes": co.factors["app_planes"],
         "app_lines": bm.factors["app_lines"]}, bm.extras, cfg, bm.threshold)
    assert {ef.fmt for efs in mixed.factors.values() for ef in efs} == {
        "bitmap", "coo"}
    cubes = jocc.extract_cubes(jocc.build_occupancy(mixed, cfg), cfg)
    assert 0 < cubes.count < cfg.cube_grid_res ** 3
    cams = [jrays.make_cameras(3, 16, 16)[0], jrays.make_cameras(5, 24, 40)[2]]
    return cfg, dense, mixed, cubes, cams


def _fields(scene, kind):
    cfg, dense, mixed, *_ = scene
    return dense if kind == "dense" else mixed


def test_occupancy_query_is_exact(scene):
    cfg, _, _, cubes, _ = scene
    rng = np.random.RandomState(3)
    occ = rng.rand(cfg.occ_res, cfg.occ_res, cfg.occ_res) < 0.4
    b = cfg.scene_bound
    pts = rng.uniform(-1.3 * b, 1.3 * b, (4000, 3)).astype(np.float32)
    # exact bounds, cell faces and the points just inside and outside them
    edge = np.float32(b)
    faces = (np.arange(cfg.occ_res + 1) / cfg.occ_res * 2 - 1) * b
    special = np.array([[edge, 0, 0], [-edge, edge, -edge],
                        [np.nextafter(edge, np.float32(2)), 0, 0],
                        [np.nextafter(-edge, np.float32(0)), 0.1, 0.2]],
                       np.float32)
    pts = np.concatenate([pts, special, np.stack(
        [faces, faces[::-1], faces * 0.5], axis=-1).astype(np.float32)])
    for grid in (occ, np.asarray(cubes.occ)):
        want = np.asarray(jocc.occupancy_query(jnp.asarray(grid), cfg,
                                               jnp.asarray(pts)))
        got = tocc.occupancy_query(t(grid), torch_cfg(cfg), t(pts))
        np.testing.assert_array_equal(n(got), want)
        assert 0 < want.sum() < want.size
    # any leading shape, as render_uniform's (R, N, 3)
    got = tocc.occupancy_query(t(occ), torch_cfg(cfg),
                               t(pts[:4000]).reshape(40, 100, 3))
    want = jocc.occupancy_query(jnp.asarray(occ), cfg,
                                jnp.asarray(pts[:4000]).reshape(40, 100, 3))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_auto_tile_matches(scene):
    cfg = scene[0]
    from repro.configs.rtnerf import NeRFConfig as JaxConfig
    for c in (cfg, JaxConfig()):
        for res in (8, 16, 40, 64, 200, 800, 2000):
            cam = jrays.make_cameras(2, res, res)[1]
            assert tpipe.auto_tile(torch_cfg(c), carry_camera(cam)) == \
                jpipe.auto_tile(c, cam)
    assert jpipe.auto_tile(JaxConfig(), jrays.make_cameras(1, 800, 800)[0]) \
        == 80


def _ball_tol(cam, center, d, r):
    """Per-ray tolerance on the ball's sample distances: 1e-6 plus what a
    few ulps of the dot products (|oc|^2 is about 16) move the root
    -b - sqrt(b^2 - |oc|^2 + r^2) by, i.e. 8 eps |oc|^2 / sqrt(disc).
    The reference's own rays round differently on its matmul paths (eager
    pixel_rays and the jitted scan disagree in 8.5% of the rays of a
    16 x 16 tile), so a grazing ray's segment is not defined to 1e-6."""
    oc = (np.asarray(cam.origin, np.float64) - np.asarray(center, np.float64))
    d = np.asarray(d, np.float64)
    b = d @ oc
    disc = np.maximum(b * b - (oc @ oc - r * r), 1e-12)
    return 1e-6 + 8 * np.finfo(np.float32).eps * (oc @ oc) / np.sqrt(disc)


@pytest.mark.parametrize("intersect", ["box", "ball"])
def test_cube_samples_match(scene, intersect):
    """pix_id and s_mask exact; rays within 1e-6; the points and distances
    of the segments' samples within 1e-6 for the box (the slab division
    is well conditioned), and for the ball within `_ball_tol`. Several
    cubes of two cameras (one with a tile wider than its image, so pixel
    ids run past it, one with a tile taller) and a cube behind the
    camera."""
    cfg, _, _, cubes, cams = scene
    tcfg = torch_cfg(cfg)
    centers = np.asarray(cubes.centers)[:cubes.count]
    idx = np.random.RandomState(5).choice(cubes.count, 6, replace=False)
    pick = np.concatenate([centers[idx], [[-1.3, -0.2, -0.4]]]).astype(
        np.float32)
    for cam in cams:
        tcam = carry_camera(cam)
        tile = jpipe.auto_tile(cfg, cam)
        got_all = tpipe._cube_samples(tcfg, tcam, t(pick), tile, intersect)
        assert got_all[0].shape == (len(pick), tile * tile)
        for i, c in enumerate(pick):
            want = [np.asarray(w) for w in jpipe._cube_samples(
                cfg, cam, jnp.asarray(c), tile, intersect)]
            one = tpipe._cube_samples(tcfg, tcam, t(c), tile, intersect)
            if intersect == "box":
                tol = np.full(want[0].shape, 1e-6)
            else:
                tol = _ball_tol(cam, c, want[1], cfg.cube_ball_radius())
            for got in (one, tuple(g[i] for g in got_all)):
                pix, d, pts, ts, s_mask = (n(g) for g in got)
                np.testing.assert_array_equal(pix, want[0])
                np.testing.assert_array_equal(s_mask, want[4])
                np.testing.assert_allclose(d, want[1], atol=1e-6)
                # outside the segments a ray that misses the slabs can
                # have t0 in the tens, where a one-ulp ray divides out to
                # several ulps; only the segments' samples are used
                lim = (tol[:, None] + 1e-6 * np.abs(want[3]))[s_mask]
                assert np.all(np.abs(ts - want[3])[s_mask] <= lim)
                assert np.all(np.abs(pts - want[2])[s_mask].max(-1)
                              <= lim + 1e-6 * np.abs(want[2])[s_mask].max(-1))
                assert s_mask.any() or i == len(pick) - 1
    # the wide tile really reaches past the 16 x 16 image
    assert jpipe.auto_tile(cfg, cams[0]) > cams[0].w


RT_CASES = [  # (field, chunk, intersect, order_mode)
    ("dense", 1, "box", "octant"),
    ("mixed", 1, "box", "octant"),
    ("mixed", 8, "box", "distance"),
    ("mixed", 8, "ball", "octant"),
    ("dense", 8, "ball", "distance"),
    ("mixed", 1, "ball", "distance"),
]


@pytest.mark.parametrize("kind,chunk,intersect,order_mode", RT_CASES)
def test_render_rtnerf_matches(scene, kind, chunk, intersect, order_mode):
    cfg, _, _, cubes, cams = scene
    jf = _fields(scene, kind)
    tf, tcubes = carry_field(jf, cfg), carry_cubes(cubes)
    for cam in cams:
        want_img, want = jpipe.render_rtnerf(
            jf, cfg, cubes, cam, order_mode=order_mode, chunk=chunk,
            intersect=intersect)
        got_img, got = tpipe.render_rtnerf(
            tf, torch_cfg(cfg), tcubes, carry_camera(cam),
            order_mode=order_mode, chunk=chunk, intersect=intersect)
        np.testing.assert_allclose(n(got_img), np.asarray(want_img),
                                   atol=IMG_TOL)
        assert sorted(got) == sorted(STAT_KEYS_RT)
        for k in STAT_KEYS_RT:
            assert got[k].dtype == torch.float32 and got[k].dim() == 0
            assert float(got[k]) == float(want[k]), k
        assert float(want["processed_samples"]) > 0
    # the image is not all background, and some rays terminate early
    assert float(np.asarray(want_img).min()) < 0.5


def test_render_rtnerf_scans_only_the_chunks_with_valid_cubes(scene):
    cfg, _, mixed, cubes, cams = scene
    tf, tcubes = carry_field(mixed, cfg), carry_cubes(cubes)
    for chunk in (1, 3, 8):
        _, processed, tile, steps, per_pix = tpipe.rtnerf_scan(
            tf, torch_cfg(cfg), tcubes, carry_camera(cams[0]), chunk=chunk,
            per_pixel=True)
        assert steps == min(math.ceil(cubes.count / chunk),
                            cfg.max_cubes // chunk)
        assert int(per_pix.sum()) == int(processed) > 0


@pytest.mark.parametrize("kind", ["dense", "mixed"])
@pytest.mark.parametrize("use_occupancy", [True, False])
def test_render_uniform_matches(scene, kind, use_occupancy):
    cfg, _, _, cubes, cams = scene
    jf = _fields(scene, kind)
    ro, rd = jrender.camera_rays(cams[1])
    want_img, want = jrender.render_uniform(jf, cfg, cubes, ro, rd,
                                            use_occupancy=use_occupancy)
    got_img, got = trender.render_uniform(
        carry_field(jf, cfg), torch_cfg(cfg), carry_cubes(cubes), t(ro),
        t(rd), use_occupancy=use_occupancy)
    np.testing.assert_allclose(n(got_img), np.asarray(want_img), atol=IMG_TOL)
    assert sorted(got) == sorted(STAT_KEYS_UNI)
    for k in STAT_KEYS_UNI:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        assert float(got[k]) == float(want[k]), k
    # occupancy skips samples, and early termination skips more
    assert float(want["processed_samples"]) < float(
        want["preexisting_samples"]) <= float(want["occ_accesses"])
    if use_occupancy:
        assert float(want["preexisting_samples"]) < float(
            want["occ_accesses"])


def test_render_uniform_in_passes_equals_one_pass(scene, monkeypatch):
    """37 rays a pass over 960 rays (not a multiple of 37): the same image
    and counts as one pass."""
    cfg, _, mixed, cubes, cams = scene
    tcfg = torch_cfg(cfg)
    tf, tcubes = carry_field(mixed, cfg), carry_cubes(cubes)
    ro, rd = trender.camera_rays(carry_camera(cams[1]))
    assert ro.shape[0] % 37 and ro.shape[0] * cfg.max_samples_per_ray <= \
        trender.UNIFORM_PASS_SAMPLES
    one_img, one = trender.render_uniform(tf, tcfg, tcubes, ro, rd)
    monkeypatch.setattr(trender, "UNIFORM_PASS_SAMPLES",
                        37 * cfg.max_samples_per_ray)
    calls = []
    real = trender.uniform_pass
    monkeypatch.setattr(trender, "uniform_pass",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    img, st = trender.render_uniform(tf, tcfg, tcubes, ro, rd)
    assert len(calls) == math.ceil(ro.shape[0] / 37)
    assert torch.equal(img, one_img)
    for k in STAT_KEYS_UNI:
        assert float(st[k]) == float(one[k]), k


@pytest.mark.parametrize("pipeline", ["rtnerf", "uniform"])
def test_eval_view_matches(scene, pipeline):
    cfg, _, mixed, cubes, cams = scene
    cam = cams[0]
    gt = np.asarray(jrays.render_gt(jrays.make_scene("lego"), cam))
    want_p, want, want_img = jtrain.eval_view(mixed, cfg, cubes, cam, gt,
                                              pipeline=pipeline, chunk=8)
    got_p, got, got_img = ttrain.eval_view(
        carry_field(mixed, cfg), torch_cfg(cfg), carry_cubes(cubes),
        carry_camera(cam), gt, pipeline=pipeline, chunk=8)
    assert isinstance(got_p, float) and abs(got_p - want_p) < 1e-3
    assert got == want
    np.testing.assert_allclose(n(got_img), np.asarray(want_img), atol=IMG_TOL)
    # a ground-truth tensor works too
    assert ttrain.eval_view(
        carry_field(mixed, cfg), torch_cfg(cfg), carry_cubes(cubes),
        carry_camera(cam), torch.from_numpy(gt.copy()), pipeline=pipeline,
        chunk=8)[0] == got_p


@pytest.mark.parametrize("kind", ["dense", "mixed", "encoded_default"])
def test_sparsity_report_equals_the_reference(scene, kind):
    cfg, dense, mixed, *_ = scene
    jf = {"dense": dense, "mixed": mixed,
          "encoded_default": dense.prune(sparsity=0.9).encode()}[kind]
    want = jf.sparsity_report()
    got = carry_field(jf, cfg).sparsity_report()
    assert got == want
    assert len(got) == 12


def test_eval_entry_points_refuse_a_mix_of_devices(scene):
    """The device comes from the tensor arguments; a mix raises (the meta
    device stands in for a second device here)."""
    cfg, _, mixed, cubes, cams = scene
    tcfg = torch_cfg(cfg)
    tf, tcubes = carry_field(mixed, cfg), carry_cubes(cubes)
    ro, rd = trender.camera_rays(carry_camera(cams[0]))
    with pytest.raises(ValueError, match="one device"):
        trender.render_uniform(tf, tcfg, tcubes, ro.to("meta"), rd)
    with pytest.raises(ValueError, match="one device"):
        trender.render_uniform(tf, tcfg, tcubes, ro.to("meta"),
                               rd.to("meta"), use_occupancy=False)
    meta_cam = trender.Camera(t(cams[0].c2w).to("meta"),
                              t(cams[0].origin).to("meta"), cams[0].focal,
                              cams[0].h, cams[0].w)
    with pytest.raises(ValueError, match="one device"):
        tpipe.render_rtnerf(tf, tcfg, tcubes, meta_cam)
    img = torch.zeros(cams[0].h * cams[0].w, 3)
    with pytest.raises(ValueError, match="one device"):
        ttrain.eval_view(tf, tcfg, tcubes, carry_camera(cams[0]),
                         img.to("meta"), pipeline="uniform")


def test_sqrt_rn_is_correctly_rounded():
    """The port's float32 root, which the camera, rays, ball intersection
    and ground truth use, is the correctly rounded one (numpy's float32
    sqrt, as XLA's and the card's), whatever PyTorch's vectorised CPU
    sqrt rounds to."""
    rng = np.random.RandomState(9)
    x = np.concatenate([rng.uniform(0, 10, 1 << 18),
                        rng.uniform(0, 1e-6, 1 << 14),
                        rng.uniform(0, 1e6, 1 << 14), [0.0, 1.0, 4.0]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(n(trender.sqrt_rn(t(x))), np.sqrt(x))
    v = rng.randn(1 << 14, 3).astype(np.float32)
    np.testing.assert_array_equal(n(trender.norm3(t(v))), np.asarray(
        jnp.linalg.norm(jnp.asarray(v), axis=-1)))
