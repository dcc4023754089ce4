"""The port's renderer stages against the reference: ordering, compaction,
occupancy and the ray renderer fed the reference's own CubeSet."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (carry_camera, carry_cubes, carry_field, jax_case,
                           n, t, torch_cfg)
from repro.configs.rtnerf import NeRFConfig as JaxConfig
from repro.configs.rtnerf import demo_config
from repro.core import occupancy as jocc
from repro.core import pipeline as jpipe
from repro.core import rendering as jrender
from repro.data import rays as jrays
from repro_torch.core import occupancy as tocc
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rendering as trender

ORIGINS = [(4.0, 0.3, 1.0), (-2.0, 3.0, -0.5), (0.1, -0.2, 5.0),
           (1e-7, 0.0, 0.0), (-3.0, -3.0, 3.0), (0.0, 4.0, 0.0)]


@pytest.fixture(scope="module")
def scene():
    """A pruned encoded tiny field and its reference CubeSet."""
    cfg, cf, *_ = jax_case(0.9, threshold=0.80)
    occ = jocc.build_occupancy(cf, cfg, sigma_thresh=0.01)
    return cfg, cf, jocc.extract_cubes(occ, cfg)


@pytest.mark.parametrize("origin", ORIGINS)
def test_octant_rank_and_ordering_key_match(origin):
    assert tpipe.octant_rank(origin) == jpipe.octant_rank(origin)
    for mode in ("octant", "trajectory", "distance"):
        assert tpipe.ordering_key(origin, mode) == \
            jpipe.ordering_key(origin, mode)
    assert tpipe.octant_rank(torch.tensor(origin)) == \
        jpipe.octant_rank(origin)


@pytest.mark.parametrize("mode", ["octant", "trajectory", "distance"])
def test_order_cubes_matches_exactly(scene, mode):
    cfg, _, cubes = scene
    tcubes = carry_cubes(cubes)
    for origin in ORIGINS:
        want = np.asarray(jpipe.order_cubes(cubes, jnp.asarray(origin,
                                                               jnp.float32),
                                            mode))
        np.testing.assert_array_equal(n(tpipe.order_cubes(tcubes, origin,
                                                          mode)), want)


def test_ordering_cache_counts_match(scene):
    cfg, _, cubes = scene
    path = [(4.0 * np.cos(a), 4.0 * np.sin(a), 1.0)
            for a in np.linspace(0, 2 * np.pi, 17)]
    for mode in ("octant", "trajectory"):
        jc = jpipe.OrderingCache(cubes, mode)
        tc = tpipe.OrderingCache(carry_cubes(cubes), mode)
        for o in path + path[:5]:
            np.testing.assert_array_equal(n(tc.get(o)), np.asarray(
                jc.get(np.asarray(o, np.float32))))
        assert tc.stats() == jc.stats()


@pytest.mark.parametrize("n_pairs,density,budget", [
    (64, 0.1, 16), (512, 0.5, 128), (4096, 0.02, 4096), (300, 0.0, 128),
    (300, 1.0, 100)])
def test_compact_select_matches_exactly(n_pairs, density, budget):
    hit = np.random.RandomState(n_pairs).rand(n_pairs) < density
    want = np.asarray(jpipe.compact_select(jnp.asarray(hit), budget))
    np.testing.assert_array_equal(
        n(tpipe.compact_select(torch.from_numpy(hit), budget)), want)
    np.testing.assert_array_equal(
        np.argsort(~hit, kind="stable")[:budget], want)


def test_build_occupancy_and_extract_cubes_match(scene):
    cfg, cf, _ = scene
    tcf = carry_field(cf, cfg)
    xs = jocc.grid_coords(cfg)
    pts = jnp.stack(jnp.meshgrid(xs, xs, xs, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    sig = np.sort(np.asarray(cf.sigma(pts)))
    # a threshold in the middle of a gap of the reference's sigma values,
    # so float rounding cannot flip a voxel
    lo = int(len(sig) * 0.6)
    gaps = np.diff(sig[lo:int(len(sig) * 0.95)])
    i = lo + int(np.argmax(gaps))
    thresh = float((sig[i] + sig[i + 1]) / 2)
    assert sig[i + 1] - sig[i] > 1e-5
    want = jocc.build_occupancy(cf, cfg, sigma_thresh=thresh, chunk=4096)
    got = tocc.build_occupancy(tcf, tcf.cfg, sigma_thresh=thresh, chunk=4096)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert 0 < int(np.asarray(want).sum()) < want.size
    jc = jocc.extract_cubes(want, cfg)
    tc = tocc.extract_cubes(got, tcf.cfg)
    assert tc.count == jc.count and tc.radius == jc.radius
    np.testing.assert_array_equal(n(tc.centers), np.asarray(jc.centers))
    np.testing.assert_array_equal(n(tc.valid), np.asarray(jc.valid))


@pytest.mark.parametrize("encoded,budget", [(True, None), (False, None),
                                            (True, 8)])
def test_ray_renderer_matches_reference(scene, encoded, budget):
    """make_ray_renderer on the reference CubeSet: images, depth and
    opacity at 1e-4; processed/dropped/active-pair counters exact."""
    cfg, cf, cubes = scene
    jf = cf if encoded else cf.decode()
    tf = carry_field(jf, cfg)
    tcubes = carry_cubes(cubes)
    cam = jrays.make_cameras(3, 16, 16)[0]
    perm = jpipe.order_cubes(cubes, cam.origin)
    ro, rd = jrender.camera_rays(cam)
    render = jax.jit(jpipe.make_ray_renderer(cfg, chunk=8,
                                             pair_budget=budget))
    want_rgb, want = render(jf, cubes.centers[perm], cubes.valid[perm],
                            ro, rd)
    tcam = carry_camera(cam)
    tperm = tpipe.order_cubes(tcubes, tcam.origin)
    tro, trd = trender.camera_rays(tcam)
    np.testing.assert_allclose(n(trd), np.asarray(rd), rtol=1e-6, atol=1e-6)
    got_rgb, got = tpipe.make_ray_renderer(torch_cfg(cfg), chunk=8,
                                           pair_budget=budget)(
        tf, tcubes.centers[tperm], tcubes.valid[tperm], t(ro), t(rd))
    np.testing.assert_allclose(n(got_rgb), np.asarray(want_rgb), atol=1e-4)
    for k in ("depth", "opacity", "t_final"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), atol=1e-4)
    for k in ("processed_samples", "dropped_pairs", "active_pairs_max"):
        assert n(got[k]).item() == np.asarray(want[k]).item(), k
    assert int(want["active_pairs_max"]) > 0
    if budget is not None:
        assert int(want["dropped_pairs"]) > 0


def test_samples_per_segment_and_step_match():
    cfg, *_ = jax_case(0.9, threshold=0.80)
    for c in (cfg, demo_config(False), JaxConfig()):
        tc = torch_cfg(c)
        assert tpipe.samples_per_segment(tc) == jpipe.samples_per_segment(c)
        assert trender.step_world(tc) == jrender.step_world(c)


@pytest.mark.parametrize("white_bg", [True, False])
def test_composite_and_psnr_match(white_bg):
    rng = np.random.RandomState(4)
    sigma = np.abs(rng.randn(16, 20)).astype(np.float32) * 5
    rgb = rng.rand(16, 20, 3).astype(np.float32)
    mask = rng.rand(16, 20) < 0.7
    want = jrender.composite(sigma, rgb, mask, 0.05, white_bg)
    got = trender.composite(t(sigma), t(rgb), t(mask), 0.05, white_bg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5, atol=1e-6)
    img, ref = rgb[..., 0], rgb[..., 1]
    assert abs(float(trender.psnr(t(img), t(ref)))
               - float(jrender.psnr(img, ref))) < 1e-4
