"""The port's scenes, ground-truth renderer, cameras and ray batches
(`repro_torch.data.rays`) against the reference's on the CPU.

Ground truth is held to a tie rule: the hit masks are equal except at
pixels whose final SDF distance lies within 1e-5 of the 5e-3 hit
threshold on either side (at most 0.1% of the pixels), and the colours
agree within 1e-4 on every other pixel. The reference's ficus draws its
primitives from a seed that Python salts per process, so its arrays are
carried over to the port's Scene."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carry_camera, carry_scene, n, t
from repro.core import rendering as jrender
from repro.data import rays as jrays
from repro_torch.data import rays as trays

REPO = Path(__file__).resolve().parent.parent
DETERMINISTIC = tuple(s for s in jrays.SCENES if s != "ficus")
GT_TOL = 1e-4
TIE = 1e-5


def _jax_trace(scene, cam, n_steps=64):
    """The reference render_gt's march, for its final t and SDF."""
    o, d = jrender.camera_rays(cam)

    def step(tt, _):
        dist, _ = jrays.scene_sdf(scene, o + d * tt[:, None])
        return tt + jnp.clip(dist, -0.05, 0.3), None

    tt, _ = jax.lax.scan(step, jnp.full((o.shape[0],), 1.0), None,
                         length=n_steps)
    dist, _ = jrays.scene_sdf(scene, o + d * tt[:, None])
    return np.asarray(tt), np.asarray(dist)


def _port_trace(scene, cam):
    _, tt, dist = trays.trace_gt(scene, cam)
    return n(tt), n(dist)


def assert_gt_close(got, want, got_trace, want_trace):
    """The tie rule on two ground-truth images (H*W, 3) with each side's
    (final t, final SDF)."""
    (gt_t, gt_d), (wt_t, wt_d) = got_trace, want_trace
    hit_g = (gt_d < trays.HIT_DIST) & (gt_t < trays.HIT_T_MAX)
    hit_w = (wt_d < trays.HIT_DIST) & (wt_t < trays.HIT_T_MAX)
    tie = ((np.abs(gt_d - trays.HIT_DIST) <= TIE)
           | (np.abs(wt_d - trays.HIT_DIST) <= TIE))
    differ = hit_g != hit_w
    assert not (differ & ~tie).any(), np.flatnonzero(differ & ~tie)
    assert differ.sum() <= 1e-3 * differ.size
    np.testing.assert_allclose(got[~differ], want[~differ], atol=GT_TOL)
    return int(hit_w.sum())


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_deterministic_scenes_are_equal(name):
    want, got = jrays.make_scene(name), trays.make_scene(name)
    assert got.name == want.name
    for k in ("prim_type", "center", "size", "color"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert trays.SCENES == jrays.SCENES


def _ficus_in_subprocess(hash_seed: str, package: str) -> str:
    code = (f"from {package}.data import rays\n"
            "s = rays.make_scene('ficus')\n"
            "print(s.center.tobytes().hex() + s.color.tobytes().hex())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTHONHASHSEED=hash_seed, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return res.stdout.strip()


def test_port_ficus_is_the_same_in_every_process():
    a = _ficus_in_subprocess("1", "repro_torch")
    b = _ficus_in_subprocess("2", "repro_torch")
    s = trays.make_scene("ficus")
    assert a == b == s.center.tobytes().hex() + s.color.tobytes().hex()
    assert s.center.shape == (10, 3)


def test_reference_ficus_depends_on_the_hash_seed():
    """The reason the port seeds ficus with a stable hash: the
    reference's `abs(hash(name))` seed is salted per process."""
    assert _ficus_in_subprocess("1", "repro") != \
        _ficus_in_subprocess("2", "repro")


@pytest.mark.parametrize("name", jrays.SCENES)
def test_scene_sdf_matches(name):
    js = jrays.make_scene(name)
    ts = carry_scene(js)
    rng = np.random.RandomState(len(name))
    p = rng.uniform(-1.6, 1.6, (5000, 3)).astype(np.float32)
    want_d, want_c = jrays.scene_sdf(js, jnp.asarray(p))
    got_d, got_c = trays.scene_sdf(ts, t(p))
    np.testing.assert_allclose(n(got_d), np.asarray(want_d), atol=1e-6)
    np.testing.assert_array_equal(n(got_c), np.asarray(want_c))
    assert (np.asarray(want_d) < 0).any() and (np.asarray(want_d) > 0).any()


@pytest.mark.parametrize("name", jrays.SCENES)
def test_render_gt_matches_under_the_tie_rule(name):
    js = jrays.make_scene(name)
    ts = carry_scene(js)
    cam = jrays.make_cameras(3, 32, 32)[1]
    tcam = carry_camera(cam)
    want = np.asarray(jrays.render_gt(js, cam))
    got = n(trays.render_gt(ts, tcam))
    hits = assert_gt_close(got, want, _port_trace(ts, tcam),
                           _jax_trace(js, cam))
    assert 0 < hits < got.shape[0]


def test_make_cameras_match():
    for nv, h, w in ((3, 16, 16), (5, 24, 40), (8, 800, 800)):
        want = jrays.make_cameras(nv, h, w)
        got = trays.make_cameras(nv, h, w, device="cpu")
        assert len(got) == nv
        for g, wc in zip(got, want):
            assert (g.focal, g.h, g.w) == (wc.focal, wc.h, wc.w)
            np.testing.assert_allclose(n(g.c2w), np.asarray(wc.c2w),
                                       atol=1e-6)
            np.testing.assert_allclose(n(g.origin), np.asarray(wc.origin),
                                       atol=1e-6)
    got = trays.make_cameras(2, 8, 8, radius=3.0, elevation=-0.2,
                             device="cpu")[1]
    want = jrays.make_cameras(2, 8, 8, radius=3.0, elevation=-0.2)[1]
    np.testing.assert_allclose(n(got.c2w), np.asarray(want.c2w), atol=1e-6)


def test_ray_batches_draw_the_same_rays():
    rng = np.random.RandomState(7)
    arrays = [rng.rand(500, 3).astype(np.float32) for _ in range(3)]
    want = jrays.RayDataset(*arrays).batches(64, seed=3)
    got = trays.RayDataset(*arrays, device="cpu").batches(64, seed=3)
    for _ in range(3):
        for g, w in zip(next(got), next(want)):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_array_equal(n(g), np.asarray(w))


def test_build_dataset_matches():
    js = jrays.make_scene("drums")
    want = jrays.build_dataset(js, 2, 16, 16)
    got = trays.build_dataset(carry_scene(js), 2, 16, 16, device="cpu")
    assert got.device == torch.device("cpu")
    np.testing.assert_allclose(got.rays_o, want.rays_o, atol=1e-6)
    np.testing.assert_allclose(got.rays_d, want.rays_d, atol=1e-6)
    cams = jrays.make_cameras(2, 16, 16)
    per = 16 * 16
    for i, cam in enumerate(cams):
        sl = slice(i * per, (i + 1) * per)
        tcam = carry_camera(cam)
        assert_gt_close(got.rgb[sl], want.rgb[sl],
                        _port_trace(carry_scene(js), tcam),
                        _jax_trace(js, cam))
