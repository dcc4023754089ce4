"""The port's temporal tier (`repro_torch.serving.temporal`) and the
engine's `submit_delta` against the reference's: the reference's `prev`
arrays warped by both packages give an exactly equal frame, mask and
delta plan; the warp's behaviour (mirrors tests/test_temporal.py); the
trajectory-mode ordering cache; and `submit_delta` end to end (keyframe
bitwise `submit`'s image, delta frame >= 35 dB against a full render,
tests/test_temporal.py's bound)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           numpy_params, tiny_cfg, torch_cfg)
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.core import pipeline as jpipe
from repro.core import rendering as jrender
from repro.obs import MetricsRegistry as JaxRegistry
from repro.serving import RenderEngine as JaxEngine
from repro.serving import temporal as jtemporal
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rendering as trender
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import RenderEngine, ViewResult
from repro_torch.serving import temporal

CFG = tiny_cfg()
TCFG = torch_cfg(CFG)


@pytest.fixture(scope="module")
def scene():
    params = {k: jnp.asarray(v) for k, v in numpy_params(CFG, 0).items()}
    field = jfield.DenseField(params, CFG).prune(sparsity=0.9)
    cubes = jocc.extract_cubes(jocc.build_occupancy(field, CFG,
                                                    sigma_thresh=0.01), CFG)
    assert cubes.count > 0
    return field, cubes


def _cam(origin, target=(0, 0, 0), hw=16):
    return trender.look_at_camera(origin, target, 1.2 * hw, hw, hw,
                                  device=CPU)


def _jcam(origin, target=(0, 0, 0), hw=16):
    return jrender.look_at_camera(origin, target, 1.2 * hw, hw, hw)


def _orbit(a, r=4.0, z=1.0):
    return [r * np.cos(a), r * np.sin(a), z]


def _smooth_frame(h, w, depth0=3.0, seed=0):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(h * w, 3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = (depth0 + 0.01 * (xx + yy)).reshape(-1).astype(np.float64)
    return rgb, depth


def _assert_warp_equal(got, want):
    for k in ("rgb", "depth", "opacity", "confidence"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert (got.h, got.w) == (want.h, want.w)
    assert got.warp_fraction == want.warp_fraction


def _assert_plan_equal(got, want):
    np.testing.assert_array_equal(got.idx, want.idx)
    assert got.n_real == want.n_real and got.n_rays == want.n_rays
    assert got.warp_fraction == want.warp_fraction


# -- exact parity on the reference's frames -------------------------------------


def test_warp_and_plan_equal_reference_on_a_rendered_frame(scene):
    """The reference engine's rendered frame (img, depth, opacity) warped
    along an orbit step by both packages: equal arrays, equal plans."""
    eng = JaxEngine(CFG, *scene, ray_chunk=64, trace_requests=False)
    prev = eng.submit(_jcam(_orbit(0.0))).result()
    for a in (0.05, 0.3):
        for opacity in (prev.opacity, None):
            want = jtemporal.warp_radiance(prev.img, prev.cam,
                                           _jcam(_orbit(a)), prev.depth,
                                           opacity=opacity)
            got = temporal.warp_radiance(prev.img, carry_camera(prev.cam),
                                         _cam(_orbit(a)), prev.depth,
                                         opacity=opacity)
            _assert_warp_equal(got, want)
            for bucket in (1, 32, 100):
                _assert_plan_equal(temporal.plan_delta(got, bucket=bucket),
                                   jtemporal.plan_delta(want, bucket=bucket))


@pytest.mark.parametrize("case", ["identity", "translate", "edge",
                                  "background", "away"])
def test_warp_equals_reference_on_synthetic_frames(case):
    rgb, depth = _smooth_frame(16, 16)
    kw = {}
    o0, o1, tgt1 = _orbit(0.0), _orbit(0.0), (0, 0, 0)
    if case == "translate":
        o1 = [3.6, 1.2, 1.0]
    elif case == "edge":
        d = np.full((16, 16), 2.0)
        d[:, 8:] = 4.0
        depth = d.reshape(-1)
    elif case == "background":
        op = np.ones(256)
        op[:64] = 0.0
        depth, kw = depth * op, {"opacity": op}
    elif case == "away":
        tgt1 = (4.0, 0.0, 100.0)
    want = jtemporal.warp_radiance(rgb, _jcam(o0), _jcam(o1, tgt1), depth,
                                   **kw)
    got = temporal.warp_radiance(rgb, _cam(o0), _cam(o1, tgt1), depth, **kw)
    _assert_warp_equal(got, want)
    _assert_plan_equal(temporal.plan_delta(got, bucket=16),
                       jtemporal.plan_delta(want, bucket=16))


# -- the warp's behaviour (mirrors tests/test_temporal.py) -------------------------


def test_warp_identity_reproduces_frame():
    cam = _cam(_orbit(0.0))
    rgb, depth = _smooth_frame(16, 16)
    wr = temporal.warp_radiance(rgb, cam, cam, depth)
    assert wr.confidence.all() and wr.warp_fraction == 1.0
    np.testing.assert_allclose(wr.rgb, rgb, atol=1e-9)
    np.testing.assert_allclose(wr.depth, depth, rtol=1e-6)
    np.testing.assert_allclose(wr.opacity, 1.0)


def test_warp_translation_flags_disocclusions():
    rgb, depth = _smooth_frame(16, 16)
    wr = temporal.warp_radiance(rgb, _cam(_orbit(0.0)), _cam([3.6, 1.2, 1.0]),
                                depth)
    assert 0.0 < wr.warp_fraction < 1.0
    warped = wr.rgb[np.any(wr.rgb != 1.0, axis=-1)]
    src = {tuple(np.round(p, 12)) for p in rgb}
    assert all(tuple(np.round(p, 12)) in src for p in warped)


def test_warp_depth_edges_masked():
    cam = _cam(_orbit(0.0))
    rgb = np.random.RandomState(1).rand(256, 3)
    depth = np.full((16, 16), 2.0)
    depth[:, 8:] = 4.0
    conf = temporal.warp_radiance(rgb, cam, cam,
                                  depth.reshape(-1)).confidence.reshape(16, 16)
    assert not conf[:, 6:10].any()
    assert conf[:, :5].all() and conf[:, 11:].all()


def test_warp_offscreen_everything_low_confidence():
    rgb, depth = _smooth_frame(16, 16)
    wr = temporal.warp_radiance(rgb, _cam(_orbit(0.0)),
                                _cam(_orbit(0.0), (4.0, 0.0, 100.0)), depth)
    assert wr.warp_fraction == 0.0 and not wr.confidence.any()
    assert np.mean(wr.rgb == 1.0) > 0.95


def test_plan_delta_buckets_and_pads():
    conf = np.ones(64, bool)
    conf[[3, 10, 11, 40, 63]] = False
    wr = temporal.WarpResult(rgb=np.ones((64, 3)), depth=np.zeros(64),
                             opacity=np.ones(64), confidence=conf, h=8, w=8)
    plan = temporal.plan_delta(wr, bucket=16)
    assert plan.n_real == 5 and plan.n_rays == 16
    np.testing.assert_array_equal(plan.idx[:5], [3, 10, 11, 40, 63])
    assert (plan.idx[5:] == 0).all()
    assert plan.warp_fraction == pytest.approx(1.0 - 5 / 64)
    wr.confidence[:] = True
    assert temporal.plan_delta(wr, bucket=16).n_rays == 16
    with pytest.raises(ValueError):
        temporal.plan_delta(wr, bucket=0)


def test_warp_takes_cameras_on_any_device():
    """Cameras holding tensors (the engine's) or numpy arrays warp alike."""
    rgb, depth = _smooth_frame(16, 16)
    c0, c1 = _cam(_orbit(0.0)), _cam(_orbit(0.1))
    np_cam = trender.Camera(c1.c2w.numpy(), c1.origin.numpy(), c1.focal,
                            c1.h, c1.w)
    _assert_warp_equal(temporal.warp_radiance(rgb, c0, np_cam, depth),
                       temporal.warp_radiance(rgb, c0, c1, depth))


# -- compaction and the trajectory-mode ordering cache --------------------------


def test_compact_select_matches_numpy_stable_oracle():
    rng = np.random.RandomState(3)
    for _ in range(2):
        hit = rng.rand(40) < 0.3
        got = tpipe.compact_select(torch.from_numpy(hit), 7).numpy()
        np.testing.assert_array_equal(got, np.argsort(~hit,
                                                      kind="stable")[:7])


def test_ordering_cache_trajectory_matches_reference(scene):
    """Quantised-pose keys: exact hit, NN hit, miss; the counters in
    stats() and in the scene-labelled registry counters, and with_cubes /
    invalidate, step for step as the reference's."""
    _, cubes = scene
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jc = jpipe.OrderingCache(cubes, mode="trajectory", scene="s",
                             registry=jreg)
    tc = tpipe.OrderingCache(carry_cubes(cubes), mode="trajectory",
                             scene="s", registry=treg)
    o0 = np.array([4.0, 0.0, 1.0])
    probes = [o0, o0 + 0.01, o0 + np.array([0.3, 0.0, 0.0]),
              np.array([-4.0, -4.0, -4.0])]
    for o in probes:
        np.testing.assert_array_equal(tc.get(o).numpy(), np.asarray(
            jc.get(o)))
        assert tc.stats() == jc.stats()
    assert tc.stats() == {"hits": 2, "misses": 2, "nn_hits": 1,
                          "entries": 2}
    jc2, tc2 = jc.with_cubes(cubes), tc.with_cubes(tc.cubes)
    assert tc2.stats() == jc2.stats() and tc2.stats()["entries"] == 0
    jc2.get(o0)
    tc2.get(o0)
    assert tc2.stats() == jc2.stats()
    for name in ("ordering_cache_hits", "ordering_cache_misses"):
        assert treg.counter(name, scene="s").value == \
            jreg.counter(name, scene="s").value
    tc2.invalidate()
    assert tc2.stats()["entries"] == 0 and tc2.stats()["misses"] == 3
    tc2.invalidate(carry_cubes(cubes))
    tc2.get(o0)
    assert tc2.stats()["misses"] == 4


def test_ordering_cache_nn_deterministic_tie_break(scene):
    cubes = carry_cubes(scene[1])
    a = tpipe.OrderingCache(cubes, mode="trajectory", pose_quantum=1.0)
    b = tpipe.OrderingCache(cubes, mode="trajectory", pose_quantum=1.0)
    lo, hi = np.array([3.0, 0.0, 0.0]), np.array([5.0, 0.0, 0.0])
    a.get(lo), a.get(hi)
    b.get(hi), b.get(lo)
    probe = np.array([4.0, 0.0, 0.0])
    assert a._nearest(a.key_for(probe)) == b._nearest(b.key_for(probe)) \
        == (3, 0, 0)


# -- submit_delta end to end ---------------------------------------------------------


def test_engine_submit_delta_end_to_end(scene):
    """Keyframes (prev=None) are bitwise `submit`'s image; a delta frame
    composites warped + fresh rays within 35 dB of the full render, with
    telemetry on the shared registry and warp/mask/composite in the
    stage breakdown; an unmeetable max_delta_frac falls back to a full
    render."""
    eng = RenderEngine(TCFG, carry_field(scene[0], CFG),
                       carry_cubes(scene[1]), ray_chunk=64,
                       delta_ray_bucket=32, order_mode="trajectory",
                       adaptive_pair_budget=False, device=CPU)
    cams = [_cam(_orbit(a)) for a in (0.0, 0.05, 0.10)]
    ref0 = eng.submit(cams[0]).result()
    key0 = eng.submit_delta(cams[0], prev=None).result()
    np.testing.assert_array_equal(key0.img, ref0.img)
    assert key0.depth is not None and key0.opacity is not None
    assert key0.warp_fraction == 0.0 and key0.cam is cams[0]

    d1 = eng.submit_delta(cams[1], prev=key0).result()
    assert 0.0 < d1.warp_fraction < 1.0
    full1 = eng.submit(cams[1]).result()
    psnr = float(trender.psnr(torch.from_numpy(d1.img).clamp(0, 1),
                              torch.from_numpy(full1.img).clamp(0, 1)))
    assert psnr >= 35.0, psnr

    d2 = eng.submit_delta(cams[2], prev=d1).result()
    assert np.isfinite(d2.depth).all() and 0.0 < d2.warp_fraction <= 1.0

    s = eng.stats()["delta"]
    assert s["views"] == 2 and s["fresh_rays"] > 0 and s["warped_rays"] > 0
    m = eng.metrics
    assert m.counter("warp_rays_total").value == s["warped_rays"]
    assert m.counter("render_dispatch_total", path="delta").value == 2
    assert m.histogram("warp_fraction").snapshot()["count"] == 2
    stages = eng.stage_breakdown()
    for st in ("warp", "mask", "render", "composite"):
        assert st in stages, st

    fb = eng.submit_delta(cams[0], prev=d2, max_delta_frac=-1.0).result()
    np.testing.assert_array_equal(fb.img, ref0.img)
    assert fb.warp_fraction == 0.0
    assert eng.stats()["delta"]["full_fallbacks"] == 1
    eng.close()


def test_submit_delta_matches_reference_from_the_same_prev(scene):
    """Both engines warp the reference's keyframe to the next pose: equal
    warped pixels and warp fraction (the same mask), fresh pixels equal to
    each engine's own full render of the new pose, and the two frames
    within 1e-4."""
    kw = dict(ray_chunk=64, delta_ray_bucket=32, order_mode="trajectory",
              adaptive_pair_budget=False)
    je = JaxEngine(CFG, *scene, **kw)
    te = RenderEngine(TCFG, carry_field(scene[0], CFG),
                      carry_cubes(scene[1]), device=CPU, **kw)
    jkey = je.submit_delta(_jcam(_orbit(0.0)), prev=None).result()
    # the port renders the keyframe too, so both ordering caches hold the
    # same schedule (trajectory mode serves the next pose from it)
    own = te.submit_delta(_cam(_orbit(0.0)), prev=None).result()
    np.testing.assert_allclose(own.img, jkey.img, atol=1e-4)
    tkey = ViewResult(view_id=-1, img=jkey.img, psnr=None, latency_s=0.0,
                      stats={}, depth=jkey.depth, opacity=jkey.opacity,
                      cam=carry_camera(jkey.cam))
    jcam, tcam = _jcam(_orbit(0.05)), _cam(_orbit(0.05))
    want = je.submit_delta(jcam, prev=jkey).result()
    got = te.submit_delta(tcam, prev=tkey).result()
    assert got.warp_fraction == want.warp_fraction
    assert 0.0 < got.warp_fraction < 1.0
    plan = jtemporal.plan_delta(
        jtemporal.warp_radiance(jkey.img, jkey.cam, jcam, jkey.depth,
                                opacity=jkey.opacity), bucket=32)
    fresh = np.zeros(got.img.shape[0], bool)
    fresh[plan.idx] = True
    np.testing.assert_array_equal(got.img[~fresh], want.img[~fresh])
    np.testing.assert_array_equal(got.depth[~fresh], want.depth[~fresh])
    np.testing.assert_allclose(got.img, want.img, atol=1e-4)
    np.testing.assert_allclose(got.depth, want.depth, atol=1e-4)
    full_t, full_j = te.submit(tcam).result(), je.submit(jcam).result()
    np.testing.assert_array_equal(got.img[fresh], full_t.img[fresh])
    np.testing.assert_array_equal(want.img[fresh], full_j.img[fresh])
    js, ts = je.stats()["delta"], te.stats()["delta"]
    for k in ("views", "fresh_rays", "warped_rays", "full_fallbacks"):
        assert ts[k] == js[k], k
