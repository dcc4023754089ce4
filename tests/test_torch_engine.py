"""The port's RenderEngine against the reference's on the same field, cubes
and cameras: images at 1e-4, deadline timeouts, and the adaptive
pair-budget resize sequence."""
import numpy as np
import pytest

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           jax_case, torch_cfg)
from repro.core import occupancy as jocc
from repro.data import rays as jrays
from repro.serving import RenderEngine as JaxEngine
from repro_torch.serving import RenderEngine


@pytest.fixture(scope="module")
def scene():
    cfg, cf, *_ = jax_case(0.9, threshold=0.80)
    occ = jocc.build_occupancy(cf, cfg, sigma_thresh=0.01)
    return cfg, cf, jocc.extract_cubes(occ, cfg)


def _engines(scene, **kw):
    cfg, cf, cubes = scene
    je = JaxEngine(cfg, cf, cubes, trace_requests=False, **kw)
    te = RenderEngine(torch_cfg(cfg), carry_field(cf, cfg),
                      carry_cubes(cubes), device=CPU, **kw)
    return je, te


def test_engine_images_match_reference(scene):
    je, te = _engines(scene, ray_chunk=16 * 16, max_batch_views=8)
    cams = jrays.make_cameras(4, 16, 16) + [jrays.make_cameras(3, 24, 24)[1]]
    gt = np.full((16 * 16, 3), 0.5, np.float32)
    jfuts = [je.submit(c, gt if i == 0 else None) for i, c in enumerate(cams)]
    tfuts = [te.submit(carry_camera(c), gt if i == 0 else None)
             for i, c in enumerate(cams)]
    assert not any(f.done() for f in tfuts)
    want = [f.result() for f in jfuts]
    got = [f.result() for f in tfuts]
    assert all(f.done() for f in tfuts)
    for w, g in zip(want, got):
        assert g.img.shape == w.img.shape
        np.testing.assert_allclose(g.img, w.img, atol=1e-4)
        np.testing.assert_allclose(g.depth, w.depth, atol=1e-4)
        np.testing.assert_allclose(g.opacity, w.opacity, atol=1e-4)
        assert g.stats["factor_bytes"] == w.stats["factor_bytes"]
        assert g.stats["occ_accesses"] == w.stats["occ_accesses"]
        assert g.stats["dispatch_path"] == "fused_ref"
    assert abs(got[0].psnr - want[0].psnr) < 1e-3
    js, ts = je.stats(), te.stats()
    for k in ("views_served", "flushes", "dropped_pairs", "timeouts",
              "pair_budget", "pair_budget_resizes", "pair_occupancy_last",
              "ray_chunk", "cube_chunk", "factor_bytes",
              "factor_bytes_dense", "compression_ratio", "field_kind",
              "occ_accesses_per_view"):
        assert ts[k] == js[k], k
    for k in ("hits", "misses", "entries"):
        assert ts["ordering_cache"][k] == js["ordering_cache"][k], k
    assert ts["fps"] > 0 and ts["latency_p99_s"] >= ts["latency_p50_s"] > 0


def test_engine_deadlines_match_reference(scene):
    je, te = _engines(scene, ray_chunk=16 * 16, max_batch_views=16)
    cams = jrays.make_cameras(3, 16, 16)
    deadlines = [-1.0, 600.0, None]
    jf = [je.submit(c, deadline_s=d) for c, d in zip(cams, deadlines)]
    tf = [te.submit(carry_camera(c), deadline_s=d)
          for c, d in zip(cams, deadlines)]
    je.flush()
    te.flush()
    for w, g in zip(jf, tf):
        w, g = w.result(), g.result()
        assert g.timed_out == w.timed_out
        assert (g.img is None) == (w.img is None)
        if g.img is not None:
            np.testing.assert_allclose(g.img, w.img, atol=1e-4)
    for k in ("timeouts", "views_served", "flushes"):
        assert te.stats()[k] == je.stats()[k], k
    # a flush of nothing but expired requests renders nothing
    je.submit(cams[0], deadline_s=-1.0)
    te.submit(carry_camera(cams[0]), deadline_s=-1.0)
    je.flush()
    te.flush()
    for k in ("timeouts", "views_served", "flushes"):
        assert te.stats()[k] == je.stats()[k], k
    # render_views: submit a batch and flush
    got = te.render_views([carry_camera(c) for c in cams[:2]])
    want = je.render_views(cams[:2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.img, w.img, atol=1e-4)


@pytest.mark.parametrize("start_budget", [16, 2048])
def test_adaptive_pair_budget_resizes_like_reference(scene, start_budget):
    """One view per flush: from a tiny budget it grows on dropped pairs;
    from the full pair count it shrinks after three low-occupancy
    flushes. The budget after every flush equals the reference's."""
    je, te = _engines(scene, ray_chunk=16 * 16, max_batch_views=1,
                      pair_budget=start_budget)
    cams = jrays.make_cameras(4, 16, 16)
    want, got = [], []
    for c in cams:
        je.submit(c).result()
        te.submit(carry_camera(c)).result()
        want.append((je.stats()["pair_budget"], je.stats()["dropped_pairs"]))
        got.append((te.stats()["pair_budget"], te.stats()["dropped_pairs"]))
    assert got == want
    assert te.stats()["pair_budget_resizes"] == \
        je.stats()["pair_budget_resizes"] > 0


def test_engine_builds_cubes_when_none_given(scene):
    """Without cubes the engine builds the occupancy itself, as the
    reference's store does, at cfg.occ_sigma_thresh."""
    cfg, cf, _ = scene
    te = RenderEngine(torch_cfg(cfg), carry_field(cf, cfg), device=CPU,
                      ray_chunk=256)
    want = jocc.extract_cubes(jocc.build_occupancy(cf, cfg), cfg)
    assert te.cubes.count == want.count
    np.testing.assert_array_equal(te.cubes.centers.numpy(),
                                  np.asarray(want.centers))
    assert te.stats()["dispatch_path"] == "fused_ref"
    dense = RenderEngine(torch_cfg(cfg), carry_field(cf, cfg),
                         carry_cubes(scene[2]), encode=False, device=CPU)
    assert dense.stats()["field_kind"] == "dense"
    assert dense.stats()["compression_ratio"] == 1.0
