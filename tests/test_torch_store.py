"""The port's SceneStore and multi-scene RenderEngine against the
reference's: one sequence of register, publish, evict, revive, pin and
priority gives the same victims, resident scenes, bytes and counters;
revived scenes serve bit for bit; a two-scene flush renders each scene's
image; swap_field; the stats key sets. Mirrors tests/test_store.py (the
fine-tune tests aside: training is not ported)."""
import gc
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           numpy_params, tiny_cfg, torch_cfg)
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.core import pipeline as jpipe
from repro.data import rays as jrays
from repro.serving import RenderEngine as JaxEngine
from repro.serving import SceneStore as JaxStore
from repro_torch.core import field as tfield
from repro_torch.serving import RenderEngine, SceneStore
from repro_torch.serving import store as tstore

CFG = tiny_cfg()
TCFG = torch_cfg(CFG)
JOIN_S = 60.0          # every thread a test starts is joined within this


def _jax_scene(seed=0, target=0.9):
    """A pruned dense field made from a numpy seed and its cube set, as the
    reference's objects."""
    params = {k: jnp.asarray(v) for k, v in numpy_params(CFG, seed).items()}
    field = jfield.DenseField(params, CFG).prune(sparsity=target)
    cubes = jocc.extract_cubes(jocc.build_occupancy(field, CFG,
                                                    sigma_thresh=0.01), CFG)
    assert cubes.count > 0
    return field, cubes


@pytest.fixture(scope="module")
def scenes():
    return {s: _jax_scene(seed=s) for s in (0, 1, 2, 7)}


def _port(scene):
    field, cubes = scene
    return carry_field(field, CFG), carry_cubes(cubes)


def _stream(field, key):
    """The values tensor of a factor's first mode slice."""
    ef = field.factors[key][0]
    return {"dense": lambda: ef.dense, "bitmap": lambda: ef.bitmap.values,
            "coo": lambda: ef.coo.values}[ef.fmt]()


def _one_bytes(scene):
    return jfield.as_backend(scene[0], CFG).encode().factor_bytes()


def _stores(tmp_path, budget=None, **kw):
    js = JaxStore(CFG, max_resident_bytes=budget,
                  spill_dir=str(tmp_path / "jspill"), **kw)
    ts = SceneStore(TCFG, max_resident_bytes=budget, device=CPU,
                    spill_dir=str(tmp_path / "tspill"), **kw)
    return js, ts


LATENCY_KEYS = ("latency_p50_s", "latency_p95_s", "latency_p99_s", "fps",
                "render_s", "swap_latency_s_last", "swap_latency_s_max")


def _counters(stats):
    """A store's stats without the latencies (they differ by machine)."""
    out = dict(stats)
    if "scenes" in out:
        out["scenes"] = {n: _counters(s) for n, s in out["scenes"].items()}
    for k in LATENCY_KEYS:
        out.pop(k, None)
    return out


def _assert_same(js, ts):
    assert ts.resident_scenes() == js.resident_scenes()
    assert ts.resident_bytes() == js.resident_bytes()
    assert _counters(ts.stats()) == _counters(js.stats())


# -- the store, step for step against the reference ---------------------------


def test_store_sequence_matches_reference(tmp_path, scenes):
    js, ts = _stores(tmp_path, budget=int(2.5 * _one_bytes(scenes[0])))
    ops = [
        ("register", "a", 0), ("register", "b", 1), ("snapshot", "a"),
        ("register", "c", 2),              # over budget: evicts b
        ("snapshot", "b"),                 # revives b, evicts a (LRU)
        ("pin", "c"), ("snapshot", "a"),   # c pinned: b goes
        ("pin", "c", False), ("priority", "a", 5),
        ("snapshot", "b"),                 # lowest priority, LRU: c goes
        ("publish", "c", 7),               # into an evicted scene
        ("evict", "a"), ("evict", "a"),    # the second is a no-op
        ("update_cubes", "b", 2), ("get_field", "a"),
        ("note_served", "b"),
    ]
    for op in ops:
        name = op[1]
        for store, port in ((js, False), (ts, True)):
            if op[0] in ("register", "publish", "update_cubes"):
                f, c = scenes[op[2]]
                if port:
                    f, c = _port((f, c))
                if op[0] == "register":
                    store.register(name, f, c)
                elif op[0] == "publish":
                    store.publish(name, f, c)
                else:
                    store.update_cubes(name, c)
            elif op[0] == "pin":
                store.pin(name, *op[2:])
            elif op[0] == "priority":
                store.set_priority(name, op[2])
            elif op[0] == "note_served":
                store.note_served(name, [0.1, 0.2], 0.3)
            else:
                getattr(store, op[0])(name)
        _assert_same(js, ts)
    for name in ("a", "b", "c"):
        assert _counters(ts.stats(name)) == _counters(js.stats(name))
        assert set(ts.stats(name)) == set(js.stats(name))
    assert ts.evictions_total == js.evictions_total >= 4
    assert ts.revivals_total == js.revivals_total >= 3


def test_store_register_and_duplicate_rejected(tmp_path, scenes):
    _, store = _stores(tmp_path)
    f, c = _port(scenes[0])
    store.register("a", f, c)
    assert "a" in store and store.resident_scenes() == ["a"]
    assert store.resident_bytes() > 0
    with pytest.raises(ValueError, match="already registered"):
        store.register("a", f, c)
    with pytest.raises(KeyError, match="unknown scene"):
        store.snapshot("nope")


def test_store_snapshot_is_consistent_after_publish(tmp_path, scenes):
    _, store = _stores(tmp_path)
    f1, c1 = _port(scenes[0])
    f2, c2 = _port(scenes[7])
    store.register("a", f1, c1)
    snap = store.snapshot("a")
    store.publish("a", f2, c2)
    assert snap.cubes is c1
    assert store.snapshot("a").cubes is not c1
    assert store.stats("a")["swaps"] == 1


def test_store_eviction_roundtrip_bit_for_bit(tmp_path, scenes):
    """Evict -> revive rebuilds the exact encoded representation and the
    same cube set; the evicted record holds no tensor of the scene."""
    _, store = _stores(tmp_path)
    f, c = _port(scenes[0])
    store.register("a", f, c)
    before = store.get_field("a")
    spec_b, arrays_b = tfield.field_state(before)
    # copies: a CPU tensor's .numpy() keeps the tensor alive
    arrays_b = {k: v.copy() for k, v in arrays_b.items()}
    watch = [weakref.ref(_stream(before, k)) for k in before.factors]
    watch.append(weakref.ref(before.extras["basis"]))
    del before, f                  # f's dense tensors are the extras
    snap_cubes = store.snapshot("a").cubes
    store.evict("a")
    assert store.resident_scenes() == []
    assert store.stats("a")["field_kind"] == "evicted"
    rec = store._records["a"]
    assert rec.field is None and rec.cubes is None and rec.ordering is None
    gc.collect()
    assert all(w() is None for w in watch), \
        "an evicted scene's tensors are still referenced"

    after = store.get_field("a")               # transparent revival
    spec_a, arrays_a = tfield.field_state(after)
    assert spec_a == spec_b
    assert sorted(arrays_a) == sorted(arrays_b)
    for k in arrays_b:
        np.testing.assert_array_equal(arrays_a[k], arrays_b[k])
    c2 = store.snapshot("a").cubes
    for k in ("centers", "valid", "occ"):
        assert torch.equal(getattr(c2, k), getattr(snap_cubes, k))
    assert (c2.count, c2.radius) == (c.count, c.radius)
    s = store.stats("a")
    assert s["evictions"] == 1 and s["revivals"] == 1


def test_cubes_file_is_the_references(tmp_path, scenes):
    f, c = scenes[0]
    d = tmp_path / "c"
    d.mkdir()
    tstore.save_cubes(str(d), carry_cubes(c))
    from repro.serving import store as jstore
    back = jstore.load_cubes(str(d))
    np.testing.assert_array_equal(np.asarray(back.centers),
                                  np.asarray(c.centers))
    np.testing.assert_array_equal(np.asarray(back.occ), np.asarray(c.occ))
    assert (back.count, back.radius) == (c.count, c.radius)
    jstore.save_cubes(str(d), c)
    got = tstore.load_cubes(str(d), device=CPU)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(c.valid))
    assert (got.count, got.radius) == (c.count, c.radius)


def test_store_budget_lru_evicts_coldest(tmp_path, scenes):
    _, store = _stores(tmp_path, budget=int(2.5 * _one_bytes(scenes[0])))
    for name, s in (("a", 0), ("b", 1)):
        store.register(name, *_port(scenes[s]))
    assert store.resident_scenes() == ["a", "b"]
    store.snapshot("a")                        # a is now warmer than b
    store.register("c", *_port(scenes[2]))     # over budget -> evict b
    assert set(store.resident_scenes()) == {"a", "c"}
    store.snapshot("b")                        # revive b, evict a
    assert "b" in store.resident_scenes()
    assert "a" not in store.resident_scenes()


def test_store_single_scene_over_budget_stays_resident(tmp_path, scenes):
    _, store = _stores(tmp_path, budget=1)
    store.register("a", *_port(scenes[0]))
    assert store.resident_scenes() == ["a"]


def test_store_pin_blocks_budget_eviction(tmp_path, scenes):
    _, store = _stores(tmp_path, budget=int(2.5 * _one_bytes(scenes[0])))
    store.register("a", *_port(scenes[0]))
    store.register("b", *_port(scenes[1]))
    store.pin("a")
    store.register("c", *_port(scenes[2]))
    assert "a" in store.resident_scenes()
    assert "b" not in store.resident_scenes()
    assert store.stats("a")["pinned"]
    store.pin("a", False)
    store.snapshot("c")
    store.snapshot("b")
    assert "a" not in store.resident_scenes()


def test_store_priority_orders_budget_victims(tmp_path, scenes):
    _, store = _stores(tmp_path, budget=int(2.5 * _one_bytes(scenes[0])))
    store.register("a", *_port(scenes[0]))
    store.register("b", *_port(scenes[1]))
    store.set_priority("b", 5)
    store.snapshot("a")
    store.register("c", *_port(scenes[2]))
    assert "a" not in store.resident_scenes()
    assert "b" in store.resident_scenes()
    assert store.stats("b")["priority"] == 5


# -- ordering-cache counters -----------------------------------------------------


@pytest.mark.parametrize("rebuild", ["update_cubes", "evict"])
def test_ordering_counters_survive_like_reference(tmp_path, scenes, rebuild):
    """update_cubes rebuilds the ordering cache via with_cubes, eviction
    parks its counters; both keep counting forward as the reference's."""
    js, ts = _stores(tmp_path, order_mode="trajectory")
    o0 = np.array([4.0, 0.0, 1.0])
    probes = [o0, o0, o0 + np.array([0.3, 0.0, 0.0])]
    for store, port in ((js, False), (ts, True)):
        f, c = _port(scenes[0]) if port else scenes[0]
        store.register("a", f, c)
        oc = store.snapshot("a").ordering
        for o in probes:
            oc.get(o)
        if rebuild == "update_cubes":
            c2 = _port(scenes[1])[1] if port else scenes[1][1]
            store.update_cubes("a", c2)
            assert store.snapshot("a").ordering.cubes is c2
        else:
            store.evict("a")
            assert store.stats("a")["ordering_cache"] == {
                "hits": 2, "misses": 1, "nn_hits": 1, "entries": 0}
        oc2 = store.snapshot("a").ordering
        assert oc2 is not oc and oc2.scene == "a"
        oc2.get(o0)
        oc2.get(o0)
    assert ts.stats("a")["ordering_cache"] == js.stats("a")["ordering_cache"]
    for name in ("ordering_cache_hits", "ordering_cache_misses"):
        assert ts.metrics.counter(name, scene="a").value == \
            js.metrics.counter(name, scene="a").value


# -- the scene-routed engine -------------------------------------------------------


def _engines(tmp_path, scenes, budget=None, **kw):
    kw.setdefault("ray_chunk", 16 * 16)
    one = _one_bytes(scenes[0])
    mrb = None if budget is None else int(budget * one)
    f, c = scenes[0]
    je = JaxEngine(CFG, f, c, scene_name="a", max_resident_bytes=mrb,
                   spill_dir=str(tmp_path / "jspill"), **kw)
    te = RenderEngine(TCFG, *_port(scenes[0]), scene_name="a",
                      max_resident_bytes=mrb,
                      spill_dir=str(tmp_path / "tspill"), device=CPU, **kw)
    return je, te


def test_engine_revived_scene_renders_identically(tmp_path, scenes):
    je, te = _engines(tmp_path, scenes, budget=1.5)
    cam = carry_camera(jrays.make_cameras(3, 16, 16)[0])
    img_a = te.submit(cam, scene="a").result().img
    te.register_scene("b", *_port(scenes[7]))          # evicts a
    assert te.store.resident_scenes() == ["b"]
    img_b = te.submit(cam, scene="b").result().img
    np.testing.assert_array_equal(te.submit(cam, scene="a").result().img,
                                  img_a)
    np.testing.assert_array_equal(te.submit(cam, scene="b").result().img,
                                  img_b)
    s = te.stats()
    assert s["evictions"] >= 2 and s["revivals"] >= 2
    assert s["timeouts"] == 0


def test_engine_two_scene_flush_matches_reference(tmp_path, scenes):
    """One flush holding requests for two scenes renders each from its own
    snapshot: every image within 1e-4 of the reference's for that scene,
    with the reference renderer's exact processed_samples and
    active_pairs_max."""
    je, te = _engines(tmp_path, scenes, max_batch_views=16)
    je.register_scene("b", *scenes[7])
    te.register_scene("b", *_port(scenes[7]))
    cams = jrays.make_cameras(4, 16, 16)
    keys = {te.ordering.key_for(carry_camera(c).origin) for c in cams}
    assert len(keys) == 4           # one view a group: per-view counters
    jf = [(n, c, je.submit(c, scene=n)) for c in cams for n in ("a", "b")]
    tf = [te.submit(carry_camera(c), scene=n) for c in cams
          for n in ("a", "b")]
    je.flush()
    te.flush()
    budget = te.stats()["pair_budget_initial"]
    render = jpipe.make_ray_renderer(CFG, chunk=8, pair_budget=budget)
    for (n, cam, jfut), tfut in zip(jf, tf):
        want, got = jfut.result(), tfut.result()
        assert got.scene == want.scene == n
        np.testing.assert_allclose(got.img, want.img, atol=1e-4)
        np.testing.assert_allclose(got.depth, want.depth, atol=1e-4)
        snap = je.store.snapshot(n)
        centers, valid = snap.ordering.get_ordered(cam.origin)
        o, d = (jnp.asarray(x) for x in _rays(cam))
        _, aux = render(snap.field, centers, valid, o, d)
        assert got.stats["processed_samples"] == float(
            aux["processed_samples"])
        assert got.stats["active_pairs_max"] == int(aux["active_pairs_max"])
    js, ts = je.stats(), te.stats()
    for n in ("a", "b"):
        assert ts["scenes"][n]["views_served"] == \
            js["scenes"][n]["views_served"] == 4
    assert ts["views_served"] == js["views_served"] == 8


def _rays(cam):
    from repro.core import rendering as jrender
    return jrender.camera_rays(cam)


def test_engine_concurrent_submits_across_scenes(tmp_path, scenes):
    """Producer threads hammer two resident scenes while flushes
    interleave: every future resolves with its own scene's image."""
    _, te = _engines(tmp_path, scenes, max_batch_views=3)
    te.register_scene("b", *_port(scenes[7]))
    cam = carry_camera(jrays.make_cameras(3, 16, 16)[0])
    ref = {n: te.submit(cam, scene=n).result().img for n in ("a", "b")}
    assert float(np.abs(ref["a"] - ref["b"]).mean()) > 1e-5
    futs, errs = [], []

    def producer(tid):
        try:
            for i in range(6):
                n = ("a", "b")[(tid + i) % 2]
                futs.append((n, te.submit(cam, scene=n)))
        except BaseException as e:            # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    te.flush()
    assert not errs and len(futs) == 18
    for n, f in futs:
        r = f.result(timeout=JOIN_S)
        assert not r.timed_out and r.scene == n
        np.testing.assert_array_equal(r.img, ref[n])
    s = te.stats()
    assert s["views_served"] == 20
    assert s["scenes"]["a"]["views_served"] + \
        s["scenes"]["b"]["views_served"] == 20


def test_store_concurrent_revival_races_single_unspill(tmp_path, scenes,
                                                       monkeypatch):
    """Two threads touch an evicted scene at once: the store lock admits
    one unspill, and both renders equal the pre-eviction frame."""
    _, te = _engines(tmp_path, scenes)
    cam = carry_camera(jrays.make_cameras(1, 16, 16)[0])
    baseline = te.submit(cam, scene="a").result().img
    te.store.evict("a")
    real = tstore.ckpt_lib.unspill_field
    unspills = []

    def slow_unspill(path, cfg, **kw):
        unspills.append(path)
        time.sleep(0.2)                       # widen the race window
        return real(path, cfg, **kw)

    monkeypatch.setattr(tstore.ckpt_lib, "unspill_field", slow_unspill)
    barrier = threading.Barrier(2)
    out, errs = [None, None], []

    def toucher(i):
        try:
            barrier.wait(JOIN_S)
            fi = te.submit(cam, scene="a")
            te.flush()
            out[i] = fi.result(timeout=JOIN_S).img
        except BaseException as e:            # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=toucher, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    assert not errs
    assert len(unspills) == 1
    assert te.store.stats("a")["revivals"] == 1
    np.testing.assert_array_equal(out[0], baseline)
    np.testing.assert_array_equal(out[1], baseline)


def test_swap_field_matches_reference(tmp_path, scenes):
    """swap_field publishes through the store: the next render uses the
    new field (image within 1e-4 of the reference's after the same swap),
    with and without precomputed cubes; update_cubes likewise."""
    je, te = _engines(tmp_path, scenes)
    cam = jrays.make_cameras(3, 16, 16)[1]
    tcam = carry_camera(cam)
    before = te.submit(tcam).result().img
    je.submit(cam).result()
    f7, c7 = scenes[7]
    je.swap_field(f7, c7)
    te.swap_field(*_port(scenes[7]))
    got, want = te.submit(tcam).result(), je.submit(cam).result()
    np.testing.assert_allclose(got.img, want.img, atol=1e-4)
    assert float(np.abs(got.img - before).max()) > 1e-3
    je.swap_field(scenes[1][0])                       # cubes rebuilt
    te.swap_field(_port(scenes[1])[0])
    assert te.cubes.count == je.cubes.count
    np.testing.assert_array_equal(te.cubes.centers.numpy(),
                                  np.asarray(je.cubes.centers))
    np.testing.assert_allclose(te.submit(tcam).result().img,
                               je.submit(cam).result().img, atol=1e-4)
    je.update_cubes(scenes[2][1])
    te.update_cubes(_port(scenes[2])[1])
    np.testing.assert_allclose(te.submit(tcam).result().img,
                               je.submit(cam).result().img, atol=1e-4)
    js, ts = je.stats(), te.stats()
    assert ts["field_swaps"] == js["field_swaps"] == 2
    assert ts["ordering_cache"] == js["ordering_cache"]


def test_engine_stats_keys_match_reference(tmp_path, scenes):
    je, te = _engines(tmp_path, scenes)
    je.register_scene("b", *scenes[7])
    te.register_scene("b", *_port(scenes[7]))
    cam = jrays.make_cameras(3, 16, 16)[0]
    je.submit(cam, scene="b").result()
    te.submit(carry_camera(cam), scene="b").result()
    agg_t, agg_j = te.stats(), je.stats()
    assert set(agg_j) <= set(agg_t)
    assert set(agg_t) - set(agg_j) == {"dispatch_path"}
    assert set(agg_t["delta"]) == set(agg_j["delta"])
    assert agg_t["n_scenes"] == 2 and set(agg_t["scenes"]) == {"a", "b"}
    assert agg_t["field_kind"] == agg_j["field_kind"] == "compressed"
    for n in ("a", "b"):
        per_t, per_j = te.stats(scene=n), je.stats(scene=n)
        assert set(per_t) == set(per_j)
        assert _counters(per_t) == _counters(per_j)
    assert te.stats(scene="b")["views_served"] == 1
    assert te.stats(scene="b")["scene"] == "b"
    assert te.stats(scene="a")["views_served"] == 0
    with pytest.raises(KeyError):
        te.stats(scene="zzz")


def test_engine_store_argument_checks(tmp_path, scenes):
    store = SceneStore(TCFG, device=CPU, spill_dir=str(tmp_path / "s"))
    store.register("lego", *_port(scenes[0]))
    eng = RenderEngine(TCFG, store=store, ray_chunk=64)
    assert eng.device == CPU and eng.metrics is store.metrics
    assert eng.default_scene == "lego"
    f, c = _port(scenes[0])
    with pytest.raises(ValueError, match="not both"):
        RenderEngine(TCFG, f, store=store)
    with pytest.raises(ValueError, match="conflicts"):
        from repro_torch.obs import MetricsRegistry
        RenderEngine(TCFG, store=store, registry=MetricsRegistry())
    with pytest.raises(ValueError, match="without a field"):
        RenderEngine(TCFG, None, c, device=CPU)
    empty = RenderEngine(TCFG, device=CPU)
    with pytest.raises(RuntimeError, match="no registered scenes"):
        empty.submit(carry_camera(jrays.make_cameras(1, 8, 8)[0]))
