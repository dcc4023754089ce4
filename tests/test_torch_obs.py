"""The port's observability stack (`repro_torch.obs`) against the
reference's (`repro.obs`): the same operations give identical registry
snapshots, JSON envelopes and Prometheus text; span tracing; the HTTP
endpoint and the stats reporter (each joined with a timeout); the
runtime lock-order checker (mirrors tests/test_lockdebug.py) with a clean
order for the port's engine and store; and the engine's registry-backed
stats and span trees (mirrors the engine part of tests/test_obs.py)."""
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           numpy_params, tiny_cfg, torch_cfg)
from repro import obs as jobs
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.data import rays as jrays
from repro.serving import RenderEngine as JaxEngine
from repro_torch import obs as tobs
from repro_torch.obs import lockdebug
from repro_torch.obs.lockdebug import LockOrderError, make_lock
from repro_torch.serving import RenderEngine, SceneStore

CFG = tiny_cfg()
TCFG = torch_cfg(CFG)
JOIN_S = 30.0


@pytest.fixture(scope="module")
def scene():
    params = {k: jnp.asarray(v) for k, v in numpy_params(CFG, 3).items()}
    field = jfield.DenseField(params, CFG).prune(sparsity=0.9)
    cubes = jocc.extract_cubes(jocc.build_occupancy(field, CFG,
                                                    sigma_thresh=0.01), CFG)
    return field, cubes


def _port(scene):
    return carry_field(scene[0], CFG), carry_cubes(scene[1])


# -- registry, exposition: identical to the reference --------------------------


def _drive(obs):
    """One fixed sequence of operations on a registry and a tracer."""
    reg = obs.MetricsRegistry()
    reg.counter("views_total", scene="lego").inc(5)
    reg.counter("views_total", scene="chair").inc(2.5)
    reg.counter("hits").inc()
    reg.gauge("queue_depth").set(2)
    reg.gauge("queue_depth").inc(3)
    h = reg.histogram("latency_s", maxlen=4)
    h.extend([0.1, 0.4, 0.2, 0.3, 0.05, 0.9])
    reg.histogram("empty_s", scene="x")
    tr = obs.Tracer(reg, max_traces=2)
    for i in range(3):
        t = tr.start(i, "lego", t_submit=100.0 + i)
        t.add("submit", 100.0 + i, 100.25 + i)
        t.add("render", 100.5 + i, 101.0 + i, dispatch_path="fused",
              n_chunks=3)
        tr.finish(t, t_done=101.5 + i)
    return reg, tr


def test_snapshot_json_and_prometheus_identical_to_reference():
    treg, ttr = _drive(tobs)
    jreg, jtr = _drive(jobs)
    ts = tobs.snapshot_json(treg, extra={"fps": 1.5})
    js = jobs.snapshot_json(jreg, extra={"fps": 1.5})
    assert ts.pop("ts_unix_s") > 0 and js.pop("ts_unix_s") > 0
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)
    assert tobs.to_prometheus(treg) == jobs.to_prometheus(jreg)
    assert [t.tree() for t in ttr.completed()] == \
        [t.tree() for t in jtr.completed()]
    assert tobs.flat_name("a", (("k", "v"),)) == "a{k=v}"
    assert tobs.STAGES == jobs.STAGES
    assert tobs.REPORT_STAGES == jobs.REPORT_STAGES


def test_counter_gauge_histogram_semantics():
    reg = tobs.MetricsRegistry()
    c = reg.counter("reqs")
    c.inc()
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 3.5
    g = reg.gauge("depth")
    g.set(4)
    g.inc()
    g.set(2)
    assert g.value == 2.0
    h = reg.histogram("lat", maxlen=8)
    h.record(100.0)                       # the all-time max, soon evicted
    for v in range(1, 21):
        h.record(float(v))
    assert len(h.window()) == 8 and h.count == 21
    assert h.max == 100.0 and h.window().max() == 20.0 and h.last == 20.0
    assert h.sum == pytest.approx(100.0 + sum(range(1, 21)))
    assert h.percentile(50) == pytest.approx(
        float(np.percentile(np.arange(13, 21, dtype=float), 50)))
    assert reg.counter("reqs") is c                   # cached handle
    with pytest.raises(TypeError):
        reg.gauge("reqs")
    assert tobs.get_registry() is tobs.get_registry()


def test_registry_thread_safety():
    """More threads than cores, switching often: no update is lost."""
    reg = tobs.MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("v", maxlen=128)

    def work():
        for i in range(500):
            c.inc()
            h.record(float(i))
            reg.counter("n")                  # handle lookups race too

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert c.value == 8000 and h.count == 8000 and len(h.window()) == 128
    assert h.sum == 16 * sum(range(500))


def test_tracer_disabled_and_bounded():
    reg = tobs.MetricsRegistry()
    off = tobs.Tracer(reg, enabled=False)
    assert off.start(1, "lego") is None
    off.finish(None)
    assert off.completed() == [] and reg.metrics() == []
    tr = tobs.Tracer(reg, max_traces=4)
    for i in range(10):
        tr.finish(tr.start(i, "s", t_submit=float(i)))
    assert [t.view_id for t in tr.completed()] == [6, 7, 8, 9]
    assert tr.last().view_id == 9


def test_metrics_server_endpoints_match_reference():
    treg, _ = _drive(tobs)
    jreg, _ = _drive(jobs)
    with tobs.MetricsServer(treg, port=0, extra=lambda: {"fps": 12.5}) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        snap = json.loads(urllib.request.urlopen(
            f"{base}/metrics.json", timeout=JOIN_S).read())
        assert snap["schema"] == "repro.obs/v1"
        assert snap["stats"] == {"fps": 12.5}
        assert snap["metrics"] == json.loads(json.dumps(jreg.snapshot()))
        text = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=JOIN_S).read().decode()
        assert text == jobs.to_prometheus(jreg)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=JOIN_S)
    assert not srv._thread.is_alive()


def test_stats_reporter_emits_and_stops(capsys):
    rep = tobs.StatsReporter(lambda: "tick", interval_s=0.02)
    time.sleep(0.1)
    rep.close()
    assert not rep._thread.is_alive()
    assert "tick" in capsys.readouterr().out


# -- lockdebug (mirrors tests/test_lockdebug.py) ----------------------------------


@pytest.fixture
def lock_debug(monkeypatch):
    monkeypatch.setenv("REPRO_LOCK_DEBUG", "1")
    lockdebug.reset()
    yield
    lockdebug.reset()


def test_disabled_returns_plain_stdlib_locks(monkeypatch):
    monkeypatch.delenv("REPRO_LOCK_DEBUG", raising=False)
    assert isinstance(make_lock("a"), type(threading.Lock()))
    assert isinstance(make_lock("b", kind="rlock"), type(threading.RLock()))
    assert not lockdebug.enabled()
    with pytest.raises(ValueError):
        make_lock("c", kind="mutex")


def test_inversion_raises_before_blocking(lock_debug):
    a, b = make_lock("A"), make_lock("B")
    assert not isinstance(a, type(threading.Lock()))
    with a:
        with b:
            pass
    assert ("A", "B") in lockdebug.edges()
    with b:
        with pytest.raises(LockOrderError, match="inversion"):
            with a:
                pass
    with a:                            # the raise came before the acquire
        pass


def test_inversion_detected_across_threads(lock_debug):
    a, b = make_lock("A"), make_lock("B")

    def establish():
        with a:
            with b:
                pass

    t = threading.Thread(target=establish)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive()
    with b:
        with pytest.raises(LockOrderError):
            a.acquire()


def test_reentrancy_rules(lock_debug):
    r = make_lock("R", kind="rlock")
    with r:
        with r:
            pass
    lk = make_lock("L")
    with lk:
        with pytest.raises(LockOrderError, match="reentrant"):
            lk.acquire()


def test_same_label_shares_ordering(lock_debug):
    a1, a2, b = make_lock("A"), make_lock("A"), make_lock("B")
    with a1:
        with b:
            pass
    with b:
        with pytest.raises(LockOrderError):
            a2.acquire()


def test_condition_wait_keeps_held_stack_honest(lock_debug):
    lk = make_lock("cv", kind="rlock")
    cv = threading.Condition(lk)
    other = make_lock("other")
    with cv:
        cv.wait(timeout=0.01)
        with other:
            pass
    with other:
        pass
    assert ("cv", "other") in lockdebug.edges()
    assert ("other", "cv") not in lockdebug.edges()


def test_engine_and_store_lock_order_clean_under_debug(lock_debug, tmp_path,
                                                       scene):
    """The port's engine and store, created with tracked locks, go
    through register, submit, flush, evict, revival, swap, stats and the
    auto-flush thread: no inversion, and never store -> engine."""
    f, c = _port(scene)
    one = f.encode().factor_bytes()
    eng = RenderEngine(TCFG, f, c, scene_name="a", ray_chunk=64,
                       max_resident_bytes=int(1.5 * one), device=CPU,
                       spill_dir=str(tmp_path / "spill"))
    assert not isinstance(eng._lock, type(threading.RLock()))
    eng.register_scene("b", *_port(scene))            # evicts a
    cam = carry_camera(jrays.make_cameras(2, 8, 8)[0])
    eng.submit(cam, scene="a").result(timeout=JOIN_S)  # revives a
    eng.swap_field(*_port(scene), scene="b")
    eng.start_auto_flush(0.01)
    try:
        futs = [eng.submit(cam, scene=s) for s in ("a", "b")]
        for fu in futs:
            fu.result(timeout=JOIN_S)
        eng.stats()
        eng.stats(scene="a")
    finally:
        eng.close(timeout=JOIN_S)
    edges = lockdebug.edges()
    assert ("engine.render", "store") in edges
    assert ("store", "engine") not in edges
    assert ("store", "engine.render") not in edges


# -- the engine's registry and spans (mirrors tests/test_obs.py) --------------------


def test_request_span_tree_complete(scene):
    eng = RenderEngine(TCFG, *_port(scene), ray_chunk=64, max_batch_views=2,
                       device=CPU)
    cam = carry_camera(jrays.make_cameras(1, 12, 12)[0])
    fut = eng.submit(cam)
    eng.flush()
    res = fut.result(timeout=JOIN_S)
    names = [s["name"] for s in res.trace["stages"]]
    for stage in tobs.STAGES:
        assert stage in names, (stage, names)
    render = next(s for s in res.trace["stages"] if s["name"] == "render")
    assert render["dispatch_path"] == "fused_ref" == res.stats[
        "dispatch_path"]
    assert 0 < render["dur_s"] <= res.trace["dur_s"]
    assert eng.tracer.last().view_id == res.trace["view_id"]
    br = eng.stage_breakdown()
    assert set(br) == set(tobs.STAGES) and br["render"]["count"] == 1
    assert eng.metrics.counter("render_dispatch_total",
                               path="fused_ref").value == 1


def test_engine_metric_names_match_reference(scene):
    """The same requests on both engines register the same metrics (names,
    labels and kinds) and the same counter values."""
    cam = jrays.make_cameras(2, 12, 12)[1]
    je = JaxEngine(CFG, *scene, ray_chunk=64, max_batch_views=2)
    te = RenderEngine(TCFG, *_port(scene), ray_chunk=64, max_batch_views=2,
                      device=CPU)
    je.render_views([cam, cam])
    te.render_views([carry_camera(cam)] * 2)
    je.submit(cam, deadline_s=-1.0)
    te.submit(carry_camera(cam), deadline_s=-1.0)
    je.flush()
    te.flush()
    je.stage_breakdown()
    te.stage_breakdown()
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert set(ts[kind]) == set(js[kind]), kind
    for k, v in js["counters"].items():
        if not k.startswith(("engine_render_s", "scene_render_s")):
            assert ts["counters"][k] == v, k
    for k, v in js["gauges"].items():
        assert ts["gauges"][k] == v, k
    for k, v in js["histograms"].items():
        assert ts["histograms"][k]["count"] == v["count"], k


def test_engine_stats_registry_backed_and_tracing_toggle(scene):
    eng = RenderEngine(TCFG, *_port(scene), ray_chunk=64, max_batch_views=2,
                       device=CPU)
    cam = carry_camera(jrays.make_cameras(1, 12, 12)[0])
    eng.render_views([cam])
    s = eng.stats()
    assert s["views_served"] == 1
    assert s["latency_p99_s"] >= s["latency_p50_s"] > 0
    snap = eng.metrics.snapshot()
    assert snap["counters"]["engine_views_served"]["value"] == 1
    assert snap["histograms"]["engine_latency_s"]["count"] == 1
    eng.set_tracing(False)
    n_before = len(eng.tracer.completed())
    r = eng.render_views([cam])[0]
    assert r.trace is None and not r.timed_out and r.img is not None
    assert len(eng.tracer.completed()) == n_before
    assert eng.stats()["views_served"] == 2
    assert eng.queue_depth() == 0


def test_drop_timeout_accounting_concurrent_multiscene(scene):
    eng = RenderEngine(TCFG, *_port(scene), scene_name="a", ray_chunk=64,
                       max_batch_views=4, device=CPU)
    eng.register_scene("b", *_port(scene))
    cams = [carry_camera(c) for c in jrays.make_cameras(4, 12, 12)]
    base_views = eng.stats()["views_served"]
    futs, lock = [], threading.Lock()

    def submit_stream(name, deadline):
        mine = [eng.submit(c, scene=name, deadline_s=deadline) for c in cams]
        with lock:
            futs.extend(mine)

    threads = [threading.Thread(target=submit_stream, args=a)
               for a in (("a", None), ("b", None), ("a", 1e-9))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()
    eng.flush()
    results = [f.result(timeout=JOIN_S) for f in futs]
    n_out = sum(r.timed_out for r in results)
    assert len(results) == 12 and n_out == 4
    s = eng.stats()
    assert s["timeouts"] == n_out
    assert s["views_served"] - base_views == 12 - n_out
    for r in results:
        if r.timed_out:
            deliver = [st for st in r.trace["stages"]
                       if st["name"] == "deliver"]
            assert deliver and deliver[0]["timed_out"] is True
            assert not any(st["name"] == "render"
                           for st in r.trace["stages"])
    dropped = sum(st.get("dropped_pairs", 0) for r in results
                  for st in r.trace["stages"] if st["name"] == "render")
    assert int(eng.metrics.counter("engine_dropped_pairs").value) == dropped


def test_store_and_engine_share_registry(scene):
    reg = tobs.MetricsRegistry()
    store = SceneStore(TCFG, registry=reg, device=CPU)
    store.register("lego", *_port(scene))
    eng = RenderEngine(TCFG, store=store, ray_chunk=64, max_batch_views=2)
    assert eng.metrics is reg and store.metrics is reg
    eng.render_views([carry_camera(jrays.make_cameras(1, 12, 12)[0])],
                     scene="lego")
    snap = reg.snapshot()
    assert snap["counters"]["scene_views_served{scene=lego}"]["value"] == 1
    assert snap["counters"]["engine_views_served"]["value"] == 1
    sc = eng.stats(scene="lego")
    assert sc["latency_p50_s"] > 0
    assert sc["latency_p50_s"] == pytest.approx(
        snap["histograms"]["scene_latency_s{scene=lego}"]["p50"])


# -- auto-flush and result(timeout) -----------------------------------------------


def test_auto_flush_resolves_futures_and_close_joins(scene):
    """Producers only enqueue; the flush thread renders on interval or a
    full queue; every future resolves through result(timeout=...) with
    the image a synchronous engine gives; close() joins the thread."""
    f, c = _port(scene)
    sync = RenderEngine(TCFG, f, c, ray_chunk=64, device=CPU)
    cam = carry_camera(jrays.make_cameras(2, 8, 8)[1])
    want = sync.submit(cam).result().img
    eng = RenderEngine(TCFG, f, c, scene_name="a", ray_chunk=64,
                       max_batch_views=3, auto_flush_interval=0.02,
                       device=CPU)
    try:
        eng.register_scene("b", f, c)
        assert eng.stats()["auto_flush_running"]
        futs, errs = [], []

        def producer():
            try:
                for s in ("a", "b"):
                    futs.append(eng.submit(cam, scene=s))
            except BaseException as e:        # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=producer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
        results = [fu.result(timeout=JOIN_S) for fu in futs]
        flusher = eng._flusher
        with pytest.raises(RuntimeError, match="already running"):
            eng.start_auto_flush(0.02)
    finally:
        eng.close(timeout=JOIN_S)
    assert not errs and len(results) == 8
    assert not flusher.is_alive()
    assert not eng.stats()["auto_flush_running"]
    for r in results:
        np.testing.assert_array_equal(r.img, want)
    assert eng.stats()["views_served"] == 8 and eng.stats()["timeouts"] == 0


def test_result_timeout_raises_while_the_flusher_is_stalled(scene):
    """result(timeout) raises TimeoutError when the view is not rendered
    in time (a flush thread that never flushes), instead of hanging."""
    eng = RenderEngine(TCFG, *_port(scene), ray_chunk=64, device=CPU,
                       max_batch_views=100)
    eng.start_auto_flush(3600.0)               # only a full queue flushes
    cam = carry_camera(jrays.make_cameras(1, 8, 8)[0])
    try:
        fut = eng.submit(cam)
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="unresolved after"):
            fut.result(timeout=0.2)
        assert time.perf_counter() - t0 < JOIN_S
    finally:
        eng.close(timeout=JOIN_S)              # drains the queue
    assert fut.done() and fut.result(timeout=1.0).img is not None


def test_flush_errors_requeue_and_surface(scene, monkeypatch):
    """A failing render requeues its requests and the error surfaces
    through result(); the next flush serves them."""
    eng = RenderEngine(TCFG, *_port(scene), ray_chunk=64, device=CPU)
    cam = carry_camera(jrays.make_cameras(1, 8, 8)[0])
    real = eng._render

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    eng._render = broken
    fut = eng.submit(cam)
    with pytest.raises(RuntimeError, match="device lost"):
        fut.result(timeout=JOIN_S)
    assert eng.queue_depth() == 1 and not fut.done()
    eng._render = real
    assert fut.result(timeout=JOIN_S).img is not None
