"""The port's fleet tier (`repro_torch.serving.fleet` / `router`) against
the reference's: wire frames byte for byte both ways, the same bad frames
refused, the hash ring's owners, cameras on the wire, scene exports that
load across packages exactly, and one worker loop driven in a thread of
this process (images equal to the port engine's exactly and to the
reference engine's within 1e-4).

The tests that spawn worker processes carry the `fleet` marker, as
`tests/test_fleet.py`'s do (each worker imports torch, which would
dominate the tier-1 wall clock): run them with
`pytest tests/test_torch_fleet.py --fleet`. Every future waits with a
timeout, so nothing can hang."""
import json
import multiprocessing as mp
import os
import signal
import struct
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           jax_case, n, torch_cfg)
from repro.core import occupancy as jocc
from repro.data import rays as jrays
from repro.serving import RenderEngine as JaxEngine
from repro.serving import fleet as jfleet
from repro.serving import router as jrouter
from repro_torch.serving import FleetError, FleetRouter, HashRing
from repro_torch.serving import RenderEngine
from repro_torch.serving import fleet as tfleet

SCENES = ["alpha", "beta", "gamma"]
RES = 16
TIMEOUT_S = 180.0


# -- wire format -----------------------------------------------------------


def _message(dtype: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.random((3, 5)) < 0.5
    elif dtype.startswith("float"):
        a = rng.normal(size=(3, 5)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, size=(3, 5), dtype=dtype,
                         endpoint=True)
    return {"op": "render", "req": 7, "scene": "lego", "arr": a,
            "scalar": np.asarray(a.flat[0]), "empty": a[:0],
            "nested": {"a": [1, 2.5, None, True], "b": {"c": "é"}},
            "deadline_s": None}


@pytest.mark.parametrize("dtype", tfleet.WIRE_DTYPES)
def test_frames_are_the_references_byte_for_byte(dtype):
    assert tfleet.WIRE_DTYPES == jfleet.WIRE_DTYPES
    assert tfleet.WIRE_VERSION == jfleet.WIRE_VERSION
    msg = _message(dtype)
    frame = tfleet.pack_msg(msg)
    assert frame == jfleet.pack_msg(msg)
    want = jfleet.unpack_msg(frame)
    for got in (tfleet.unpack_msg(jfleet.pack_msg(msg)),
                tfleet.unpack_msg(frame)):
        assert sorted(got) == sorted(msg) == sorted(want)
        for k, v in msg.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == want[k].dtype == v.dtype
                assert got[k].shape == want[k].shape
                np.testing.assert_array_equal(got[k], want[k])
                np.testing.assert_array_equal(got[k].reshape(v.shape), v)
            else:
                assert got[k] == want[k] == v
    # both decode a 0-d array with shape (1,): `reshape([])` of a
    # one-element buffer keeps its one axis
    assert want["scalar"].shape == (1,)


def _bad_frames() -> dict:
    good = tfleet.pack_msg({"op": "x", "arr": np.arange(6, dtype=np.int32)})
    (hlen,) = struct.unpack_from(">I", good, 0)
    head = json.loads(good[4:4 + hlen])

    def with_head(h):
        hb = json.dumps(h).encode()
        return struct.pack(">I", len(hb)) + hb + good[4 + hlen:]
    return {
        "too_short": good[:3],
        "truncated_header": good[:4 + hlen - 1],
        "truncated_array": good[:-5],
        "wrong_version": with_head(dict(head, _v=2)),
        "no_version": with_head({k: v for k, v in head.items()
                                 if k != "_v"}),
        "dtype_outside_allowlist": with_head(dict(head, _arrays=[
            dict(head["_arrays"][0], dtype="object")])),
        "structured_dtype": with_head(dict(head, _arrays=[
            dict(head["_arrays"][0], dtype="V8")])),
    }


@pytest.mark.parametrize("kind", sorted(_bad_frames()))
def test_bad_frames_raise_wire_error_in_both(kind):
    frame = _bad_frames()[kind]
    with pytest.raises(jfleet.WireError):
        jfleet.unpack_msg(frame)
    with pytest.raises(tfleet.WireError) as e:
        tfleet.unpack_msg(frame)
    assert isinstance(e.value, ValueError)


def test_frame_cut_inside_a_length_prefix_raises_wire_error():
    """The port checks the 8-byte array length prefix before reading it;
    the reference reads it unchecked and raises struct.error, which its
    router's reader thread does not catch (ROADMAP Queue 3 item 12)."""
    good = tfleet.pack_msg({"arr": np.arange(4, dtype=np.int32)})
    frame = good[:-(16 + 4)]               # 4 bytes of the length prefix
    with pytest.raises(struct.error):
        jfleet.unpack_msg(frame)
    with pytest.raises(tfleet.WireError, match="truncated array"):
        tfleet.unpack_msg(frame)


# -- hash ring -------------------------------------------------------------


def _keys(count=400):
    return [f"scene-{i}" for i in range(count)]


def test_ring_owners_and_versions_are_the_references():
    rings = (HashRing(["w0", "w1", "w2"]), jrouter.HashRing(["w0", "w1",
                                                             "w2"]))
    ops = [("add", "w3"), ("remove", "w1"), ("add", "w1"), ("add", "w1"),
           ("remove", "w0"), ("remove", "w9"), ("add", "joiner")]
    for step in [None] + ops:
        if step is not None:
            for ring in rings:
                getattr(ring, step[0])(step[1])
        assert rings[0].version == rings[1].version
        assert rings[0].nodes == rings[1].nodes
        for key in _keys():
            for count in (1, 2, 3):
                assert rings[0].owners(key, count) == \
                    rings[1].owners(key, count), (step, key, count)
    assert HashRing().owners("x") == []
    with pytest.raises(FleetError):
        HashRing().owner("x")


@pytest.mark.parametrize("k", [2, 3, 4, 6])
def test_ring_leave_moves_only_dead_workers_keys(k):
    nodes = [f"w{i}" for i in range(k)]
    ring = HashRing(nodes)
    before = {key: ring.owner(key) for key in _keys()}
    ring.remove(nodes[0])
    for key, owner in before.items():
        if owner != nodes[0]:
            assert ring.owner(key) == owner
        else:
            assert ring.owner(key) != nodes[0]


@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_ring_join_moves_about_one_over_k(k):
    ring = HashRing([f"w{i}" for i in range(k)])
    keys = _keys(600)
    before = {key: ring.owner(key) for key in keys}
    ring.add("joiner")
    moved = [key for key in keys if ring.owner(key) != before[key]]
    assert all(ring.owner(key) == "joiner" for key in moved)
    assert len(moved) / len(keys) <= 2.5 / (k + 1)


# -- cameras and scene exports ---------------------------------------------


def test_cameras_on_the_wire_match_the_references():
    jcam = jrays.make_cameras(3, 16, 24)[1]
    tcam = carry_camera(jcam)
    want, got = jfleet.cam_to_wire(jcam), tfleet.cam_to_wire(tcam)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v and type(got[k]) is type(v)
    back = tfleet.cam_from_wire(tfleet.unpack_msg(tfleet.pack_msg(got)))
    assert back.c2w.device == CPU and back.h == 16 and back.w == 24
    torch.testing.assert_close(back.c2w, tcam.c2w, rtol=0, atol=0)
    torch.testing.assert_close(back.origin, tcam.origin, rtol=0, atol=0)


@pytest.fixture(scope="module")
def scenes():
    """Three encoded reference scenes (tiny config) with their cubes."""
    out = {}
    for i, name in enumerate(SCENES):
        cfg, cf, *_ = jax_case(0.9, threshold=0.80, seed=i)
        occ = jocc.build_occupancy(cf, cfg, sigma_thresh=0.01)
        out[name] = (cfg, cf, jocc.extract_cubes(occ, cfg))
    return out


@pytest.fixture(scope="module")
def port_paths(scenes, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_scenes")
    return {name: tfleet.export_scene(str(root / name),
                                      carry_field(cf, cfg),
                                      carry_cubes(cubes), scene=name)
            for name, (cfg, cf, cubes) in scenes.items()}


def _state(field):
    from repro_torch.core import field as tfield
    spec, arrays = tfield.field_state(field)
    return spec, {k: n(v) for k, v in arrays.items()}


def _assert_same_scene(jfield_cubes, tfield_cubes):
    from repro.core import field as jfield
    (jf, jc), (tf, tc) = jfield_cubes, tfield_cubes
    jspec, jarrays = jfield.field_state(jf)
    tspec, tarrays = _state(tf)
    assert tspec == jspec
    assert sorted(tarrays) == sorted(jarrays)
    for k, v in jarrays.items():
        v = np.asarray(v)
        assert tarrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tarrays[k], v, err_msg=k)
    for a, b in ((tc.centers, jc.centers), (tc.valid, jc.valid),
                 (tc.occ, jc.occ)):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert tc.count == jc.count and tc.radius == jc.radius


def test_port_export_loads_in_the_reference(scenes, port_paths):
    name = SCENES[0]
    cfg, cf, cubes = scenes[name]
    jf, jc = jfleet.load_scene(port_paths[name], cfg)
    tf, tc = tfleet.load_scene(port_paths[name], torch_cfg(cfg), device=CPU)
    _assert_same_scene((jf, jc), (tf, tc))
    _assert_same_scene((cf, cubes), (tf, tc))


def test_reference_export_loads_in_the_port(scenes, tmp_path):
    name = SCENES[1]
    cfg, cf, cubes = scenes[name]
    path = jfleet.export_scene(str(tmp_path / name), cf, cubes, scene=name)
    _assert_same_scene((cf, cubes),
                       tfleet.load_scene(path, torch_cfg(cfg), device=CPU))
    with open(os.path.join(path, "step_00000000", "manifest.json")) as f:
        assert json.load(f)["extra"]["scene"] == name


def test_export_builds_the_cubes_from_cfg_like_the_reference(scenes,
                                                              tmp_path):
    cfg, cf, _ = scenes[SCENES[2]]
    jpath = jfleet.export_scene(str(tmp_path / "j"), cf.decode(), cfg=cfg)
    tpath = tfleet.export_scene(str(tmp_path / "t"),
                                carry_field(cf.decode(), cfg),
                                cfg=torch_cfg(cfg))
    _assert_same_scene(jfleet.load_scene(jpath, cfg),
                       tfleet.load_scene(tpath, torch_cfg(cfg), device=CPU))
    with pytest.raises(ValueError, match="needs cubes or cfg"):
        tfleet.export_scene(str(tmp_path / "x"), carry_field(cf, cfg))


# -- one worker loop, in a thread of this process --------------------------


class _Client:
    def __init__(self, conn):
        self.conn = conn
        self.req = 0

    def send(self, **msg) -> int:
        self.req += 1
        self.conn.send_bytes(tfleet.pack_msg(dict(msg, req=self.req)))
        return self.req

    def recv(self) -> dict:
        assert self.conn.poll(TIMEOUT_S), "no reply from the worker"
        return tfleet.unpack_msg(self.conn.recv_bytes())


def test_worker_loop_serves_the_protocol(scenes, port_paths):
    name = SCENES[0]
    cfg, cf, cubes = scenes[name]
    tcfg = torch_cfg(cfg)
    kwargs = {"device": "cpu", "ray_chunk": RES * RES}
    here, there = mp.Pipe()
    worker = threading.Thread(
        target=tfleet.worker_main,
        args=(there, "t0", tfleet.cfg_to_fields(tcfg), kwargs), daemon=True)
    worker.start()
    c = _Client(here)
    try:
        req = c.send(op="register", scene=name, path=port_paths[name])
        assert c.recv() == {"op": "ok", "req": req}

        jcams = jrays.make_cameras(2, RES, RES)
        gt = np.full((RES * RES, 3), 0.5, np.float32)
        reqs = [c.send(op="render", scene=name, gt=gt,
                       **tfleet.cam_to_wire(carry_camera(cam)))
                for cam in jcams]
        results = {}
        for _ in reqs:
            m = c.recv()
            results[m["req"]] = m
        assert sorted(results) == reqs
        imgs = [results[r]["img"] for r in reqs]
        for m in results.values():
            assert m["op"] == "result" and m["worker"] == "t0"
            assert m["scene"] == name and not m["timed_out"]
            assert m["img"].dtype == np.float32
            assert m["img"].shape == (RES * RES, 3)

        # the port engine's direct render: the same images exactly
        field, tcubes = tfleet.load_scene(port_paths[name], tcfg, device=CPU)
        eng = RenderEngine(tcfg, field, tcubes, scene_name=name, **kwargs)
        futs = [eng.submit(carry_camera(cam), gt) for cam in jcams]
        direct = [f.result() for f in futs]
        for img, d, r in zip(imgs, direct, reqs):
            np.testing.assert_array_equal(img, d.img)
            assert results[r]["psnr"] == d.psnr
        # the reference engine's: within 1e-4
        je = JaxEngine(cfg, cf, cubes, ray_chunk=RES * RES,
                       trace_requests=False)
        want = [je.submit(cam).result() for cam in jcams]
        for img, w in zip(imgs, want):
            np.testing.assert_allclose(img, w.img, atol=1e-4)

        req = c.send(op="stats")
        m = c.recv()
        assert m["op"] == "stats" and m["req"] == req
        s = m["stats"]
        ref_keys = set(jfleet._Worker("r", cfg, {}).stats())
        assert ref_keys <= set(s)
        assert s["worker"] == "t0" and s["views_served"] == 2
        assert s["scene_views"] == {name: 2}
        assert s["device"] == "cpu"
        assert s["scene_dispatch_path"] == {name: "fused_ref"}
        assert set(s["launches"]) == {
            "fused_sigma_app", "bitmap_gather", "coo_gather",
            "bitmap_matmul", "volume_render", "flash_attention",
            "bitmap_gather_bwd", "coo_gather_bwd"}

        req = c.send(op="ping")
        assert c.recv() == {"op": "pong", "req": req}
        req = c.send(op="no_such_op")
        m = c.recv()
        assert m["op"] == "err" and m["req"] == req
        assert "unknown op" in m["error"]
        here.send_bytes(b"\x00\x00")                # malformed frame
        m = c.recv()
        assert m["op"] == "err" and m["req"] is None
        assert "WireError" in m["error"]
        req = c.send(op="render", scene="nowhere",
                     **tfleet.cam_to_wire(carry_camera(jcams[0])))
        m = c.recv()
        assert m["op"] == "err" and m["req"] == req
        req = c.send(op="inject", stall_s=0.0)
        assert c.recv() == {"op": "ok", "req": req}
        req = c.send(op="ping")                      # still serving
        assert c.recv() == {"op": "pong", "req": req}
        c.send(op="shutdown")
        worker.join(TIMEOUT_S)
        assert not worker.is_alive()
    finally:
        here.close()
        worker.join(TIMEOUT_S)


# -- spawned routers (the `fleet` marker) ----------------------------------


def _router(scenes, paths, **kw):
    tcfg = torch_cfg(scenes[SCENES[0]][0])
    return FleetRouter(tcfg, paths, n_workers=2,
                       engine_kwargs={"device": "cpu",
                                      "ray_chunk": RES * RES}, **kw)


def _cam():
    return carry_camera(jrays.make_cameras(1, RES, RES)[0])


def _render(router, scene, **kw):
    return router.submit(_cam(), scene=scene, **kw).result(timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def fleet(scenes, port_paths):
    router = _router(scenes, port_paths)
    yield router
    router.close()


def test_router_without_a_card_raises_before_spawning(monkeypatch, scenes,
                                                      port_paths):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = torch_cfg(scenes[SCENES[0]][0])
    for kwargs in (None, {"device": "cuda"}):
        with pytest.raises(RuntimeError):
            FleetRouter(tcfg, port_paths, n_workers=2, engine_kwargs=kwargs)
    assert not mp.active_children()


@pytest.mark.fleet
def test_affinity_stable_under_churn(fleet):
    scene = SCENES[0]
    owner0 = fleet.owner_of(scene)
    version0 = fleet.ring.version
    r0 = _render(fleet, scene)
    assert not r0.timed_out and r0.img is not None and r0.worker == owner0
    fleet.evict(scene)
    assert fleet.owner_of(scene) == owner0
    np.testing.assert_array_equal(_render(fleet, scene).img, r0.img)
    fleet.evict(scene)
    fleet.prefetch(scene)
    np.testing.assert_array_equal(_render(fleet, scene).img, r0.img)
    assert fleet.owner_of(scene) == owner0
    assert fleet.ring.version == version0
    stats = fleet.stats()
    assert stats["prefetches_total"] == 1 and stats["workers_alive"] == 2
    w = stats["workers"][owner0]
    assert w["device"] == "cpu" and w["revivals"] >= 2
    assert w["scene_dispatch_path"][scene] == "fused_ref"


@pytest.mark.fleet
def test_replicated_scene_is_bit_identical_across_replicas(fleet):
    scene = SCENES[1]
    fleet.set_replicas(scene, 2)
    replicas = fleet.replica_workers(scene)
    assert sorted(replicas) == ["w0", "w1"]
    imgs = []
    for worker in replicas:
        r = _render(fleet, scene, prefer_worker=worker)
        assert r.worker == worker and not r.timed_out
        imgs.append(r.img)
    np.testing.assert_array_equal(imgs[0], imgs[1])
    snap = fleet.registry.snapshot()["gauges"]
    assert snap[f"fleet_replicas{{scene={scene}}}"]["value"] == 2


@pytest.mark.fleet
def test_slow_worker_deadline_fires(fleet):
    scene = SCENES[2]
    owner = fleet.owner_of(scene)
    _render(fleet, scene)
    fleet.inject(owner, stall_s=1.0)
    try:
        r = fleet.submit(_cam(), scene=scene, deadline_s=0.05,
                         prefer_worker=owner).result(timeout=60.0)
        assert r.timed_out and r.img is None
    finally:
        fleet.inject(owner, stall_s=0.0)
    r2 = _render(fleet, scene, prefer_worker=owner)
    assert not r2.timed_out and r2.img is not None


@pytest.mark.fleet
def test_router_survives_a_sigkilled_worker(scenes, port_paths):
    router = _router(scenes, port_paths)
    try:
        scene = SCENES[0]
        victim = router.owner_of(scene)
        survivor = [w for w in router.alive_workers() if w != victim][0]
        baseline = _render(router, scene, prefer_worker=survivor)
        version0 = router.ring.version
        _render(router, scene, prefer_worker=victim)
        router.inject(victim, stall_s=5.0)
        live = [router.submit(_cam(), scene=scene, prefer_worker=victim)
                for _ in range(3)]
        expired = router.submit(_cam(), scene=scene, deadline_s=0.01,
                                prefer_worker=victim)
        time.sleep(0.5)
        os.kill(router.worker_pid(victim), signal.SIGKILL)
        for f in live:
            r = f.result(timeout=TIMEOUT_S)
            assert not r.timed_out and r.replayed and r.worker == survivor
            np.testing.assert_array_equal(r.img, baseline.img)
        rexp = expired.result(timeout=60.0)
        assert rexp.timed_out and rexp.img is None
        assert router.alive_workers() == [survivor]
        assert router.ring.version == version0 + 1
        stats = router.stats()
        assert stats["worker_deaths"] == 1 and stats["replays_total"] >= 3
        with pytest.raises(FleetError):
            router.submit(_cam(), scene=scene, prefer_worker=victim)
        assert router.owner_of(scene) == survivor
        np.testing.assert_array_equal(_render(router, scene).img,
                                      baseline.img)
    finally:
        router.close()
    assert not any(st.proc.is_alive() for st in router._workers.values())


def _fleet_families(snap):
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith("fleet_")}
            for kind in ("counters", "gauges", "histograms")}


@pytest.mark.fleet
def test_fleet_metric_families_are_the_references(scenes, port_paths,
                                                  tmp_path):
    cfg = scenes[SCENES[0]][0]
    jpaths = {name: jfleet.export_scene(str(tmp_path / name), cf, cubes,
                                        scene=name)
              for name, (_c, cf, cubes) in scenes.items()}
    jr = jrouter.FleetRouter(cfg, jpaths, n_workers=2,
                             engine_kwargs={"ray_chunk": RES * RES})
    tr = _router(scenes, port_paths)
    try:
        jcam = jrays.make_cameras(1, RES, RES)[0]
        for scene in SCENES[:2]:
            want = jr.submit(jcam, scene=scene).result(timeout=TIMEOUT_S)
            got = tr.submit(carry_camera(jcam),
                            scene=scene).result(timeout=TIMEOUT_S)
            assert got.worker == want.worker
            np.testing.assert_allclose(got.img, want.img, atol=1e-4)
        jr.set_replicas(SCENES[2], 2)
        tr.set_replicas(SCENES[2], 2)
        jr.poll_stats()
        tr.poll_stats()
        want = _fleet_families(jr.registry.snapshot())
        got = _fleet_families(tr.registry.snapshot())
        for kind in want:
            assert sorted(got[kind]) == sorted(want[kind]), kind
        for k, v in want["counters"].items():
            assert got["counters"][k]["value"] == v["value"], k
        for k in ("fleet_routing_version", "fleet_workers_alive",
                  f"fleet_replicas{{scene={SCENES[2]}}}"):
            assert got["gauges"][k]["value"] == want["gauges"][k]["value"]
    finally:
        jr.close()
        tr.close()
