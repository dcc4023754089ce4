"""The port's checkpoints (`repro_torch.ckpt`) against the reference's
(`repro.ckpt`): the same on-disk format both ways (manifest, leaf order,
crc), encoded fields restored bit for bit in either package, legacy
params-dict checkpoints, corruption, retention, the async manager,
`cfg_mismatches`, and the restore branch of `prepare_field`."""
import collections
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, carry_camera, carry_cubes, carry_field,
                           jax_case, n, t, torch_cfg)
from repro.ckpt import checkpoint as jckpt
from repro.core import field as jfield
from repro.core import occupancy as jocc
from repro.data import rays as jrays
from repro.serving import engine as jengine
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.core import field as tfield
from repro_torch.core import tensorf as ttensorf
from repro_torch.core import train as ttrain
from repro_torch.serving import RenderEngine
from repro_torch.serving import engine as tengine


@pytest.fixture(scope="module")
def case():
    cfg, cf, centers, cid, pts = jax_case(0.9, threshold=0.80)
    return cfg, cf, pts


def _same_state(a_field, b_field):
    """field_state of both (either package) has equal specs and bitwise
    equal arrays."""
    sa, aa = (tfield if isinstance(a_field, tfield.FieldBackend)
              else jfield).field_state(a_field)
    sb, ab = (tfield if isinstance(b_field, tfield.FieldBackend)
              else jfield).field_state(b_field)
    assert sa == sb
    assert sorted(aa) == sorted(ab)
    for k in aa:
        x, y = np.asarray(aa[k]), np.asarray(ab[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _tree_files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


# -- the format ----------------------------------------------------------------

NT = collections.namedtuple("NT", "a b")
TREES = {
    "dict": lambda: {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
                     "opt": {"m": np.ones(5, np.float32),
                             "step": np.int32(7)}},
    "nested": lambda: {"b": [np.zeros(2, np.float32),
                             (np.ones(3, np.int64), None)],
                       "a": None, "c": {"z": np.float32(2.5),
                                        "y": np.arange(4, dtype=np.uint32)}},
    "tuple": lambda: (np.ones(2, np.float32),),
    "namedtuple": lambda: NT(np.zeros(3, np.float32), [np.ones(1)]),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_flatten_order_and_treedef_match_jax(name):
    tree = TREES[name]()
    leaves, td = tckpt.flatten(tree)
    jleaves, jtd = jax.tree.flatten(tree)
    assert td == str(jtd)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tckpt.unflatten(tree, leaves)
    assert tckpt.flatten(back)[1] == td


@pytest.mark.parametrize("name", ["dict", "nested"])
def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path, name):
    """The same tree saved by both packages gives the same manifest and
    leaf files, byte for byte; each restores the other's."""
    tree = TREES[name]()
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 5, tree,
                                  extra_meta={"k": 1})
    tpath = tckpt.save_checkpoint(
        str(tmp_path / "t"), 5,
        jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree),
        extra_meta={"k": 1})
    assert os.path.basename(jpath) == os.path.basename(tpath) == \
        "step_00000005"
    assert _tree_files(jpath) == _tree_files(tpath)
    got = tckpt.restore_checkpoint(str(tmp_path / "j"), 5, tree,
                                   device=CPU)
    for a, b in zip(tckpt.flatten(got)[0], jax.tree.leaves(tree)):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = jckpt.restore_checkpoint(str(tmp_path / "t"), 5, tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_dict_interop_keeps_sorted_key_order(tmp_path):
    rng = np.random.RandomState(0)
    state = {k: rng.randn(3, 2).astype(np.float32) for k in ("zeta", "a/b",
                                                             "m", "A")}
    tckpt.save_state_dict(str(tmp_path / "t"), 2,
                          {k: torch.from_numpy(v) for k, v in state.items()})
    arrays, extra = jckpt.restore_state_dict(str(tmp_path / "t"), 2)
    assert extra["state_keys"] == sorted(state)
    for k in state:
        np.testing.assert_array_equal(np.asarray(arrays[k]), state[k])
    jckpt.save_state_dict(str(tmp_path / "j"), 2, state)
    arrays, _ = tckpt.restore_state_dict(str(tmp_path / "j"), 2)
    for k in state:
        np.testing.assert_array_equal(arrays[k], state[k])
    assert _tree_files(str(tmp_path / "j" / "step_00000002")) == \
        _tree_files(str(tmp_path / "t" / "step_00000002"))


# -- encoded fields, both directions --------------------------------------------


def test_reference_save_field_restores_in_the_port(tmp_path, case):
    cfg, cf, pts = case
    jckpt.save_field(str(tmp_path), 7, cf, extra_meta={"scene": "s"})
    got, extra = tckpt.restore_field(str(tmp_path), 7, torch_cfg(cfg),
                                     device=CPU)
    assert extra["scene"] == "s"
    assert isinstance(got, tfield.CompressedField)
    _same_state(got, cf)
    np.testing.assert_allclose(n(got.sigma(t(pts))), np.asarray(cf.sigma(
        jnp.asarray(pts))), atol=1e-5)
    np.testing.assert_allclose(n(got.app_features(t(pts))), np.asarray(
        cf.app_features(jnp.asarray(pts))), atol=1e-5)


def test_port_spill_unspills_in_the_reference(tmp_path, case):
    cfg, cf, pts = case
    tf = carry_field(cf, cfg)
    tckpt.spill_field(str(tmp_path), tf, extra_meta={"scene": "s"})
    assert tckpt.latest_steps(str(tmp_path)) == [tckpt.SPILL_STEP]
    back, extra = jckpt.unspill_field(str(tmp_path), cfg)
    assert extra["scene"] == "s"
    _same_state(back, tf)
    np.testing.assert_allclose(np.asarray(back.sigma(jnp.asarray(pts))),
                               n(tf.sigma(t(pts))), atol=1e-5)
    # and the port's own round trip
    again, _ = tckpt.unspill_field(str(tmp_path), torch_cfg(cfg), device=CPU)
    _same_state(again, tf)


def test_dense_field_round_trips_both_ways(tmp_path, case):
    cfg, cf, _ = case
    dense = cf.decode()
    jckpt.save_field(str(tmp_path / "j"), 1, dense)
    got, _ = tckpt.restore_field(str(tmp_path / "j"), 1, torch_cfg(cfg),
                                 device=CPU)
    assert isinstance(got, tfield.DenseField)
    _same_state(got, dense)
    tckpt.save_field(str(tmp_path / "t"), 1, got)
    back, _ = jckpt.restore_field(str(tmp_path / "t"), 1, cfg)
    _same_state(back, dense)


def test_restore_field_of_a_params_checkpoint_raises(tmp_path, case):
    cfg, cf, _ = case
    tckpt.save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="not a state-dict"):
        tckpt.restore_field(str(tmp_path), 0, torch_cfg(cfg), device=CPU)
    tckpt.save_state_dict(str(tmp_path / "sd"), 0, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="no field_spec"):
        tckpt.restore_field(str(tmp_path / "sd"), 0, torch_cfg(cfg),
                            device=CPU)


# -- integrity, retention, async -------------------------------------------------


def _tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones(5), "step": torch.tensor(7,
                                                           dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    tr = _tree()
    tckpt.save_checkpoint(str(tmp_path), 3, tr)
    like = {"w": torch.zeros(3, 4), "opt": {"m": torch.zeros(5),
                                            "step": torch.zeros(())}}
    got = tckpt.restore_checkpoint(str(tmp_path), 3, like, device=CPU)
    assert list(got) == list(like)
    for a, b in zip(tckpt.flatten(tr)[0], tckpt.flatten(got)[0]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leaf count"):
        tckpt.restore_checkpoint(str(tmp_path), 3, {"w": 0}, device=CPU)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_corrupted_leaf_raises_ioerror(tmp_path, writer):
    tree = TREES["dict"]()
    if writer == "port":
        tckpt.save_checkpoint(str(tmp_path), 1, tree)
    else:
        jckpt.save_checkpoint(str(tmp_path), 1, tree)
    leaf = os.path.join(str(tmp_path), "step_00000001", "leaf_00000.npy")
    arr = np.load(leaf)
    arr.reshape(-1)[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="corruption"):
        tckpt.restore_checkpoint(str(tmp_path), 1, tree, device=CPU)


def test_corrupted_field_leaf_raises_ioerror(tmp_path, case):
    cfg, cf, _ = case
    jckpt.spill_field(str(tmp_path), cf)
    path = os.path.join(str(tmp_path), "step_00000000")
    man = json.load(open(os.path.join(path, "manifest.json")))
    i = man["extra"]["state_keys"].index("extras/basis")
    leaf = os.path.join(path, f"leaf_{i:05d}.npy")
    arr = np.load(leaf)
    arr.reshape(-1)[3] *= -1
    np.save(leaf, arr)
    with pytest.raises(IOError, match=f"leaf {i}"):
        tckpt.unspill_field(str(tmp_path), torch_cfg(cfg), device=CPU)


def test_retention_keeps_last_k(tmp_path):
    for s in range(6):
        tckpt.save_checkpoint(str(tmp_path), s, _tree(), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [4, 5]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_no_partial_checkpoint_visible(tmp_path):
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert tckpt.latest_step(str(tmp_path)) is None
    tckpt.save_checkpoint(str(tmp_path), 2, _tree())
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert tckpt.latest_steps(str(tmp_path / "missing")) == []


def test_no_tmp_visible_while_saving(tmp_path, monkeypatch):
    """A reader listing the directory during a save sees no `.tmp` step
    and never a step without its manifest."""
    seen = []
    real_save = np.save

    def spy(fn, arr, *a, **kw):
        seen.append((tckpt.latest_steps(str(tmp_path)), sorted(
            d for d in os.listdir(tmp_path) if not d.endswith(".tmp"))))
        return real_save(fn, arr, *a, **kw)

    monkeypatch.setattr(tckpt.np, "save", spy)
    tckpt.save_checkpoint(str(tmp_path), 1, _tree())
    tckpt.save_checkpoint(str(tmp_path), 2, _tree())
    assert seen[0] == ([], [])
    assert all(steps in ([], [1]) for steps, _ in seen)
    for s in tckpt.latest_steps(str(tmp_path)):
        assert tckpt.read_manifest(str(tmp_path), s)["step"] == s


def test_async_manager_snapshots_before_the_thread(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tr = _tree()
    for s in (0, 1, 2):
        mgr.save_async(s, tr)
        tr["w"] += 1.0                 # the save holds a host copy
    mgr.wait(timeout=30)
    step, got = mgr.restore_latest(tr, device=CPU)
    assert step == 2
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(12.0).reshape(3, 4) + 2.0)
    assert tckpt.latest_steps(str(tmp_path)) == [1, 2]
    assert tckpt.CheckpointManager(str(tmp_path / "e")).restore_latest(
        tr, device=CPU) == (None, None)


def test_async_manager_surfaces_thread_error_on_wait(tmp_path, monkeypatch):
    started = threading.Event()

    def boom(*a, **kw):
        started.set()
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_checkpoint", boom)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save_async(0, _tree())
    assert started.wait(10)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait(timeout=10)
    mgr.wait(timeout=10)               # the error is raised once


# -- cfg_mismatches and prepare_field --------------------------------------------


def test_cfg_mismatches_match_reference_strings(case):
    cfg, cf, _ = case
    tcfg = torch_cfg(cfg)
    wider = dataclasses.replace(cfg, grid_res=20, mlp_hidden=24)
    for field in (cf, cf.decode()):
        tf = carry_field(field, cfg)
        assert tfield.cfg_mismatches(tf, tcfg) == \
            jfield.cfg_mismatches(field, cfg) == []
        want = jfield.cfg_mismatches(field, wider)
        assert want and tfield.cfg_mismatches(tf, torch_cfg(wider)) == want
    params = {k: v for k, v in carry_field(cf.decode(), cfg).params.items()
              if k != "basis"}
    jparams = {k: jnp.asarray(n(v)) for k, v in params.items()}
    assert tfield.cfg_mismatches(params, tcfg) == \
        jfield.cfg_mismatches(jparams, cfg) == ["basis: missing from field"]


def test_field_shapes_are_init_fields_shapes(case):
    cfg, _, _ = case
    tcfg = torch_cfg(cfg)
    params = ttensorf.init_field(tcfg, torch.Generator().manual_seed(0),
                                 device=CPU)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        ttensorf.field_shapes(tcfg)


def _write_meta(d, scene):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, tengine.FIELD_META), "w") as f:
        json.dump({"scene": scene, "steps": 3, "seed": 0, "grid_res": 24}, f)


def test_prepare_field_restores_both_formats(tmp_path, case):
    cfg, cf, _ = case
    tcfg = torch_cfg(cfg)
    enc = str(tmp_path / "enc")
    _write_meta(enc, "lego")
    jckpt.save_field(enc, 3, cf)
    got = tengine.prepare_field(tcfg, "lego", ckpt_dir=enc, device=CPU,
                                verbose=False)
    _same_state(got, cf)
    want = jengine.prepare_field(cfg, "lego", ckpt_dir=enc, verbose=False)
    _same_state(got, want)
    # legacy: a raw params dict, no state keys -> restored dense
    leg = str(tmp_path / "legacy")
    _write_meta(leg, "lego")
    dense = cf.decode()
    jckpt.save_checkpoint(leg, 3, dict(dense.params))
    got = tengine.prepare_field(tcfg, "lego", ckpt_dir=leg, device=CPU,
                                verbose=False)
    assert isinstance(got, tfield.DenseField)
    _same_state(got, dense)
    assert isinstance(jengine.prepare_field(cfg, "lego", ckpt_dir=leg,
                                            verbose=False),
                      jfield.DenseField)


def test_prepare_field_checks(tmp_path, case, monkeypatch):
    cfg, cf, _ = case
    tcfg = torch_cfg(cfg)
    d = str(tmp_path / "c")
    # no checkpoint: train (stubbed here; tests/test_torch_train.py runs
    # the real branch), checkpoint, and restore on the next call
    calls = []

    def fake_train(cfg_, scene, **kw):
        calls.append((scene, kw["steps"], kw["seed"], kw["device"]))
        return ttrain.TrainResult(carry_field(cf, cfg), None, [])
    monkeypatch.setattr(tengine.train_lib, "train_nerf", fake_train)
    t = str(tmp_path / "t")
    for ckpt in (t, None, t):
        _same_state(tengine.prepare_field(tcfg, "lego", ckpt_dir=ckpt,
                                          train_steps=3, seed=5, device=CPU,
                                          verbose=False), cf)
    assert calls == [("lego", 3, 5, CPU)] * 2
    jckpt.save_field(d, 3, cf)
    with pytest.raises(ValueError, match="field_meta.json"):
        tengine.prepare_field(tcfg, "lego", ckpt_dir=d, device=CPU)
    _write_meta(d, "chair")
    with pytest.raises(ValueError, match="holds scene 'chair'"):
        tengine.prepare_field(tcfg, "lego", ckpt_dir=d, device=CPU)
    wider = dataclasses.replace(tcfg, mlp_hidden=24)
    with pytest.raises(ValueError, match="different NeRFConfig"):
        tengine.prepare_field(wider, "chair", ckpt_dir=d, device=CPU,
                              verbose=False)


def test_from_scenes_restores_and_serves_like_the_field(tmp_path, case):
    cfg, cf, _ = case
    tcfg = torch_cfg(cfg)
    for s in ("a", "b"):
        _write_meta(str(tmp_path / s), s)
        jckpt.save_field(str(tmp_path / s), 3, cf)
    eng = RenderEngine.from_scenes(tcfg, ["a", "b"], ckpt_root=str(tmp_path),
                                   device=CPU, verbose=False, ray_chunk=256)
    assert eng.store.scenes() == ["a", "b"]
    cam = carry_camera(jrays.make_cameras(3, 16, 16)[0])
    want_cubes = jocc.extract_cubes(jocc.build_occupancy(cf, cfg), cfg)
    ref = RenderEngine(tcfg, carry_field(cf, cfg), carry_cubes(want_cubes),
                       device=CPU, ray_chunk=256).submit(cam).result()
    for s in ("a", "b"):
        np.testing.assert_array_equal(eng.submit(cam, scene=s).result().img,
                                      ref.img)
    one = RenderEngine.from_scene(tcfg, "a", ckpt_dir=str(tmp_path / "a"),
                                  device=CPU, verbose=False, ray_chunk=256)
    assert one.default_scene == "a"
    np.testing.assert_array_equal(one.submit(cam).result().img, ref.img)
    with pytest.raises(ValueError, match="at least one"):
        RenderEngine.from_scenes(tcfg, [], device=CPU)
