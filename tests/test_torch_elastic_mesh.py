"""LM training across ranks with the elastic runner's remesh, and
checkpoints of placed state, against the reference. Spawned CPU gloo
worlds (`_torch_mesh_ranks.elastic_job`): 4 ranks (meshes 2 x 2 over the
world, 1 x 2 and 2 x 1 over ranks 0 and 1; the runner at model_axis 2)
and 2 ranks (2 x 1 and 1 x 2 over the world; the runner at model_axis
1). Reduced llama3.2-1b in float32 on the reference's params
(`_lm_parity.family_params`) and TokenStream batches of (4, 16).

(a) Params and AdamW state after one step on each mesh, saved by the
manager and by `save_checkpoint`: the files equal, byte for byte, a
one-process save of the same whole values, the reference's
`restore_checkpoint` reads them back bit for bit, and only the mesh's
rank 0 writes. (b) Each of those checkpoints, a one-process one and a
float32 one written by the reference restore onto every mesh, each leaf
bit for bit `sharding.place` of its whole value with the `like` leaf's
placements, and onto one process. (c) `ElasticRunner` with a failure at
step 3, a checkpoint every 2 steps, 6 steps: the kinds and steps of the
events equal the reference's runner's on one device, the remesh counts
are 4 -> 2 and 2 -> 1, the dropped ranks exit 0 with (None, log), the
survivors' final params lie within float32 1e-4 of each leaf's largest
of the reference's run (params held by the AdamW bound of
`_lm_parity.close_adamw_first_step`, the lr summed over the steps), and
in the 2 -> 1 world the survivor's steps after the restore equal, bit
for bit, one process resumed from a copy of the same checkpoint. (d) A
one-process checkpoint resumed on 2 ranks, and 2 x 1 and 2 x 2 ones by
one process, each logging ("restore", step, ranks). (e) The launcher
under a torchrun environment on two CPU ranks."""
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from _lm_parity import carry_batch, family_params, leaf_items
from _train_bounds import adamw_first_step_excess
from repro import optim as joptim
from repro.ckpt import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig
from repro.data.tokens import TokenStream
from repro.launch import elastic as jelastic
from repro.launch import steps as jsteps
from repro.models.sharding import make_rules as jrules
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.launch import elastic as telastic

ARCH = "llama3.2-1b"
B, S = 4, 16
SEED = 0
TOL = 1e-4
ADAMW_B1, ADAMW_EPS = 0.9, 1e-8        # adamw's defaults
WORLDS = {
    "4": {"world": 4, "model_axis": 2,
          "meshes": {"2x2": ((0, 1, 2, 3), 2), "1x2": ((0, 1), 2),
                     "2x1": ((0, 1), 1)}},
    "2": {"world": 2, "model_axis": 1,
          "meshes": {"2x1": ((0, 1), 1), "1x2": ((0, 1), 2)},
          "resume_check": True},
}
MESHES = [(w, m) for w, spec in WORLDS.items() for m in spec["meshes"]]
# each mesh's shape and the ranks it holds
MESH_RANKS = {(w, m): r for w, spec in WORLDS.items()
              for m, (r, _) in spec["meshes"].items()}
RESTORE_KEYS = ("one", "ref")
TRAIN_ARGS = ["--arch", ARCH, "--steps", "4", "--batch", "2", "--seq", "16",
              "--device", "cpu"]


def _reference_state(jcfg, batch):
    """The reference's params and AdamW state after one jitted step."""
    opt = ranks.elastic_opt(joptim)
    jp = jax.tree.map(jnp.asarray, family_params(jcfg, SEED))
    fn = jax.jit(jsteps.build_train_step(jcfg, jrules(
        jelastic.make_mesh_from(jax.devices()[:1], 1)), opt))
    p1, s1, _ = fn(jp, opt.init(jp), batch)
    return p1, s1


def _reference_run(jcfg, stream, tmp):
    """The reference's runner on one device: its log and final params."""
    opt = ranks.elastic_opt(joptim)
    np_params = family_params(jcfg, SEED)

    def build(mesh):
        fn = jax.jit(jsteps.build_train_step(jcfg, jrules(mesh), opt))
        params = jax.tree.map(jnp.asarray, np_params)

        def step_fn(state, batch):
            p, s, m = fn(*state, batch)
            return (p, s), m
        return step_fn, (params, opt.init(params)), None

    (params, state), log = jelastic.ElasticRunner(
        build, str(tmp), ckpt_every=ranks.ELASTIC_CKPT_EVERY).run(
        ranks.ELASTIC_STEPS, stream.batch,
        inject_failure_at=ranks.ELASTIC_FAIL_AT)
    return log, params, state


def _torch_tree(tree):
    """A tree of numpy (or jax) leaves as CPU tensors."""
    flat, _ = tckpt.flatten(tree)
    return tckpt.unflatten(tree, [torch.from_numpy(np.array(a))
                                  for a in flat])


def _files(path):
    return {f: (Path(path) / f).read_bytes()
            for f in sorted(os.listdir(path))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp):
    """(e) `python -m repro_torch.launch.train` as two torchrun ranks on
    the CPU (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), started."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--inject-failure", "2", "--ckpt-dir", str(tmp / "launch")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds and the torchrun launcher run while this process
    computes the reference's runner; then the one-process resumes."""
    tmp = tmp_path_factory.mktemp("elastic_mesh")
    jcfg = jreg.reduced(jreg.ARCHS[ARCH])
    stream = TokenStream(jcfg, ShapeConfig("t", S, B, "train"))
    batches = [{k: v.numpy() for k, v in carry_batch(stream.batch(s)).items()}
               for s in range(ranks.ELASTIC_STEPS)]
    ref_state = _reference_state(jcfg, stream.batch(0))
    dirs = {"one": str(tmp / "one"), "ref": str(tmp / "ref")}
    tckpt.save_checkpoint(dirs["one"], 1, _torch_tree(ref_state))
    jckpt.save_checkpoint(dirs["ref"], 1, ref_state)
    params = family_params(jcfg, SEED)
    started = {}
    for key, spec in WORLDS.items():
        wdir = tmp / f"w{key}"
        wdir.mkdir()
        started[key] = ranks.start(ranks.elastic_job, spec["world"], wdir, {
            "tmp": str(wdir), "params": params, "batches": batches,
            "model_axis": spec["model_axis"], "meshes": spec["meshes"],
            "restore_dirs": dirs, "resume_check": spec.get("resume_check"),
            "resume_dir": dirs["one"] if key == "2" else None})
    launch = _launch(tmp)
    try:
        want = _reference_run(jcfg, stream, tmp / "jrun")
    finally:
        out = {k: ranks.join(s, timeout_s=240.0) for k, s in started.items()}
        launched = []
        for proc in launch:
            try:
                launched.append((*proc.communicate(timeout=240),
                                 proc.returncode))
            finally:
                proc.kill()
    # (d) checkpoints written on 2 x 1 and 2 x 2 (the runs' step 2, before
    # the failure) resumed by one process
    payload = {"params": params, "batches": batches, "model_axis": 1}
    one_process = {}
    for key in WORLDS:
        d = tmp / f"one_process_{key}"
        shutil.copytree(tmp / f"w{key}" / "run" / "step_00000002",
                        d / "step_00000002")
        _, one_process[key] = telastic.ElasticRunner(
            ranks._elastic_build(payload), str(d),
            ckpt_every=ranks.ELASTIC_CKPT_EVERY, device="cpu").run(
            ranks.ELASTIC_STEPS, ranks._batches(payload),
            devices=[torch.device("cpu")])
    return {"tmp": tmp, "ranks": out, "want": want, "ref_state": ref_state,
            "dirs": dirs, "launched": launched, "one_process": one_process}


def _rank0(run, world):
    return run["ranks"][world][0]


def _events(log):
    return [e[:2] for e in log if e[0] != "straggler"]


# -- (a) the checkpoint files --------------------------------------------------


@pytest.mark.parametrize("world,mesh", MESHES)
def test_placed_checkpoint_files_are_one_processes(run, world, mesh):
    """The manager's and `save_checkpoint`'s files of state placed on the
    mesh equal, byte for byte, a one-process save of the same whole
    values; only the mesh's rank 0 writes."""
    saved = _rank0(run, world)["saved"][mesh]
    one = run["tmp"] / f"one_{world}_{mesh}"
    tckpt.save_checkpoint(str(one), 1, _torch_tree(saved["whole"]))
    want = _files(one / "step_00000001")
    assert _files(Path(saved["manager"]) / "step_00000001") == want
    assert _files(Path(saved["direct"]) / "step_00000001") == want
    assert saved["direct_returned"] == os.path.join(saved["direct"],
                                                    "step_00000001")
    for r in MESH_RANKS[(world, mesh)][1:]:
        other = run["ranks"][world][r]["saved"][mesh]
        assert other["direct_returned"] is None
        assert "bytes" not in other["timings"][0]
        assert not os.listdir(run["tmp"] / f"w{world}" / f"rank{r}")
    assert saved["timings"][0]["bytes"] == sum(
        np.load(one / "step_00000001" / n).nbytes for n in want
        if n.endswith(".npy"))


@pytest.mark.parametrize("world,mesh", MESHES)
def test_reference_reads_placed_checkpoint_bit_for_bit(run, world, mesh):
    """`repro.ckpt.restore_checkpoint` reads the placed state's files back
    as the whole values, bit for bit and in their dtypes."""
    saved = _rank0(run, world)["saved"][mesh]
    like = run["ref_state"]
    got = jckpt.restore_checkpoint(saved["manager"], 1, like)
    flat_got = jax.tree.leaves(got)
    flat_want, _ = tckpt.flatten(saved["whole"])
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- (b) restore across meshes -------------------------------------------------


@pytest.mark.parametrize("world,mesh", MESHES)
def test_checkpoints_restore_onto_the_mesh_as_placed(run, world, mesh):
    """A checkpoint from every mesh of the world, a one-process one and a
    float32 one written by the reference restore onto the mesh on each of
    its ranks: each leaf equals `sharding.place` of its whole value with
    the like leaf's placements, bit for bit, at the step saved."""
    keys = set(RESTORE_KEYS) | {f"save_{m}" for m in WORLDS[world]["meshes"]}
    for r in MESH_RANKS[(world, mesh)]:
        restored = run["ranks"][world][r]["restored"][mesh]
        assert set(restored) == keys
        for key, res in restored.items():
            assert (res["step"], res["differ"]) == (1, []), (r, key)
            assert res["leaves"] == len(tckpt.flatten(run["ref_state"])[0])
    for r in range(WORLDS[world]["world"]):
        if r not in MESH_RANKS[(world, mesh)]:
            assert mesh not in run["ranks"][world][r]["restored"]


@pytest.mark.parametrize("world,mesh", MESHES)
def test_placed_checkpoint_restores_onto_one_process(run, world, mesh):
    """State saved on the mesh restores onto one process (plain like
    leaves) as its whole values, bit for bit."""
    saved = _rank0(run, world)["saved"][mesh]
    like = _torch_tree(run["ref_state"])
    step, got = tckpt.CheckpointManager(saved["manager"]).restore_latest(
        like, device="cpu")
    assert step == 1
    for g, w in zip(tckpt.flatten(got)[0], tckpt.flatten(saved["whole"])[0]):
        assert not telastic_is_dtensor(g)
        assert torch.equal(g, torch.from_numpy(np.array(w)))


def telastic_is_dtensor(x):
    from repro_torch.models.sharding import is_dtensor
    return is_dtensor(x)


def test_meshes_over_some_ranks_are_live_on_them_only(run):
    """`make_mesh_from` on ranks 0 and 1 of a world of 4 gives the live
    sub-mesh there (ranks (0, 1), each its place), and to ranks 2 and 3
    the same mesh with `member` False; the world's ranks give the world
    mesh."""
    for r, res in enumerate(run["ranks"]["4"]):
        m = res["meshes"]
        assert m["2x2"] == ({"data": 2, "model": 2}, (0, 1, 2, 3), True, r)
        for name, shape in (("1x2", {"data": 1, "model": 2}),
                            ("2x1", {"data": 2, "model": 1})):
            assert m[name] == (shape, (0, 1), r < 2, r if r < 2 else None)


# -- (c) the runner against the reference --------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_runner_logs_the_references_events(run, world):
    """The survivors' events (kinds and steps) are the reference's
    runner's on one device; the remesh counts 4 -> 2 and 2 -> 1; the
    dropped ranks log the steps and the failure, and return no state."""
    want, _, _ = run["want"]
    n = WORLDS[world]["world"]
    kept = max(n // 2, 1)
    assert _events(want) == [
        ("step", 0), ("step", 1), ("step", 2), ("failure", 3),
        ("remesh", 3), ("step", 3), ("step", 4), ("step", 5)]
    for r, res in enumerate(run["ranks"][world]):
        log = [e for e in res["log"] if e[0] != "straggler"]
        if r < kept:
            assert res["survivor"]
            assert _events(log) == _events(want)
            assert [e[2] for e in log if e[0] == "remesh"] == [kept]
            assert [e[2] for e in log if e[0] == "failure"] == [
                "injected loss at step 3"]
        else:
            assert not res["survivor"]
            assert _events(log) == _events(want)[:4]


@pytest.mark.parametrize("world", list(WORLDS))
def test_runner_builds_the_survivors_mesh(run, world):
    """The runner builds on the world's mesh, then the survivors build on
    theirs: (2, 2) then (1, 2) over ranks 0 and 1, or (2, 1) then one
    rank; each survivor restores the checkpoint of step 2 from the
    mesh's rank 0."""
    n, axis = WORLDS[world]["world"], WORLDS[world]["model_axis"]
    first = ({"data": n // axis, "model": axis}, tuple(range(n)))
    second = {"4": ({"data": 1, "model": 2}, (0, 1)),
              "2": ({"data": 1, "model": 1}, (0,))}[world]
    for r, res in enumerate(run["ranks"][world]):
        assert res["built"] == ([first, second] if res["survivor"]
                                else [first])
        restores = [t for t in res["timings"] if t["what"] == "restore"]
        assert [t["step"] for t in restores] == (
            [2] if res["survivor"] else [])


@pytest.mark.parametrize("world", list(WORLDS))
def test_runner_final_params_match_the_reference(run, world):
    """The survivors' final params lie within float32 1e-4 of each leaf's
    largest of the reference's final params, beyond which AdamW's
    near-sign steps may move a param whose gradient sits at the
    gradients' error: the first-step bound with the lr of every step
    (ROADMAP.md Queue 3 item 25)."""
    _, jp, js = run["want"]
    got = _rank0(run, world)["final_params"]
    lr = ranks.ELASTIC_LR * ranks.ELASTIC_STEPS
    for (path, w, g), m in zip(leaf_items(jp, got), jax.tree.leaves(js["m"])):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        excess = adamw_first_step_excess(g, w, np.asarray(m), lr, ADAMW_B1,
                                         ADAMW_EPS, TOL)
        assert excess <= 1.0, f"{path}: {excess} of the bound"


def test_survivor_resumes_as_one_process_bit_for_bit(run):
    """In the 2 -> 1 world the survivor's steps after the restore, and its
    final checkpoint, equal one process resumed from a copy of the same
    checkpoint, bit for bit."""
    res = _rank0(run, "2")
    resume = res["resume"]
    assert resume["restored"] == 2
    one = [e for e in resume["log"] if e[0] != "straggler"]
    assert one[0] == ("restore", 2, 1)
    after = [e for e in res["log"] if e[0] == "step"
             and e[1] > resume["restored"]]
    assert [e for e in one if e[0] == "step"] == after
    assert len(after) == ranks.ELASTIC_STEPS - 3
    assert resume["files_equal"]


# -- (d) resume across worlds --------------------------------------------------


def test_one_process_checkpoint_resumes_on_two_ranks(run):
    """A one-process checkpoint (step 1) resumed by the 2 ranks: both log
    ("restore", 1, 2) and the steps after it."""
    for res in run["ranks"]["2"]:
        log = [e for e in res["resumed_world"] if e[0] != "straggler"]
        assert log[0] == ("restore", 1, 2)
        assert [e[1] for e in log[1:]] == list(range(2, ranks.ELASTIC_STEPS))
        assert all(np.isfinite(e[2]) for e in log[1:])


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_checkpoint_resumes_on_one_process(run, world):
    """The runs' step 2, written on 2 x 2 or 2 x 1 before the failure,
    resumed by one process: ("restore", 2, 1), then steps 3 to 5, each
    loss within 1e-5 of the survivors'."""
    log = [e for e in run["one_process"][world] if e[0] != "straggler"]
    assert log[0] == ("restore", 2, 1)
    steps = [e for e in log if e[0] == "step"]
    survivor = [e for e in _rank0(run, world)["log"] if e[0] == "step"
                and e[1] > 2]
    assert [e[1] for e in steps] == [e[1] for e in survivor] == [3, 4, 5]
    np.testing.assert_allclose([e[2] for e in steps],
                               [e[2] for e in survivor], rtol=1e-5)


# -- (e) the launcher under torchrun -------------------------------------------


def test_launcher_trains_under_torchrun_and_remeshes(run):
    """Two CPU ranks under a torchrun environment, `--inject-failure 2`:
    both exit 0, rank 0 alone prints the device, trained-steps, loss and
    event lines, the remesh onto one rank."""
    (out0, err0, rc0), (out1, err1, rc1) = run["launched"]
    assert rc0 == 0, err0[-3000:]
    assert rc1 == 0, err1[-3000:]
    lines = out0.splitlines()
    assert lines[0] == "[train] device: cpu"
    assert re.match(r"trained 5 steps in [\d.]+s \([\d.]+s/step\)$",
                    lines[1])
    assert re.match(r"loss: first=[\d.]+ last=[\d.]+$", lines[2])
    assert lines[3:] == ["event: ('failure', 2, 'injected loss at step 2')",
                         "event: ('remesh', 1, 1)"]
    assert out1 == ""
    assert tckpt.latest_steps(str(run["tmp"] / "launch")) == [0, 3]
