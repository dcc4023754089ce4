"""The port's serving launcher (`python -m repro_torch.launch.serve`)
against the reference's (`repro.launch.serve`). `--arch rtnerf`, on a
checkpoint the reference wrote at the launcher's `NeRFConfig`: the scene
line equal exactly and every view's PSNR within 0.01 dB, on one process
and through the fleet (marked `fleet`: it spawns worker processes). The
language-model path: the reference's greedy tokens on its own params and
prompt in float32 (exact) for llama3.2-1b and the five archs beyond the
dense trunk, and each dense arch served. The flags the reference
refuses, the port refuses alike. The training launcher
(`python -m repro_torch.launch.train`) and its elastic runner: the
reference's straggler flags and event log (float32 params, losses within
1e-5), recovery from the port's own bf16 checkpoint with the losses of
an uninterrupted run exactly, resume, and a step's own errors
propagating."""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.rtnerf import NeRFConfig as JaxConfig
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import prepare_field as jprepare_field
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf

SCENE = "lego"
ARGS = ["--arch", "rtnerf", "--scene", SCENE, "--views", "1", "--res", "16"]
PSNR_DB = 0.01


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    """The reference's launcher checkpoint: 2 training steps at the
    launcher's config, saved where `--ckpt-dir` looks for the scene."""
    root = tmp_path_factory.mktemp("launch_ckpt")
    cfg = JaxConfig(**dataclasses.asdict(tserve.launcher_config(None)))
    jprepare_field(cfg, SCENE, ckpt_dir=str(root / SCENE), train_steps=2,
                   n_views=8, image_hw=16, verbose=False)
    return str(root)


def _reference(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    return capsys.readouterr().out


def _port(capsys, argv):
    tserve.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _scene_line(out):
    return [ln for ln in out.splitlines() if ln.startswith("scene '")]


def _psnrs(out):
    return [float(x) for x in re.findall(r"view \d+: psnr=([-\d.]+)", out)]


def test_launcher_config_is_the_references():
    src = open(jserve.__file__).read()
    for field in ("grid_res=48", "occ_res=48", "cube_size=4",
                  "max_cubes=1024", "r_sigma=8", "r_color=16", "app_dim=12",
                  "mlp_hidden=32", "max_samples_per_ray=128",
                  "train_rays=1024"):
        assert src.count(field) == 2, field      # both of its paths
        key, value = field.split("=")
        assert getattr(tserve.launcher_config(None), key) == int(value)
    assert tserve.launcher_config(2).max_resident_bytes == 2 * 1024 * 1024
    assert tserve.launcher_config(0).max_resident_bytes is None


def test_port_launcher_serves_the_references_checkpoint(monkeypatch, capsys,
                                                         ckpt_root):
    argv = ARGS + ["--ckpt-dir", ckpt_root]
    want = _reference(monkeypatch, capsys, argv)
    got = _port(capsys, argv)
    assert "[serve] device: cpu" in got
    assert f"[engine] restoring scene '{SCENE}'" in got
    assert _scene_line(got) == _scene_line(want) and _scene_line(got)
    assert len(_psnrs(got)) == len(_psnrs(want)) == 1
    for g, w in zip(_psnrs(got), _psnrs(want)):
        assert abs(g - w) <= PSNR_DB, (g, w)
    assert re.search(r"served 1 views over 1 scenes, [\d.]+ FPS \(cpu\)",
                     got)


@pytest.mark.fleet
def test_port_fleet_launcher_serves_the_references_checkpoint(
        monkeypatch, capsys, ckpt_root):
    argv = ARGS + ["--ckpt-dir", ckpt_root, "--fleet-workers", "2",
                   "--fleet-replicas", "2"]
    want = _reference(monkeypatch, capsys, ARGS + ["--ckpt-dir", ckpt_root])
    got = _port(capsys, argv)
    assert "hot scene 'lego' replicated on ['w0', 'w1']" in got
    assert re.search(r"w\d: views=1 fps=[\d.]+ device=cpu", got)
    assert len(_psnrs(got)) == len(_psnrs(want)) == 1
    for g, w in zip(_psnrs(got), _psnrs(want)):
        assert abs(g - w) <= PSNR_DB, (g, w)


def test_fleet_with_finetune_exits_as_the_reference(monkeypatch, capsys):
    argv = ARGS + ["--fleet-workers", "2", "--finetune-steps", "5"]
    with pytest.raises(SystemExit) as want:
        _reference(monkeypatch, capsys, argv)
    with pytest.raises(SystemExit) as got:
        _port(capsys, argv)
    assert str(got.value) == str(want.value)
    assert "does not combine with --finetune-steps" in str(got.value)


OTHER_ARCHS = ("deepseek-v3-671b", "grok-1-314b", "zamba2-7b",
               "rwkv6-1.6b", "seamless-m4t-large-v2")


def test_other_archs_exit_with_a_message(capsys):
    """The flags the reference refuses, the port refuses alike, and the
    LM path without --device needs a card. The five archs beyond the
    dense trunk, which once raised here, serve with `--device cpu
    --reduced`: on the reference's params (its PRNGKey(0) init), prompt
    and encoder frames carried across in float32, their greedy tokens
    equal the reference's."""
    for argv in (["--arch", "llama3.2-1b", "--fleet-workers", "2"],
                 ["--arch", "gpt-5"]):
        with pytest.raises(SystemExit) as e:
            tserve.main(argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--fleet-workers requires --arch rtnerf" in err
    assert "invalid choice: 'gpt-5'" in err
    B, P, G = 2, 8, 5
    for arch in OTHER_ARCHS:
        cfg = jreg.reduced(jreg.ARCHS[arch])
        key = jax.random.PRNGKey(0)
        params, _ = jcommon.split_pl(jtf.init_model(cfg, key))
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        tokens = jax.random.randint(key, (B, P), 0, cfg.vocab)
        frames = (jax.random.normal(key, (B, P, cfg.d_model), jnp.bfloat16)
                  if cfg.enc_dec else None)
        want = _reference_greedy(cfg, params, tokens, G, frames)
        args = tserve.build_parser().parse_args(
            ["--arch", arch, "--reduced", "--device", "cpu", "--batch",
             str(B), "--prompt-len", str(P), "--gen", str(G)])
        got = tserve.serve_lm(
            args, params=ttf.params_from_numpy(
                jax.tree.map(np.asarray, params), device="cpu",
                dtype=torch.float32),
            tokens=torch.from_numpy(np.array(tokens)),
            enc_frames=(None if frames is None else torch.from_numpy(
                np.array(frames, np.float32)).to(torch.bfloat16)))
        out = capsys.readouterr().out
        np.testing.assert_array_equal(got.numpy(), want, err_msg=arch)
        assert "[serve] device: cpu" in out
        assert f"sample: {want[0, :12].tolist()}" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--arch", "llama3.2-1b"])


def _reference_greedy(cfg, params, tokens, gen, frames=None):
    """The reference launcher's prefill + greedy decode loop (its
    `serve_lm`, src/repro/launch/serve.py:32-75) on float32 params,
    without its axis rules: with jax 0.9 its host mesh's Explicit axes
    refuse the rules' UNCONSTRAINED activation specs, so the reference
    launcher itself fails here (ROADMAP.md Queue 3); without rules its
    `shard_act` constrains nothing, as in its own model tests. The cache
    is padded in prefill's dtype (its `fit` casts to the spec's bf16,
    which float32 K/V rows cannot be written into). An enc-dec arch's
    prefill runs op by op: jitted, the reference's encoder scan refuses
    the float32 carry that its bf16 frames promote to (Queue 3 item
    18)."""
    B, P = tokens.shape
    total = P + gen
    prefill = jax.jit(lambda p, b: jtf.model_prefill(p, cfg, b))
    decode = jax.jit(lambda p, t, pos, c: jtf.model_decode(
        p, cfg, t, pos, c, seq_len=total))
    batch = {"tokens": tokens}
    if frames is not None:
        batch["enc_frames"] = frames
        with jax.disable_jit():
            logits, cache = prefill(params, batch)
    else:
        logits, cache = prefill(params, batch)
    shapes, _ = jtf.serve_cache_spec(cfg, B, total, enc_len=P)
    cache = jax.tree.map(lambda c, s: jnp.pad(c, [
        (0, a - b) for a, b in zip(s.shape, c.shape)]), cache, shapes)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(params, tok, jnp.int32(P + i), cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_reference_lm_launcher_fails_on_its_host_mesh_here(monkeypatch,
                                                            capsys):
    """Pins the reference fault that `_reference_greedy` works around."""
    with pytest.raises(ValueError, match="UNCONSTRAINED"):
        _reference(monkeypatch, capsys, ["--arch", "llama3.2-1b",
                                         "--batch", "2", "--prompt-len", "4",
                                         "--gen", "2"])


def test_lm_launcher_gives_the_references_greedy_tokens(capsys):
    """`--arch llama3.2-1b --reduced --device cpu`: the reference's
    params (its PRNGKey(0) init) and prompt tokens carried across in
    float32, the same greedy tokens out."""
    cfg = jreg.reduced(jreg.ARCHS["llama3.2-1b"])
    key = jax.random.PRNGKey(0)
    params, _ = jcommon.split_pl(jtf.init_model(cfg, key))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    B, P, G = 2, 12, 6
    tokens = jax.random.randint(key, (B, P), 0, cfg.vocab)
    want = _reference_greedy(cfg, params, tokens, G)

    args = tserve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--batch",
         str(B), "--prompt-len", str(P), "--gen", str(G)])
    got = tserve.serve_lm(
        args, params=ttf.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu",
            dtype=torch.float32),
        tokens=torch.from_numpy(np.array(tokens)))
    out = capsys.readouterr().out
    np.testing.assert_array_equal(got.numpy(), want)
    assert "[serve] device: cpu" in out
    assert f"sample: {want[0, :12].tolist()}" in out
    assert re.search(r"decoded 2x5 tokens in [\d.]+s \([\d.]+ tok/s\)",
                     out)


def test_lm_launcher_serves_each_dense_arch(capsys):
    """The launcher's own path (its params and tokens from one generator
    seeded 0, bf16) on each dense arch: a prefill line, the decode rate,
    gen tokens per prompt; internvl2 through its stub frontend."""
    for arch in ("llama3.2-1b", "granite-3-8b", "qwen1.5-32b",
                 "granite-34b", "internvl2-76b"):
        tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4"])
        out = capsys.readouterr().out
        assert "prefill: " in out and "logits (2, 1, 256)" in out, arch
        assert "decoded 2x3 tokens" in out, arch
        sample = re.findall(r"^sample: \[(.*)\]$", out, re.M)
        assert len(sample) == 1 and len(sample[0].split(",")) == 4, arch


def test_lm_launcher_decodes_a_vlm_at_its_true_positions(capsys):
    """internvl2-76b: the stub frontend's tokens come first, so decode
    step i sits at n_frontend + prompt + i. Each greedy token is the
    argmax of the full forward over the frontend, the prompt and the
    tokens before it, at its position (float32: no near ties)."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models.common import split_pl

    cfg = reduced(ARCHS["internvl2-76b"])
    params, _ = split_pl(ttf.init_model(
        cfg, torch.Generator().manual_seed(1), dtype=torch.float32,
        device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(2))
    args = tserve.build_parser().parse_args(
        ["--arch", "internvl2-76b", "--device", "cpu", "--batch", "2",
         "--prompt-len", "6", "--gen", "5"])
    got = tserve.serve_lm(args, params=params, tokens=tokens)
    capsys.readouterr()
    seq = torch.cat([tokens, got[:, :-1]], dim=1)
    batch = {"tokens": seq, "frontend": torch.zeros(
        2, cfg.n_frontend_tokens, cfg.d_model, dtype=torch.bfloat16)}
    with torch.no_grad():
        x, pos = ttf._assemble_input(params, cfg, batch)
        h, _, _ = ttf._trunk(params, cfg, x, pos)
        logits = ttf._logits(params, cfg, h)
    first = cfg.n_frontend_tokens + 6 - 1
    want = logits[:, first:].argmax(dim=-1)
    assert torch.equal(got, want)


# -- the training launcher and the elastic runner ----------------------------

TRAIN_ARGS = ["--arch", "llama3.2-1b", "--steps", "4", "--batch", "2",
              "--seq", "16", "--device", "cpu"]


def test_health_monitor_flags_the_references_stragglers():
    from repro.launch import elastic as jelastic
    from repro_torch.launch import elastic as telastic
    times = [1.0, 0.5, 0.5, 0.6, 3.5, 0.4, 9.0, 0.5, 0.5, 30.0, 0.1, 2.0]
    jm, tm = jelastic.HealthMonitor(), telastic.HealthMonitor()
    flags = [(tm.observe(t), jm.observe(t)) for t in times]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert any(a for a, _ in flags)
    assert tm.ewma == jm.ewma


def test_make_mesh_from_holds_one_device():
    """One device (a repeat counts once) gives the one-device mesh on it;
    several ranks the reference's shapes; CPU beside meta raises."""
    from repro_torch.launch import elastic as telastic
    cpu = torch.device("cpu")
    mesh = telastic.make_mesh_from([cpu, "cpu"], 4)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device == cpu
    for n, want in ((8, {"data": 4, "model": 2}), (4, {"data": 2, "model": 2}),
                    (3, {"data": 3, "model": 1})):
        assert telastic.make_mesh_from(list(range(n)), 2).shape == want
    with pytest.raises(ValueError, match="one device type"):
        telastic.make_mesh_from([cpu, torch.device("meta")], 1)


def test_elastic_runner_gives_the_references_log(tmp_path):
    """Reduced llama3.2-1b on float32 params (the reference's runner
    cannot restore bf16 ones: ROADMAP.md Queue 3 item 22), AdamW, a
    checkpoint every step and a failure injected at step 2: the same
    events at the same steps (failure, remesh back to step 2), and every
    step's loss within 1e-5 of the reference's; the batches are the
    reference's TokenStream's."""
    from _lm_parity import carry_batch, family_params
    from repro import optim as joptim
    from repro.configs.base import ShapeConfig
    from repro.data.tokens import TokenStream
    from repro.launch import elastic as jelastic
    from repro.launch import steps as jsteps
    from repro.models.sharding import make_rules as jrules
    from repro_torch import optim as toptim
    from repro_torch.configs import registry as treg
    from repro_torch.launch import elastic as telastic
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.sharding import make_rules as trules

    jcfg = jreg.reduced(jreg.ARCHS["llama3.2-1b"])
    tcfg = treg.reduced(treg.ARCHS["llama3.2-1b"])
    np_params = family_params(jcfg, 0)
    stream = TokenStream(jcfg, ShapeConfig("t", 16, 2, "train"))
    jopt = joptim.adamw(lr=1e-3, schedule=joptim.cosine_schedule(1, 4))
    topt = toptim.adamw(lr=1e-3, schedule=toptim.cosine_schedule(1, 4))

    def jbuild(mesh):
        fn = jax.jit(jsteps.build_train_step(jcfg, jrules(mesh), jopt))
        params = jax.tree.map(jnp.asarray, np_params)

        def step_fn(state, batch):
            p, s, m = fn(*state, batch)
            return (p, s), m
        return step_fn, (params, jopt.init(params)), None

    def tbuild(mesh):
        fn = tsteps.build_train_step(tcfg, trules(mesh), topt)
        params = ttf.params_from_numpy(np_params, device=mesh.device,
                                       dtype=torch.float32)

        def step_fn(state, batch):
            p, s, m = fn(*state, batch)
            return (p, s), m
        return step_fn, (params, topt.init(params))

    _, want = jelastic.ElasticRunner(jbuild, str(tmp_path / "j"),
                                     ckpt_every=1).run(
        4, stream.batch, inject_failure_at=2)
    _, got = telastic.ElasticRunner(tbuild, str(tmp_path / "t"),
                                    ckpt_every=1).run(
        4, lambda s: carry_batch(stream.batch(s)),
        devices=[torch.device("cpu")], inject_failure_at=2)
    want = [e for e in want if e[0] != "straggler"]      # timing
    got = [e for e in got if e[0] != "straggler"]
    assert [e[:2] for e in got] == [e[:2] for e in want] == [
        ("step", 0), ("step", 1), ("failure", 2), ("remesh", 2),
        ("step", 2), ("step", 3)]
    for g, w in zip(got, want):
        if g[0] == "step":
            np.testing.assert_allclose(g[2], w[2], rtol=1e-5)
        else:
            assert g[2] == w[2]


def test_train_launcher_recovers_from_its_own_bf16_checkpoint(tmp_path,
                                                              capsys):
    """`python -m repro_torch.launch.train ... --inject-failure 2` prints
    the device, the trained-steps, loss and event lines; its checkpoint
    holds bf16 params; and after the restore (from step 0, the launcher
    checkpointing every 25 steps) the losses of steps 1 to 3 equal an
    uninterrupted run's exactly."""
    import json
    import os
    import subprocess
    from pathlib import Path

    from repro_torch.launch import train as ttrain
    repo = Path(__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--inject-failure", "2", "--ckpt-dir", str(tmp_path / "sub")],
        env=dict(os.environ, PYTHONPATH=str(repo / "src")), cwd=str(repo),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "[train] device: cpu"
    assert re.match(r"trained 5 steps in [\d.]+s \([\d.]+s/step\)$",
                    lines[1])
    assert re.match(r"loss: first=[\d.]+ last=[\d.]+$", lines[2])
    assert lines[3:] == ["event: ('failure', 2, 'injected loss at step 2')",
                         "event: ('remesh', 1, 1)"]
    with open(tmp_path / "sub" / "step_00000003" / "manifest.json") as f:
        assert "bfloat16" in {m["dtype"] for m in json.load(f)["leaves"]}

    _, failed = ttrain.main(TRAIN_ARGS + ["--inject-failure", "2",
                                          "--ckpt-dir", str(tmp_path / "a")])
    _, whole = ttrain.main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    assert [e[:2] for e in failed] == [
        ("step", 0), ("step", 1), ("failure", 2), ("remesh", 1),
        ("step", 1), ("step", 2), ("step", 3)]
    after = [e for e in failed[failed.index(("remesh", 1, 1)):]
             if e[0] == "step"]
    assert after == [e for e in whole if e[0] == "step"][1:]
    assert failed[:2] == whole[:2]


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """A second run on the same --ckpt-dir restores the last step and goes
    on from there, where the reference's raises (Queue 3 item 22)."""
    from repro_torch.launch import train as ttrain
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _, first = ttrain.main(TRAIN_ARGS + ck)
    argv = [a if a != "4" else "6" for a in TRAIN_ARGS]
    _, second = ttrain.main(argv + ck)
    out = capsys.readouterr().out
    assert "event: ('restore', 3, 1)" in out
    assert [e[:2] for e in second] == [("restore", 3), ("step", 4),
                                       ("step", 5)]
    assert len([e for e in first if e[0] == "step"]) == 4


def test_a_shape_error_in_a_step_propagates(tmp_path):
    """Only NodeFailure (and a device error) is taken for a lost node: any
    other error of a step propagates at once, with no rebuild."""
    from repro_torch.launch import elastic as telastic
    builds = []

    def build(mesh):
        builds.append(mesh)

        def step_fn(state, batch):
            return state, {"loss": torch.zeros(2) + torch.zeros(3)}
        return step_fn, {"w": torch.zeros(2)}

    runner = telastic.ElasticRunner(build, str(tmp_path))
    with pytest.raises(RuntimeError, match="size of tensor"):
        runner.run(3, lambda s: {}, devices=["cpu"])
    assert len(builds) == 1
    assert not isinstance(RuntimeError("x"), telastic.NodeFailure)


def test_elastic_runner_gives_up_after_max_recoveries(tmp_path):
    from repro_torch.launch import elastic as telastic
    builds = []

    def build(mesh):
        builds.append(mesh)

        def step_fn(state, batch):
            raise telastic.NodeFailure("lost")
        return step_fn, {"w": torch.zeros(2)}

    runner = telastic.ElasticRunner(build, str(tmp_path), max_recoveries=2)
    with pytest.raises(telastic.NodeFailure, match="lost"):
        runner.run(3, lambda s: {}, devices=["cpu"])
    assert len(builds) == 3
