"""The port's serving launcher (`python -m repro_torch.launch.serve --arch
rtnerf`) against the reference's (`repro.launch.serve`), on a checkpoint
the reference wrote at the launcher's `NeRFConfig`: the scene line equal
exactly and every view's PSNR within 0.01 dB, on one process and through
the fleet (marked `fleet`: it spawns worker processes). The flags the
reference refuses, the port refuses alike."""
import dataclasses
import re
import sys

import pytest

from repro.configs.rtnerf import NeRFConfig as JaxConfig
from repro.launch import serve as jserve
from repro.serving import prepare_field as jprepare_field
from repro_torch.launch import serve as tserve

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


def test_other_archs_exit_with_a_message(capsys):
    for argv in (["--arch", "llama3.2-1b"],
                 ["--arch", "llama3.2-1b", "--fleet-workers", "2"]):
        with pytest.raises(SystemExit) as e:
            tserve.main(argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "serves --arch rtnerf only" in err
    assert "serve_lm" in err
    assert "--fleet-workers requires --arch rtnerf" in err
