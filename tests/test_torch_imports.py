"""The port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports jax or the reference package; and an entry point
asked to run with no device and no card raises instead of falling back
to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.configs.rtnerf import demo_config
from repro_torch.core import field as tfield
from repro_torch.core import rendering as trender
from repro_torch.core import tensorf as ttensorf
from repro_torch.data import rays as trays
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.serving import RenderEngine, SceneStore
from repro_torch.serving import engine as tengine
from repro_torch.serving import store as tstore

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


NEW_MODULES = ("obs/lockdebug.py", "obs/registry.py", "obs/tracing.py",
               "obs/exposition.py", "ckpt/checkpoint.py", "serving/store.py",
               "serving/temporal.py", "serving/engine.py")


EVAL_MODULES = ("data/rays.py", "data/__init__.py", "core/train.py",
                "core/pipeline.py", "core/rendering.py")


TRAIN_MODULES = ("optim/__init__.py", "optim/optimizers.py",
                 "core/train.py", "serving/finetune.py",
                 "kernels/ops.py", "kernels/bitmap_decode.py",
                 "kernels/coo_gather.py")


FLEET_MODULES = ("configs/base.py", "core/distributed.py",
                 "serving/fleet.py", "serving/router.py",
                 "launch/__init__.py", "launch/serve.py")


def test_the_checks_cover_the_fleet_and_launcher_modules():
    """The import checks walk the launcher's and the fleet tier's modules
    too."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert set(FLEET_MODULES) <= files


def test_launcher_and_fleet_without_device_and_card_raise(monkeypatch,
                                                         tmp_path):
    """`launch.serve.main` serves on the card unless told `--device cpu`:
    without a card it raises, on the single-process and the fleet path,
    before it trains, exports or spawns anything; so do the router, the
    scene loader and the distributed placements."""
    import multiprocessing as mp

    from repro_torch.core import distributed as tdist
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import FleetRouter, load_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--arch", "rtnerf", "--views", "1", "--res", "8",
            "--train-steps", "1", "--ckpt-dir", str(tmp_path / "ck")]
    for extra in ([], ["--fleet-workers", "2"], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(base + extra)
    assert not (tmp_path / "ck").exists()
    assert not mp.active_children()
    cfg = demo_config(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRouter(cfg, {}, n_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_scene(str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.shard_rays(None, np.zeros((2, 3), np.float32),
                         np.zeros((2, 3), np.float32))
    assert not mp.active_children()


def test_the_checks_cover_the_training_modules():
    """The import checks walk the training path's modules too."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert set(TRAIN_MODULES) <= files


def test_training_entry_points_without_device_and_card_raise(monkeypatch):
    """A trainer with no field draws one on its device: with no device
    and no card it raises (as does prepare_field's train branch), and a
    fine-tune loop needs a store, which needs a device."""
    from repro_torch.core import train as ttrain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = demo_config(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.NerfTrainer(cfg, "lego", n_views=1, image_hw=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_nerf(cfg, "lego", steps=1, n_views=1, image_hw=8,
                          verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.prepare_field(cfg, "lego", ckpt_dir=None, train_steps=1)
    with pytest.raises(RuntimeError):
        ttrain.NerfTrainer(cfg, "lego", n_views=1, image_hw=8,
                           device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneStore(cfg)
    t = ttrain.NerfTrainer(cfg, "lego", n_views=1, image_hw=8, device="cpu")
    assert t.device == torch.device("cpu")


def test_the_checks_cover_the_evaluation_modules():
    """The import checks walk the evaluation path's modules too."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert set(EVAL_MODULES) <= files


def test_eval_entry_points_without_device_and_card_raise(monkeypatch):
    """make_cameras, build_dataset and RayDataset.batches build tensors
    from nothing: with no device and no card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trays.make_cameras(2, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trays.build_dataset(trays.make_scene("mic"), 1, 8, 8)
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(trays.RayDataset(z, z, z).batches(2))
    with pytest.raises(RuntimeError):
        trays.make_cameras(2, 8, 8, device="cuda")
    cams = trays.make_cameras(2, 8, 8, device="cpu")
    assert cams[0].c2w.device.type == "cpu"
    batch = next(trays.RayDataset(z, z, z, device="cpu").batches(2))
    assert all(b.device.type == "cpu" for b in batch)


def test_codec_encoders_without_device_and_card_raise(monkeypatch):
    """The hybrid codec's encoders build stream tensors from host arrays:
    like every entry point, with no device they go to the card, and with
    no card they raise instead of landing on the CPU."""
    from repro_torch.core import sparse as tsparse
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.eye(4, dtype=np.float32)
    for enc in (tsparse.encode_bitmap, tsparse.encode_coo,
                tsparse.encode_factor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            enc(w)
    assert tsparse.encode_factor(w, device="cpu").fmt in ("bitmap", "coo",
                                                          "dense")


LM_MODULES = ("models/attention.py", "models/moe.py", "models/ssm.py",
              "models/rwkv.py", "models/transformer.py", "launch/steps.py")


def test_the_checks_cover_the_language_model_modules():
    """The import checks walk the LM blocks too (MLA, MoE, Mamba2, RWKV6),
    and each keeps its own copy of the reference's constants."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert set(LM_MODULES) <= files
    from repro_torch.models import moe, rwkv, ssm
    assert (moe.BITMAP_CHUNK, ssm.SSD_CHUNK) == (256, 128)
    assert (rwkv.N_MIX, rwkv.DDLERP_RANK, rwkv.DECAY_RANK) == (5, 32, 64)


def test_lm_entry_points_without_device_and_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as ttf
    for name in ("deepseek-v3-671b", "zamba2-7b", "rwkv6-1.6b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttf.init_model(reduced(ARCHS[name]), torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttf.params_from_numpy({"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "seamless-m4t-large-v2"])


LM_TRAIN_MODULES = ("optim/schedule.py", "optim/compression.py",
                    "data/tokens.py", "launch/elastic.py", "launch/train.py")


def test_the_checks_cover_the_lm_training_modules():
    """The import checks walk LM training's modules too, and each keeps its
    own copy of the reference's constants."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert set(LM_TRAIN_MODULES) <= files
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import ADAFACTOR_PARAM_THRESHOLD
    assert (transformer.MOE_AUX_WEIGHT, transformer.MTP_WEIGHT,
            steps.GRAD_CLIP) == (0.01, 0.3, 1.0)
    assert ADAFACTOR_PARAM_THRESHOLD == 30_000_000_000


def test_lm_training_entry_points_without_device_and_card_raise(monkeypatch,
                                                               tmp_path):
    """The train launcher trains on the card unless told `--device cpu`,
    the elastic runner runs on the card unless given devices, and a token
    stream puts its batches on the card unless given a device: with no
    card each raises, before a checkpoint is written."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import elastic, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = tmp_path / "ck"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", "llama3.2-1b", "--steps", "1", "--batch",
                        "2", "--seq", "8", "--ckpt-dir", str(ck)] + extra)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.ElasticRunner(lambda mesh: None, str(ck)).run(
            1, lambda s: {})
    assert not ck.exists()
    stream = TokenStream(reduced(ARCHS["llama3.2-1b"]),
                         ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.batch(0)


def test_the_checks_cover_the_serving_tier_modules():
    """The import checks below walk every file of the port; the serving
    tier's subpackages are among them."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert set(NEW_MODULES) <= files
    assert {"obs/__init__.py", "ckpt/__init__.py"} <= files


def test_no_port_file_imports_jax_or_the_reference():
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in _port_files() for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax_or_reference_module():
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .replace(".__init__", "") for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_without_device_and_card_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = demo_config(tiny=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        ttensorf.init_field(cfg, gen)
    with pytest.raises(RuntimeError):
        trender.look_at_camera([4.0, 0, 0], [0, 0, 0], 10.0, 8, 8)
    with pytest.raises(RuntimeError):
        tfield.field_from_state({"kind": "dense"}, {}, cfg)
    params = ttensorf.init_field(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError):
        RenderEngine(cfg, params)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        SceneStore(cfg)
    with pytest.raises(RuntimeError):
        tckpt.restore_checkpoint(str(tmp_path), 0, {})
    with pytest.raises(RuntimeError):
        tstore.load_cubes(str(tmp_path))
    with pytest.raises(RuntimeError):
        tengine.prepare_field(cfg, "lego", ckpt_dir=None)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
