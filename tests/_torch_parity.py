"""Shared fixtures for the parity tests of the PyTorch port (`repro_torch`)
against the JAX reference (`repro`): inputs are made with numpy from a
seed and cross between the packages as numpy arrays."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs.rtnerf import NeRFConfig as JaxConfig
from repro.configs.rtnerf import demo_config
from repro.core import field as jfield
from repro.core import tensorf as jtensorf
from repro.core.occupancy import CubeSet as JaxCubeSet
from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as tfield
from repro_torch.core import occupancy as tocc
from repro_torch.core import rendering as trender
from repro_torch.data import rays as trays

CPU = torch.device("cpu")
# the tier-1 run has several test processes per machine: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)


def torch_cfg(cfg: JaxConfig) -> NeRFConfig:
    return NeRFConfig(**dataclasses.asdict(cfg))


def tiny_cfg() -> JaxConfig:
    return demo_config(tiny=True)


def numpy_params(cfg: JaxConfig, seed: int) -> dict:
    """Field parameters drawn with numpy at the reference's shapes and
    fan-in scales (biases small but non-zero so they are exercised)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jtensorf.init_field(cfg, k),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    out = {}
    for k, s in shapes.items():
        scale = 0.1 if k in ("sigma_planes", "sigma_lines", "app_planes",
                             "app_lines") else 1.0 / np.sqrt(s.shape[0])
        out[k] = (rng.randn(*s.shape) * scale).astype(np.float32)
    return out


def jax_case(sparsity, threshold, seed=0, zero_slices=False):
    """The reference's fused-parity field (tests/test_kernels.py
    `_fused_case`): a pruned, encoded tiny field plus cube-grouped query
    points. Returns (cfg, cf, centers, cube_id, pts) as JAX objects."""
    cfg = tiny_cfg()
    params = jtensorf.init_field(cfg, jax.random.PRNGKey(seed))
    params = jtensorf.prune_to_sparsity(params, sparsity)
    if zero_slices:
        params["sigma_planes"] = params["sigma_planes"].at[1].set(0.0)
        params["app_lines"] = params["app_lines"].at[2].set(0.0)
    cf = jfield.DenseField(params, cfg).encode(threshold)
    rng = np.random.RandomState(seed)
    C = 4
    ci = rng.randint(0, cfg.cube_grid_res, size=(C, 3))
    centers = np.asarray(-cfg.scene_bound + (ci + 0.5) * cfg.cube_world(),
                         np.float32)
    cid = rng.randint(0, C, 300).astype(np.int32)
    half = cfg.cube_world() / 2.0
    off = rng.uniform(-half, half, (300, 3)).astype(np.float32)
    pts = centers[cid] + off
    return cfg, cf, centers, cid, pts


def mixed_case():
    """Bitmap and COO slices in one field (the reference's "mixed" case)."""
    cfg, bm, centers, cid, pts = jax_case(0.6, threshold=0.99)
    co = bm.decode().encode(0.0)
    cf = jfield.CompressedField(
        {"sigma_planes": bm.factors["sigma_planes"],
         "sigma_lines": co.factors["sigma_lines"],
         "app_planes": co.factors["app_planes"],
         "app_lines": bm.factors["app_lines"]},
        bm.extras, cfg, bm.threshold)
    return cfg, cf, centers, cid, pts


FUSED_CASES = {
    "bitmap": lambda: jax_case(0.6, threshold=0.99),
    "coo": lambda: jax_case(0.9, threshold=0.80),
    "mixed": mixed_case,
    "empty": lambda: jax_case(0.9, threshold=0.80, zero_slices=True),
}
FUSED_FORMATS = {"bitmap": {"bitmap"}, "coo": {"coo"},
                 "mixed": {"bitmap", "coo"}, "empty": {"coo"}}


def carry_field(jf, cfg: JaxConfig, device=CPU):
    """The reference field rebuilt in the port through `field_state`."""
    spec, arrays = jfield.field_state(jf)
    return tfield.field_from_state(
        spec, {k: np.asarray(v) for k, v in arrays.items()}, torch_cfg(cfg),
        device=device)


def carry_cubes(cubes: JaxCubeSet, device=CPU):
    return tocc.cubes_from_arrays(
        np.asarray(cubes.centers), np.asarray(cubes.valid), cubes.count,
        cubes.radius, np.asarray(cubes.occ), device=device)


def carry_camera(cam, device=CPU) -> trender.Camera:
    return trender.Camera(t(cam.c2w, device), t(cam.origin, device),
                          cam.focal, cam.h, cam.w)


def t(x, device=CPU) -> torch.Tensor:
    """A JAX/numpy array as a tensor (copied)."""
    return torch.from_numpy(np.array(x)).to(device)


def n(x) -> np.ndarray:
    """A tensor or JAX array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def carry_scene(scene):
    """The reference's Scene as the port's: the same arrays, copied."""
    return trays.Scene(scene.name, np.array(scene.prim_type),
                       np.array(scene.center), np.array(scene.size),
                       np.array(scene.color))
