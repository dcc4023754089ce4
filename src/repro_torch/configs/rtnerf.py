"""RT-NeRF's workload config: a TensoRF VM-decomposed radiance field plus
the RT-NeRF rendering pipeline. The port's own copy of the reference's
`NeRFConfig` (same fields, same defaults), so the port imports nothing of
the JAX package and a config crosses between the two with
`NeRFConfig(**dataclasses.asdict(other))`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    name: str = "rtnerf"
    family: str = "nerf"
    # --- TensoRF VM decomposition ---
    grid_res: int = 160              # embedding-grid resolution per axis
    r_sigma: int = 16                # density components R (Eq. 2)
    r_color: int = 48                # appearance components
    app_dim: int = 27                # appearance feature dim fed to the MLP
    mlp_hidden: int = 128            # view-dependent color MLP
    pe_view: int = 2                 # positional-encoding bands for direction
    pe_feat: int = 2                 # positional-encoding bands for features
    # --- occupancy / RT-NeRF pipeline ---
    occ_res: int = 160               # binary occupancy grid resolution
    cube_size: int = 4               # voxels per occupancy cube
    max_cubes: int = 8192            # static bound on non-zero cubes
    step_size: float = 0.5           # march step in voxel units
    max_samples_per_ray: int = 512   # uniform-baseline sample bound
    occ_sigma_thresh: float = 0.5    # sigma cutoff for occupancy rebuilds
    term_eps: float = 1e-4           # early-ray-termination threshold on T
    near: float = 2.0
    far: float = 6.0
    scene_bound: float = 1.5         # AABB half-extent
    # --- rendering / training ---
    image_hw: int = 800
    train_rays: int = 4096
    sigma_sparsity_l1: float = 5e-5
    tv_weight: float = 1e-3
    lr_grid: float = 2e-2
    lr_mlp: float = 1e-3
    # --- sparse encoding (H1) ---
    sparse_threshold: float = 0.80   # bitmap (<) vs COO (>=) switch
    dtype: str = "float32"
    # --- multi-scene serving ---
    max_resident_bytes: Optional[int] = None

    @property
    def cube_grid_res(self) -> int:
        return self.occ_res // self.cube_size

    def cube_world(self) -> float:
        return 2.0 * self.scene_bound * self.cube_size / self.occ_res

    def cube_ball_radius(self) -> float:
        """Bounding-ball radius of one occupancy cube."""
        return self.cube_world() * (3.0 ** 0.5) / 2.0

    def param_count(self) -> int:
        g, rs, rc = self.grid_res, self.r_sigma, self.r_color
        planes = 3 * (rs + rc) * g * g
        lines = 3 * (rs + rc) * g
        basis = 3 * rc * self.app_dim
        in_mlp = (self.app_dim + 3 + 2 * 3 * self.pe_view
                  + 2 * self.app_dim * self.pe_feat)
        mlp = (in_mlp * self.mlp_hidden + self.mlp_hidden * self.mlp_hidden
               + self.mlp_hidden * 3)
        return planes + lines + basis + mlp


CONFIG = NeRFConfig()


def demo_config(tiny: bool = False) -> NeRFConfig:
    """The shared example field shapes: the tiny CI config and the demo
    config, identical to the reference's `demo_config`."""
    if tiny:
        return NeRFConfig(grid_res=24, occ_res=24, cube_size=4,
                          max_cubes=256, r_sigma=4, r_color=8, app_dim=8,
                          mlp_hidden=16, max_samples_per_ray=64,
                          train_rays=256)
    return NeRFConfig(grid_res=40, occ_res=40, cube_size=4, max_cubes=768,
                      r_sigma=8, r_color=16, app_dim=12, mlp_hidden=32,
                      max_samples_per_ray=112, train_rays=1024)


@dataclasses.dataclass(frozen=True)
class NeRFShape:
    name: str
    n_rays: int                      # rays per step (render: H*W, train: batch)
    kind: str                        # train | render


NERF_SHAPES = {
    "train_rays": NeRFShape("train_rays", 4096, "train"),
    "render_800": NeRFShape("render_800", 800 * 800, "render"),
}
