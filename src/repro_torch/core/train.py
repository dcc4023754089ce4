"""NeRF training and evaluation. The port of `repro/core/train.py`.

Training: photometric MSE + L1 sparsity + TV, compressed-native with
support revival. `NerfTrainer` is the incremental stepper (`step()` /
`reencode()` / `snapshot()` / `final()`) that the online fine-tuning
service (serving/finetune.py) drives one step at a time between
publications; `train_nerf` runs it to completion and returns a
`TrainResult`. Training renders go through the differentiable uniform
pipeline without occupancy (as in TensoRF); the occupancy grid is built
once, from the final field, at `cfg.occ_sigma_thresh`.

Compressed-native: the optimizer steps the *encoded* field's payloads
(`FieldBackend.trainable()`: the packed non-zeros of each factor slice,
the basis and the MLP). On the card the gradient of a packed value comes
from the backward kernels of the two gathers (`kernels.ops`); the
reference gets it by differentiating its jnp gathers. The support is
fixed between re-encode boundaries: every `occ_every` steps the field is
decoded, revived (the top `revive_frac` zero entries by |dense gradient|
re-seeded, `DenseField.revive`), re-pruned and re-encoded.

Every step runs eagerly (not compiled, not captured). The choices are the
reference's: one `adamw(lr=cfg.lr_grid, b2=0.99)` over every trainable
leaf (`cfg.lr_mlp` is not used), revival batches drawn from their own
stream (seed + 1), the occupancy grid built once in `final()`. Where no
field is given, the initial one is drawn from a `torch.Generator`
seeded with `seed` (the reference draws from `jax.random`, so the two
start from different fields).

Evaluation: `eval_view` renders one view through either pipeline and
reports its PSNR, as the reference produces every PSNR it reports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core import occupancy as occ_lib
from repro_torch.core import pipeline as rt_pipe
from repro_torch.core import rendering, tensorf
from repro_torch.data import rays as rays_lib
from repro_torch.device import DeviceLike, common_device, resolve_device
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainResult:
    field: field_lib.FieldBackend
    cubes: occ_lib.CubeSet
    history: list


def nerf_loss(field, cfg: NeRFConfig, rays_o, rays_d, target, cubes=None):
    """(loss, mse) of a batch of rays: the uniform render's MSE against
    `target`, plus the L1 and TV regularisers. Without `cubes` the render
    takes no occupancy."""
    f = field_lib.as_backend(field, cfg)
    rgb, _ = rendering.render_uniform(f, cfg, cubes, rays_o, rays_d,
                                      use_occupancy=cubes is not None)
    mse = torch.mean(torch.square(rgb - target))
    loss = mse + cfg.sigma_sparsity_l1 * f.l1() + cfg.tv_weight * f.tv()
    return loss, mse


def loss_and_grads(field: field_lib.FieldBackend, cfg: NeRFConfig, ro, rd,
                   tgt) -> Tuple[torch.Tensor, torch.Tensor,
                                 Dict[str, torch.Tensor]]:
    """(loss, mse, {name: gradient}) over `field.trainable()`, the loss
    and mse detached."""
    tvals = {k: v.detach().requires_grad_(True)
             for k, v in field.trainable().items()}
    loss, mse = nerf_loss(field.with_trainable(tvals), cfg, ro, rd, tgt)
    grads = torch.autograd.grad(loss, list(tvals.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), mse.detach(), dict(zip(tvals, grads))


class NerfTrainer:
    """Incremental compressed-native trainer: one optimizer step at a time.

    `train_nerf` drives it to completion; `serving.finetune.FineTuneLoop`
    drives it on a background thread between publications. It starts
    from a fresh field (`field=None`, drawn on `device`; None: the card)
    or resumes any FieldBackend (e.g. the field an engine serves), on
    that field's device.

    State: `field` is the structure template (encoded or dense), `_tvals`
    the float payloads the optimizer owns. At every `occ_every` boundary
    `reencode()` revives, re-prunes and re-encodes, and the optimizer
    state starts over for the new leaf shapes.
    """

    def __init__(self, cfg: NeRFConfig, scene_name: str, *,
                 field: Optional[field_lib.FieldBackend] = None,
                 n_views: int = 12, image_hw: int = 64,
                 occ_every: int = 200, prune_tol: float = 1e-3,
                 revive_frac: float = 0.05,
                 revive_eps: Optional[float] = None,
                 seed: int = 0, compressed: bool = True,
                 verbose: bool = False, device: DeviceLike = None):
        self.cfg = cfg
        self.scene_name = scene_name
        self.compressed = bool(compressed)
        self.occ_every = int(occ_every)
        self.prune_tol = float(prune_tol)
        self.revive_frac = float(revive_frac)
        # revived entries must clear the next tol-prune or revival is a no-op
        self.revive_eps = (2.0 * self.prune_tol if revive_eps is None
                           else float(revive_eps))
        self.verbose = bool(verbose)
        if field is None:
            dev = resolve_device(device)
            gen = torch.Generator().manual_seed(int(seed))
            field = field_lib.DenseField(
                tensorf.init_field(cfg, gen, device=dev), cfg)
        field = field_lib.as_backend(field, cfg)
        dev = field.device
        want = torch.device(device) if device is not None else dev
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"NerfTrainer: the field lies on {dev}, not on "
                             f"the device asked for, {want}")
        self.device = dev
        scene = rays_lib.make_scene(scene_name)
        ds = rays_lib.build_dataset(scene, n_views, image_hw, image_hw,
                                    device=dev)
        self._it = ds.batches(cfg.train_rays, seed=seed)
        # revival grads come from their own stream, so that revival does
        # not shift which rays the optimizer steps see
        self._revive_it = ds.batches(cfg.train_rays, seed=seed + 1)
        self.opt = adamw(lr=cfg.lr_grid, b2=0.99)
        self.step_count = 0
        self._rebind(field)

    def _rebind(self, field: field_lib.FieldBackend):
        """Adopt `field` as the structure template, with fresh optimizer
        state over its trainable leaves."""
        self.field = field
        self._tvals = {k: v.detach() for k, v in field.trainable().items()}
        self._opt_state = self.opt.init(self._tvals)

    def reencode(self):
        """Re-encode boundary: revive the support from dense gradients,
        re-prune, hybrid-encode, and start the optimizer over (the
        trainable leaf shapes change with the support)."""
        dense = self.snapshot().decode()
        if self.revive_frac > 0.0:
            ro, rd, tgt = next(self._revive_it)
            grads = loss_and_grads(dense, self.cfg, ro, rd, tgt)[2]
            dense = dense.revive(grads, frac=self.revive_frac,
                                 eps=self.revive_eps)
        self._rebind(dense.prune(tol=self.prune_tol).encode())
        if self.verbose:
            print(f"  [{self.scene_name}] step {self.step_count:5d} "
                  f"re-encoded field "
                  f"({self.field.compression_ratio():.2f}x factor bytes)",
                  flush=True)

    def step(self) -> Dict[str, float]:
        """One optimizer step (re-encoding first at `occ_every`
        boundaries); returns {step, loss, psnr} of this batch."""
        i = self.step_count
        if self.compressed and i > 0 and i % self.occ_every == 0:
            self.reencode()
        ro, rd, tgt = next(self._it)
        loss, mse, grads = loss_and_grads(self.snapshot(), self.cfg, ro, rd,
                                          tgt)
        with torch.no_grad():
            self._tvals, self._opt_state = self.opt.update(
                grads, self._opt_state, self._tvals)
        self.step_count = i + 1
        p = float(-10 * np.log10(max(float(mse), 1e-10)))
        return {"step": i, "loss": float(loss), "psnr": p}

    def snapshot(self) -> field_lib.FieldBackend:
        """The current field with the optimizer's payloads applied: what
        a publication or a checkpoint should see (no decode, no encode)."""
        return self.field.with_trainable(self._tvals)

    def final(self) -> TrainResult:
        """Finish: prune, encode (compressed mode), build the occupancy
        cube set at `cfg.occ_sigma_thresh`."""
        field = self.snapshot().prune(tol=self.prune_tol)
        if self.compressed:
            field = field.encode()
        occ = occ_lib.build_occupancy(field, self.cfg)
        cubes = occ_lib.extract_cubes(occ, self.cfg)
        return TrainResult(field=field, cubes=cubes, history=[])


def train_nerf(cfg: NeRFConfig, scene_name: str, *, steps: int = 400,
               n_views: int = 12, image_hw: int = 64,
               occ_every: int = 200, prune_tol: float = 1e-3,
               revive_frac: float = 0.05,
               seed: int = 0, log_every: int = 100, verbose: bool = True,
               compressed: bool = True,
               device: DeviceLike = None) -> TrainResult:
    """Train a TensoRF field for `steps` steps; return the final (encoded)
    field, its occupancy cubes and the logged {step, loss, psnr} records.

    compressed=True: at every `occ_every` boundary the field is revived,
    pruned (`prune_tol`) and hybrid-encoded, and the optimizer continues
    on the encoded values; compressed=False keeps the dense loop end to
    end. The field starts fresh on `device` (None: the card)."""
    trainer = NerfTrainer(cfg, scene_name, n_views=n_views,
                          image_hw=image_hw, occ_every=occ_every,
                          prune_tol=prune_tol, revive_frac=revive_frac,
                          seed=seed, compressed=compressed, verbose=verbose,
                          device=device)
    history = []
    for i in range(steps):
        rec = trainer.step()
        if i % log_every == 0 or i == steps - 1:
            history.append(rec)
            if verbose:
                print(f"  [{scene_name}] step {i:5d} "
                      f"loss {rec['loss']:.5f} "
                      f"train-psnr {rec['psnr']:.2f}", flush=True)
    res = trainer.final()
    return TrainResult(field=res.field, cubes=res.cubes, history=history)


def eval_view(field, cfg: NeRFConfig, cubes, cam: rendering.Camera, gt, *,
              pipeline: str = "rtnerf", order_mode: str = "octant",
              chunk: int = 1, intersect: str = "box"
              ) -> Tuple[float, Dict[str, float], torch.Tensor]:
    """Render one view with either pipeline ("rtnerf" or the uniform
    baseline); return (psnr of the image clipped to [0, 1] against `gt`
    (H*W, 3), {stat: float}, image). `field` is anything
    `field.as_backend` accepts; an encoded field is sampled from its
    bitmap/COO streams on both pipelines. `gt` is an array, or a tensor
    on the render's device."""
    f = field_lib.as_backend(field, cfg)
    if pipeline == "rtnerf":
        img, stats = rt_pipe.render_rtnerf(f, cfg, cubes, cam,
                                           order_mode=order_mode,
                                           chunk=chunk, intersect=intersect)
    else:
        o, d = rendering.camera_rays(cam)
        img, stats = rendering.render_uniform(f, cfg, cubes, o, d)
    if isinstance(gt, torch.Tensor):
        common_device(gt, img, what="eval_view's ground truth and render")
    else:
        gt = torch.from_numpy(np.array(gt, np.float32)).to(img.device)
    p = float(rendering.psnr(torch.clamp(img, 0.0, 1.0), gt))
    return p, {k: float(v) for k, v in stats.items()}, img
