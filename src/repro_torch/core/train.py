"""Evaluation of a radiance field against ground truth. The port of the
evaluation part of `repro/core/train.py`: `eval_view` renders one view
through either pipeline and reports its PSNR, the way the reference
produces every PSNR and sample count it reports.

The training half of the reference module (`nerf_loss`, `NerfTrainer`,
`train_nerf`) arrives with ROADMAP Queue 1 item 4, together with the
`FieldBackend` training surface, the exact `adamw` update and the
backward passes of the two gather kernels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core import pipeline as rt_pipe
from repro_torch.core import rendering
from repro_torch.device import common_device


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
