"""Distributed NeRF over a mesh of ranks. The port of
`repro/core/distributed.py`.

The reference places the serving field and each ray chunk on a JAX mesh:
the encoded streams replicated (`stream_sharding`), the rays split over
the batch axes (`ray_sharding`), the VM components over "model"
(`nerf_param_sharding`). The port runs one process a device
(`launch.mesh`), so the specs become DTensor placements
(`models.sharding.placements`) and the placements become data movement:

  * a field is placed whole on this rank's device (`place_field`): every
    rank walks the whole stream, which is KB to MB and read-only;
  * a ray chunk that divides the data axis is split into contiguous
    slices, one a rank in rank order (`shard_rays`), and reassembled
    (`gather_rays`, an all-gather); one that does not is rendered whole
    on every rank;
  * a chunk's counters are reduced to what one device counts
    (`reduce_counts`, an all-reduce);
  * a params dict is placed by `nerf_param_sharding`
    (`place_nerf_params`): each rank keeps R / m channels of every plane
    and line whose R divides the "model" axis's m ranks, and the rest
    whole. Eq. 2 is a sum over R, so each rank evaluates its channels
    and one all-reduce in the "model" group finishes the sum
    (`split_field`, `core.field.SplitField`): the density's before its
    softplus, the appearance features' after the rank's basis rows.

The ray collectives run in the mesh's "data" group, the sums over R in
its "model" group, all through `dist` collectives: NCCL and gloo both
carry them on CUDA tensors, so ranks that share one card (gloo) run the
same code as ranks on cards of their own (NCCL); gloo's point-to-point
send of a CUDA tensor is what it cannot carry (`launch/pipeline.gpipe`
needs NCCL or CPU ranks). `place_field` and `shard_rays` also take a
plain device, the one-device path.

`build_render_step` and `build_nerf_train_step` run on any (data, model)
mesh: rays over "data", the R channels over "model". Rays over "pod",
`nerf_input_specs` and `lower_nerf_cell` belong to the dry-run tooling
(ROADMAP.md Queue 1 item 11). Training uses the differentiable uniform
pipeline (as TensoRF does); the cube-centric RT-NeRF pipeline is the
serving path.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import field as field_lib
from repro_torch.core import rendering, sparse
from repro_torch.core import train as train_lib
from repro_torch.core.occupancy import CubeSet
from repro_torch.device import resolve_device
from repro_torch.models.sharding import (AxisRules, local_part, local_slices,
                                         mesh_size, place, placed_like,
                                         placements, split_dims, whole)

BATCH_AXES = ("pod", "data")


def nerf_param_sharding(cfg: NeRFConfig, params,
                        rules: AxisRules) -> Dict[str, tuple]:
    """Placements per param: planes and lines over "model" on their R
    dim where it divides, the rest replicated."""
    mesh = rules.mesh

    def spec_for(name, arr):
        if "planes" in name or "lines" in name:
            m = mesh.shape.get("model", 1)
            if m > 1 and arr.shape[1] % m == 0:
                return (None, "model")
        return ()

    return {k: placements(spec_for(k, v), mesh) for k, v in params.items()}


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def ray_sharding(rules: AxisRules, n_rays: int) -> tuple:
    """Placements of a chunk of `n_rays` rays: dim 0 over the batch axes
    when it divides them, else replicated."""
    axes = _batch_axes(rules.mesh)
    size = math.prod(rules.mesh.shape[a] for a in axes)
    if size > 1 and n_rays % size == 0:
        spec = (axes if len(axes) > 1 else axes[0],)
    else:
        spec = ()
    return placements(spec, rules.mesh)


def stream_sharding(rules: AxisRules) -> tuple:
    """Placements of the resident field's encoded streams (bitmap words,
    rowptr, values; COO coords and values; dense factors; the MLP):
    replicated."""
    return placements((), rules.mesh)


def _device(where) -> torch.device:
    if isinstance(where, AxisRules):
        return where.mesh.device
    return resolve_device(where)


def _split(rules: Optional[AxisRules], n_rays: int) -> Tuple[int, int]:
    """(parts, this rank's part) of a chunk of `n_rays` rays: the data
    axis when it divides the chunk, else (1, 0)."""
    if not isinstance(rules, AxisRules):
        return 1, 0
    mesh = rules.mesh
    for a in _batch_axes(mesh):
        if a != "data" and mesh.shape[a] > 1:
            raise NotImplementedError(
                f"rays over the '{a}' axis: the port's meshes split rays "
                f"over 'data' (the production meshes are ROADMAP.md Queue "
                f"1 item 11)")
    parts = mesh.shape.get("data", 1)
    if parts == 1 or n_rays % parts:
        return 1, 0
    return parts, mesh.coordinate("data")


def place_field(field, where):
    """A resident serving field on this rank's device (`where`: the rules
    of its mesh, or a device): every stream tensor, the integer metadata
    and the MLP (a `FieldBackend`, or a params dict), whole on every rank
    (`stream_sharding`)."""
    dev = _device(where)
    if isinstance(field, dict):
        return {k: torch.as_tensor(v).to(dev) for k, v in field.items()}
    return field.to(dev)


def shard_rays(where, rays_o, rays_d) -> Tuple[torch.Tensor, torch.Tensor]:
    """One micro-batched ray chunk (numpy arrays or tensors) on this
    rank's device: its contiguous slice of the chunk when the chunk
    divides the mesh's data axis, the whole chunk otherwise (the
    reference's replicated fallback, and the one-device path; `where`: the
    rules of the mesh, or a device)."""
    dev = _device(where)
    parts, i = _split(where, rays_o.shape[0])
    n = rays_o.shape[0] // parts
    lo, hi = i * n, (i + 1) * n

    def put(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a[lo:hi])
        else:
            a = a[lo:hi]
        return a.to(dev)
    return put(rays_o), put(rays_d)


def gather_rays(rules: Optional[AxisRules], x: torch.Tensor,
                n_rays: int) -> torch.Tensor:
    """Per-ray outputs of this rank's `shard_rays` slice reassembled into
    the whole chunk of `n_rays` rays, in rank order, on every rank. A
    chunk rendered whole is returned as it is."""
    parts, _ = _split(rules, n_rays)
    if parts == 1:
        return x
    if x.shape[0] * parts != n_rays:
        raise ValueError(f"{x.shape[0]} rows of a chunk of {n_rays} rays "
                         f"split {parts} ways")
    full = x.new_empty((n_rays, *x.shape[1:]))
    dist.all_gather_into_tensor(full, x.contiguous(),
                                group=rules.mesh.group("data"))
    return full


def reduce_counts(rules: Optional[AxisRules], counts: torch.Tensor,
                  n_rays: int) -> torch.Tensor:
    """A chunk's counters (a tensor of counts) as one device counts them:
    summed over the ranks that split the chunk; where every rank rendered
    it whole, the largest across the data group, so that every rank holds
    the same numbers (and so decides the same pair budget)."""
    if not isinstance(rules, AxisRules) or rules.mesh.shape.get(
            "data", 1) == 1:
        return counts
    parts, _ = _split(rules, n_rays)
    op = dist.ReduceOp.SUM if parts > 1 else dist.ReduceOp.MAX
    counts = counts.clone()
    dist.all_reduce(counts, op=op, group=rules.mesh.group("data"))
    return counts


def _on_model(rules: Optional[AxisRules]) -> bool:
    """Whether `rules` name a mesh with a "model" axis above 1."""
    return isinstance(rules, AxisRules) and rules.mesh.shape.get(
        "model", 1) > 1


def place_nerf_params(cfg: NeRFConfig, params,
                      rules: AxisRules) -> Dict[str, torch.Tensor]:
    """A params dict on `rules.mesh` by `nerf_param_sharding` (the
    reference's `jax.device_put(params, p_sh)`): every rank passes the
    same whole dict (numpy arrays or tensors; placed DTensors are
    redistributed) and keeps, as DTensors on its device, its shard of
    each split plane and line (dim 1 cut in "model"-coordinate order,
    the cut made before the copy to the device) and every other leaf
    whole. A mesh of one rank: plain tensors on its device."""
    mesh, dev = rules.mesh, rules.mesh.device
    if mesh_size(mesh) == 1:
        return {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    pls = nerf_param_sharding(cfg, params, rules)
    return {k: place(torch.as_tensor(v), pls[k], mesh, device=dev)
            for k, v in params.items()}


def whole_nerf_params(params) -> Dict[str, torch.Tensor]:
    """The inverse of `place_nerf_params`: every leaf whole on every rank
    (an all-gather of each split leaf in its "model" group); plain
    tensors as they are."""
    with torch.no_grad():
        return {k: whole(v) for k, v in params.items()}


def _place_state(state, params, rules: AxisRules):
    """An optimizer state on the mesh as its placed `params`: each
    subtree keyed as the params (AdamW's m and v) placed leaf by leaf as
    its param (the reference's `s_sh`); the rest as it is."""
    out = {}
    for name, sub in state.items():
        if isinstance(sub, dict) and set(sub) == set(params):
            sub = {k: place(torch.as_tensor(v), params[k].placements,
                            rules.mesh, device=rules.mesh.device)
                   for k, v in sub.items()}
        out[name] = sub
    return out


class _ModelSum(torch.autograd.Function):
    """A partial sum over the ranks of `group`, made whole on each (an
    all-reduce). Backward: every rank computes the same from the sum, so
    each partial's gradient is the sum's, whole, with no collective."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelShare(torch.autograd.Function):
    """A whole value that each rank of `group` uses in its own way (the
    basis rows of its channels). Backward: the gradients' sum over the
    group, the transpose of handing every rank the value."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def split_field(cfg: NeRFConfig, params,
                rules: AxisRules) -> field_lib.SplitField:
    """The field of a params dict placed by `place_nerf_params` on a mesh
    with a "model" axis: this rank's local tensors, the channels it holds
    of each split head, the split leaves' whole counts, and the sums
    over the "model" group (`_ModelSum`, `_ModelShare`). A head whose R
    does not divide the axis is whole, evaluated whole on every rank."""
    group = rules.mesh.group("model")
    channels = {}
    for head in ("sigma", "app"):
        t = params[f"{head}_planes"]
        if split_dims(t, 1):
            sl = local_slices(t.shape, t.placements, t.device_mesh)[1]
            channels[head] = (sl.start, sl.stop)
    return field_lib.SplitField(
        {k: local_part(v) for k, v in params.items()}, cfg, channels,
        {k: params[k].numel() for k in sparse.FACTOR_KEYS},
        reduce=lambda x: _ModelSum.apply(x, group),
        share=lambda x: _ModelShare.apply(x, group))


def build_render_step(cfg: NeRFConfig, rules: Optional[AxisRules] = None):
    """Batched novel-view rendering: rays -> rgb through the uniform
    pipeline, with the occupancy grid as one cube's (the serving analogue
    of Step 2-1/2-2/3). With `rules`, each rank renders its slice of the
    rays (`shard_rays`) and every rank returns the whole image. On a
    "model" axis a params dict or a `DenseField` (whole, or placed by
    `place_nerf_params`) renders split: each rank evaluates its channels
    of every split plane and line (`split_field`). An encoded field
    (`CompressedField`) stays whole on every rank, as the reference's
    `stream_sharding` places it, and every rank samples its streams
    through `bitmap_gather` / `coo_gather`."""

    def render_step(params, occ, rays_o, rays_d):
        dev = occ.device
        cubes = CubeSet(centers=torch.zeros((1, 3), device=dev),
                        valid=torch.ones((1,), dtype=torch.bool, device=dev),
                        count=1, radius=0.0, occ=occ)
        n = rays_o.shape[0]
        ro, rd = (rays_o, rays_d) if rules is None else shard_rays(
            rules, rays_o, rays_d)
        field = params
        if _on_model(rules) and isinstance(params, (
                dict, field_lib.DenseField)):
            dense = field_lib.as_backend(params, cfg).params
            field = split_field(cfg, place_nerf_params(cfg, dense, rules),
                                rules)
        rgb, _ = rendering.render_uniform(field, cfg, cubes, ro, rd)
        return gather_rays(rules, rgb, n)

    return render_step


def build_nerf_train_step(cfg: NeRFConfig, opt,
                          rules: Optional[AxisRules] = None):
    """One optimizer step on a params dict and a batch {"rays_o",
    "rays_d", "rgb"}: the uniform render without occupancy, loss = MSE +
    sigma_sparsity_l1 * L1 + tv_weight * TV (`train.loss_and_grads`),
    then `opt.update`. Returns (params, optimizer state, loss).

    With `rules`, each rank takes its slice of the batch (`shard_rays`'s
    split over "data") and the data group averages the loss and the
    gradients, so the step is the one-device step: the MSE is the mean
    over the whole batch, and the L1 and TV terms, equal on every rank,
    count once. On a "model" axis the step runs on params placed by
    `place_nerf_params` (whole params, and an AdamW state made from them,
    are placed by the step): each rank evaluates its channels of every
    split plane and line (`split_field`), the L1 and TV terms are its
    shards' shares reduced over "model", the gradients are averaged over
    "data" leaf by leaf on their local parts, and `opt.update` runs on
    the placed tree, so the returned params and the AdamW moments hold
    R / m channels of every split leaf on each rank."""

    def train_step(params, opt_state, batch):
        if _on_model(rules):
            params = place_nerf_params(cfg, params, rules)
            opt_state = _place_state(opt_state, params, rules)
            field = split_field(cfg, params, rules)
        else:
            field = field_lib.DenseField(params, cfg)
        parts, i = _split(rules, batch["rays_o"].shape[0])
        n = batch["rays_o"].shape[0] // parts
        part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, _mse, grads = train_lib.loss_and_grads(
            field, cfg, part["rays_o"], part["rays_d"], part["rgb"])
        if parts > 1:
            # one all-reduce of every gradient and the loss, averaged
            names = list(grads)
            flat = torch.cat([grads[k].reshape(-1) for k in names]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=rules.mesh.group("data"))
            flat = flat / parts
            out, at = {}, 0
            for k in names:
                out[k] = flat[at:at + grads[k].numel()].view_as(grads[k])
                at += grads[k].numel()
            grads, loss = out, flat[-1]
        if _on_model(rules):
            grads = {k: placed_like(g, params[k]) for k, g in grads.items()}
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step
