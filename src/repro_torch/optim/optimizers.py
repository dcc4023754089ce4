"""Optimizers as pairs of pure functions over trees of tensors (nested
dicts; NeRF training passes a flat one). The port of
`repro/optim/optimizers.py`: `Optimizer`, `clip_by_global_norm`, `adamw`,
`adafactor`, `sgd` and the size rule `pick_optimizer`.

Not `torch.optim`: `torch.optim.AdamW` computes the same update in exact
arithmetic, but it divides sqrt(v) by sqrt(bc2) rather than taking
sqrt(v / bc2), and decays the weights in a multiply of their own, so its
floats differ in the last bits. Here every operation is the reference's,
in float32: the bias corrections 1 - b ** step are computed in float32,
constants enter as float32 0-dim tensors (a CUDA tensor divided by a
Python scalar is a product with its reciprocal), and roots of values go
through `core.rendering.sqrt_rn` (PyTorch's vectorised CPU sqrt is not
correctly rounded; XLA's and the card's are).

Each update works leaf by leaf and frees a leaf's float32 temporaries
before the next: grok-1's expert leaves are 6.4 GB each in float32.
Nothing passed in is updated in place.

On a mesh of several ranks the trees are placed (DTensors): `init`
places each state leaf as `launch.steps.opt_state_spec` says (m and v as
their param; adafactor's vr without the param's last dim, vc without the
one before it), and every update runs on each rank's local shards. A
reduction over a dim that a leaf may split (the global norm, adafactor's
row and column means, its denominator and the update's RMS) is summed
on the shard and then over the mesh dims that split that dim, and only
those (`models.sharding.sum_over`, `shard_sums`), so that no replica is
counted twice and every rank gets the same value.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.rendering import sqrt_rn
from repro_torch.models.common import tree_map
from repro_torch.models.sharding import (local_part, placed_like,
                                         placed_zeros, shard_sums,
                                         split_dims, sum_over)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]
    name: str = "opt"


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in the reference's order (`jax.tree.leaves`:
    keys sorted; None is an empty subtree)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def _unzip(fn, n: int, tree, *rest):
    """`fn(leaf, *rest_leaves)` -> an n-tuple at every leaf of `tree`
    (nested dicts; `rest` share its structure down to its leaves, where
    they may hold subtrees); returns n trees of `tree`'s structure. The
    leaves are visited one after another, so a leaf's temporaries die
    before the next leaf's are made."""
    if isinstance(tree, dict):
        parts = {k: _unzip(fn, n, v, *(r[k] for r in rest))
                 for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in tree} for i in range(n))
    return fn(tree, *rest)


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _step_scale(schedule, step, lr, dev) -> torch.Tensor:
    """lr x schedule(step) in float32 (lr alone without a schedule)."""
    lr_t = _f32(lr, dev)
    return lr_t * schedule(step) if schedule is not None else lr_t


def _first_device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("an optimizer needs at least one parameter")
    return leaves[0].device


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / global norm), the global norm).
    The squares are summed in float32 leaf by leaf in the reference's leaf
    order (a placed leaf's on its shard, then over the ranks that split
    it: `shard_sums`); each leaf is scaled in float32 and cast back to
    its dtype."""
    leaves = tree_leaves(grads)
    dev = _first_device(grads)
    sums = shard_sums([torch.sum(torch.square(local_part(g).to(
        torch.float32))) for g in leaves], leaves)
    total = None
    for s in sums:
        total = s if total is None else total + s
    gn = sqrt_rn(total)
    scale = torch.minimum(_f32(1.0, dev), _f32(max_norm, dev)
                          / torch.maximum(gn, _f32(1e-9, dev)))
    return tree_map(lambda g: placed_like((local_part(g).to(torch.float32)
                                           * scale).to(g.dtype), g),
                    grads), gn


def _on_shards(fn):
    """`fn` over the local shards of its tensor arguments (and of a dict
    of them), its results placed as the arguments they stand for:
    `fn(p, g, *state) -> (new p, *new state)` (a dict result as the dict
    argument at the same place after p and g)."""
    def run(p, g, *state):
        out = fn(local_part(p), local_part(g), *(
            {k: local_part(v) for k, v in t.items()} if isinstance(t, dict)
            else local_part(t) for t in state), split=_Split(p))
        like = (p,) + state
        return tuple({k: placed_like(v, like[i][k]) for k, v in o.items()}
                     if isinstance(o, dict) else placed_like(o, like[i])
                     for i, o in enumerate(out))
    return run


class _Split:
    """The means of one leaf's update over dims its DTensor may split:
    `mean` over one dim of the param, `mean_all` over every element, each
    summed on this rank's shard, then over the mesh dims that split the
    dims it sums, then divided by the whole count. A plain leaf, or dims
    that no mesh dim splits: `torch.mean`."""

    def __init__(self, p):
        self.p = p
        self.dm = getattr(p, "device_mesh", None)

    def mean(self, t, dim: int, param_dim: Optional[int] = None,
             keepdim: bool = False):
        """The mean of local `t` over its dim `dim`, which is the param's
        dim `param_dim` (default: `dim`; both may count from the end)."""
        axis = dim if param_dim is None else param_dim
        over = split_dims(self.p, axis)
        if not over:
            return torch.mean(t, dim=dim, keepdim=keepdim)
        n = self.p.shape[axis]
        return sum_over(torch.sum(t, dim=dim, keepdim=keepdim), self.dm,
                        over) / _f32(n, t.device)

    def mean_all(self, t):
        over = split_dims(self.p)
        if not over:
            return torch.mean(t)
        return sum_over(torch.sum(t), self.dm, over) / _f32(
            self.p.numel(), t.device)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, wd: float = 0.0,
          schedule: Optional[Callable] = None) -> Optimizer:
    """AdamW over a tree of tensors: `init(params)` -> state {"step" (int32
    0-dim), "m", "v" (float32 trees like params)}; `update(grads, state,
    params, _loss=None)` -> (new params, new state). `schedule(step)`
    scales lr (step counted from 1)."""
    def init(params):
        zeros = lambda p: placed_zeros(p.shape, p)  # noqa: E731
        return {
            "step": torch.zeros((), dtype=torch.int32,
                                device=_first_device(params)),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
        }

    def update(grads, state, params, _loss=None):
        step = state["step"] + 1
        dev = step.device
        lr_t = _step_scale(schedule, step, lr, dev)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(_f32(b1, dev), stepf)
        bc2 = 1.0 - torch.pow(_f32(b2, dev), stepf)
        c_b1, c_b2, c_eps = _f32(b1, dev), _f32(b2, dev), _f32(eps, dev)
        c_1b1, c_1b2 = _f32(1 - b1, dev), _f32(1 - b2, dev)
        c_wd = _f32(wd, dev)

        @_on_shards
        def upd(p, g, m, v, split):
            g = g.to(torch.float32)
            m2 = c_b1 * m + c_1b1 * g
            v2 = c_b2 * v + c_1b2 * g * g
            del g
            u = (m2 / bc1) / (sqrt_rn(v2 / bc2) + c_eps)
            if wd:
                u = u + c_wd * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), m2, v2

        p, m, v = _unzip(upd, 3, params, grads, state["m"], state["v"])
        return p, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, "adamw")


def _drop(pls, ndim: int, k: int) -> tuple:
    """The placements of a param's state that drops the param's dim
    `ndim - k` (adafactor's vr: k = 1; vc: k = 2): a shard of that dim is
    whole, a shard of a later dim moves one place down."""
    from torch.distributed.tensor import Replicate, Shard
    gone = ndim - k
    return tuple(Replicate() if p.is_shard() and p.dim == gone else
                 Shard(p.dim - 1) if p.is_shard() and p.dim > gone else p
                 for p in pls)


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_thresh: float = 1.0,
              schedule: Optional[Callable] = None) -> Optimizer:
    """Factored second moment (row and column means) for tensors of 2 or
    more dims whose last two dims are both >= 2, a full one otherwise; no
    momentum, no master copy; updates clipped to RMS clip_thresh."""

    def _factored(p) -> bool:
        return p.dim() >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2

    def init(params):
        def one(p):
            if _factored(p):
                pls = tuple(getattr(p, "placements", ()))
                return {"vr": placed_zeros(p.shape[:-1], p,
                                           _drop(pls, p.dim(), 1)),
                        "vc": placed_zeros(p.shape[:-2] + p.shape[-1:], p,
                                           _drop(pls, p.dim(), 2))}
            return {"v": placed_zeros(p.shape, p)}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params)),
                "v": tree_map(one, params)}

    def update(grads, state, params, _loss=None):
        step = state["step"] + 1
        dev = step.device
        lr_t = _step_scale(schedule, step, lr, dev)
        beta = 1.0 - torch.pow(step.to(torch.float32) + 1.0,
                               _f32(-decay, dev))
        one_beta = 1.0 - beta
        c_eps, c_one = _f32(eps, dev), _f32(1.0, dev)
        c_clip, c_tiny = _f32(clip_thresh, dev), _f32(1e-12, dev)

        @_on_shards
        def upd(p, g, v, split):
            # the float32 temporaries of one leaf are freed as soon as
            # they are used; in-place ops touch only those temporaries
            g = g.to(torch.float32)
            g2 = g * g
            g2.add_(c_eps)
            if "vr" in v:
                vr = beta * v["vr"] + one_beta * split.mean(g2, -1)
                vc = beta * v["vc"] + one_beta * split.mean(g2, -2)
                del g2
                denom = torch.maximum(split.mean(vr, -1, -2, keepdim=True),
                                      c_eps)
                u = g * torch.rsqrt(vr[..., None] / denom[..., None])
                del g
                u.mul_(torch.rsqrt(vc[..., None, :]))
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * v["v"] + one_beta * g2}
                del g2
                u = g * torch.rsqrt(nv["v"])
                del g
            rms = sqrt_rn(split.mean_all(torch.square(u)) + c_tiny)
            u.div_(torch.maximum(c_one, rms / c_clip))
            u.mul_(lr_t)
            p2 = p.to(torch.float32, copy=True)
            p2.sub_(u)
            del u
            return p2.to(p.dtype), nv

        p, v = _unzip(upd, 2, params, grads, state["v"])
        return p, {"step": step, "v": v}

    return Optimizer(init, update, "adafactor")


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params))}

    def update(grads, state, params, _loss=None):
        lr_t = _f32(lr, state["step"].device)

        @_on_shards
        def upd(pp, g, split):
            return ((pp.to(torch.float32) - lr_t * g.to(torch.float32)
                     ).to(pp.dtype),)
        p = tree_map(lambda pp, g: upd(pp, g)[0], params, grads)
        return p, {"step": state["step"] + 1}

    return Optimizer(init, update, "sgd")


ADAFACTOR_PARAM_THRESHOLD = 30_000_000_000  # 30B


def pick_optimizer(n_params: int, lr: float = 1e-4,
                   schedule: Optional[Callable] = None) -> Optimizer:
    """AdamW below 30B params, Adafactor at or above (the memory rule of
    the reference)."""
    if n_params >= ADAFACTOR_PARAM_THRESHOLD:
        return adafactor(lr=lr, schedule=schedule)
    return adamw(lr=lr, schedule=schedule)
