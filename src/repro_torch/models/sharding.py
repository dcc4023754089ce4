"""Logical-axis -> mesh-axis resolution and placement: the port of
`repro/models/sharding.py`, over DTensor.

Params and activations carry *logical* axis names ("embed", "mlp",
"heads", "vocab", "experts", "batch", "seq", ...). `AxisRules` maps each
logical name to a mesh axis (or tuple of axes). `resolve_spec` greedily
assigns mesh axes left to right over a tensor's dims, dropping an
assignment when

  (a) the mesh axis is already used by an earlier dim of the same tensor, or
  (b) the dim size does not divide the mesh-axis size.

A mesh is anything with `shape` (a dict axis -> size) and `axis_names`
(`launch.mesh` builds them over the process group, one rank per device).
A spec is a tuple with one entry per dim: a mesh axis, a tuple of axes,
or `fill` (the reference's `PartitionSpec` is a tuple of the same
entries). `placements` turns a spec into DTensor placements, one per
mesh dim, and `param_sharding` gives them for a whole param tree;
`place_params` puts a param tree on the mesh by them (the reference's
`jax.device_put(params, param_sharding(...))`): each rank keeps only its
shard of every leaf. `PlacingMaker` (`transformer.init_model(rules=)`)
places each leaf as it is drawn, so that no rank holds the whole tree.

On a mesh of several ranks the models run on DTensors, PyTorch's
counterpart of GSPMD: elementwise ops propagate placements, and
`shard_act` constrains an activation at the reference's sites (a
`redistribute` to its resolved spec; a dim the rules leave free keeps
the placement it has, as GSPMD lets it propagate). Products
(`contract`), attention cores, the embedding lookup, the cache writes
and the MoE dispatch run on each rank's local shards (`local_of`,
`from_local_like`), with their collectives explicit; every collective is
the port's own (`redistribute`), on every backend. On one rank, and without
rules, `shard_act` only checks the logical axes and the rest is plain
PyTorch.

Under autograd (the train step) those three helpers are
`torch.autograd.Function`s whose backward issues the transpose of the
forward's collectives through the same path: a gathered shard's gradient
is cut (or reduced and cut where it is a partial sum), a reduced partial
sum hands every rank the whole gradient, and a local shard's gradient is
a partial sum over the mesh dims where the shard is whole but the ranks
compute different results from it (`local_of(out=)`). DTensor's own
`from_local` / `to_local` backward is not used: it moves gradients with
the functional collectives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.common import PL, Maker, log_parse, tree_map

AxisEntry = Union[str, Tuple[str, ...], None]

# Default rules for the production meshes. `batch` spans the pure-data axes
# (pod + data on the multi-pod mesh); `embed` is the FSDP/ZeRO-3 param axis.
DEFAULT_PARAM_RULES: Dict[str, AxisEntry] = {
    "embed": "data",        # FSDP: shard d_model of weights over data
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    # q_lora is a contraction dim of the up-projections: sharding it would
    # all-reduce the full (B,S,H,e) q tensor every layer
    "q_lora": None,
    "kv_lora": None,
    "head_dim": None,
    "state": None,
    "stack": None,          # layer-stack axis of stacked params
}

DEFAULT_ACT_RULES: Dict[str, AxisEntry] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "cap": None,
    "head_dim": None,
    "state": None,
    "seq_model": "model",   # sequence-parallel attention (qwen / long ctx)
}


@dataclasses.dataclass
class AxisRules:
    mesh: Any
    param_rules: Dict[str, AxisEntry]
    act_rules: Dict[str, AxisEntry]

    def axis_size(self, entry: AxisEntry) -> int:
        if entry is None:
            return 1
        names = (entry,) if isinstance(entry, str) else entry
        n = 1
        for a in names:
            n *= self.mesh.shape[a]
        return n


def make_rules(mesh,
               param_overrides: Optional[Dict[str, AxisEntry]] = None,
               act_overrides: Optional[Dict[str, AxisEntry]] = None
               ) -> AxisRules:
    pr = dict(DEFAULT_PARAM_RULES)
    ar = dict(DEFAULT_ACT_RULES)
    mesh_axes = set(mesh.axis_names)
    if "pod" not in mesh_axes:
        ar["batch"] = "data"
    else:
        # on multi-pod meshes, shard FSDP params over (pod, data)
        pr["embed"] = ("pod", "data")
    if param_overrides:
        pr.update(param_overrides)
    if act_overrides:
        ar.update(act_overrides)
    return AxisRules(mesh=mesh, param_rules=pr, act_rules=ar)


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 rules: Dict[str, AxisEntry], ar: AxisRules,
                 fill=None) -> tuple:
    """Greedy left-to-right assignment with divisibility and reuse checks;
    unresolved dims get `fill`."""
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        entry = rules.get(name) if name else None
        if entry is None:
            parts.append(fill)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        # drop axes already used by this tensor
        names = tuple(a for a in names if a not in used and a in ar.mesh.shape)
        size = 1
        for a in names:
            size *= ar.mesh.shape[a]
        if not names or size <= 1 or dim % size != 0:
            parts.append(fill)
            continue
        used.update(names)
        parts.append(names[0] if len(names) == 1 else names)
    return tuple(parts)


# --------------------------------------------------------------------------
# Activation constraints: a thread-local rules context, so model code is
# written once and runs with or without rules
# --------------------------------------------------------------------------

_CTX = threading.local()


class use_rules:
    def __init__(self, rules: Optional[AxisRules]):
        self.rules = rules

    def __enter__(self):
        self.prev = getattr(_CTX, "rules", None)
        _CTX.rules = self.rules
        return self.rules

    def __exit__(self, *exc):
        _CTX.rules = self.prev
        return False


def current_rules() -> Optional[AxisRules]:
    return getattr(_CTX, "rules", None)


def mesh_size(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n


def on_ranks(rules: Optional[AxisRules] = None) -> bool:
    """Whether `rules` (default: the current ones) span several ranks."""
    rules = current_rules() if rules is None else rules
    return rules is not None and mesh_size(rules.mesh) > 1


class _Unconstrained:
    """The fill of an activation's free dims (the reference's
    `P.UNCONSTRAINED`)."""

    def __repr__(self):
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


def _device_mesh(mesh):
    """The DeviceMesh of a mesh of `launch.mesh` (or a DeviceMesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return mesh
    if getattr(mesh, "device_mesh", None) is None:
        raise ValueError(
            f"the mesh {dict(mesh.shape)} carries a shape only: build it "
            f"over a process group (launch.mesh) to place tensors on it")
    return mesh.device_mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _act_placements(x, spec, mesh) -> tuple:
    """The placements of activation `x` constrained to `spec`: each mesh
    axis the spec names shards its dim; an axis it does not name keeps a
    shard of a free (UNCONSTRAINED) dim and is replicated otherwise (a
    partial sum is reduced)."""
    named = placements([None if e is UNCONSTRAINED else e for e in spec],
                       mesh)
    return tuple(
        have if (not want.is_shard() and have.is_shard()
                 and spec[have.dim] is UNCONSTRAINED) else want
        for want, have in zip(named, x.placements))


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain an activation to its logical axes' resolved spec, as the
    reference's `with_sharding_constraint`: without rules it returns `x`
    unchecked, on one rank it checks the axes and returns `x`, and on a
    mesh of several ranks it redistributes the DTensor `x` (a tensor not
    on the mesh raises: no module quietly computes off it)."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"logical {logical} vs shape {tuple(x.shape)}")
    if mesh_size(rules.mesh) == 1:
        return x
    dm = _device_mesh(rules.mesh)
    if not is_dtensor(x):
        raise TypeError(
            f"an activation {tuple(x.shape)} ({logical}) that is not on the "
            f"mesh {dict(rules.mesh.shape)}")
    spec = resolve_spec(tuple(x.shape), logical, rules.act_rules, rules,
                        fill=UNCONSTRAINED)
    want = _act_placements(x, spec, rules.mesh)
    return redistribute(x, want)


# --------------------------------------------------------------------------
# Placement on a live mesh (`launch.mesh` over a process group)
# --------------------------------------------------------------------------


def _chunk(n: int, k: int, r: int) -> tuple:
    """(start, size) of piece r of a dim of n split k ways as DTensor
    splits it (`torch.chunk`: pieces of ceil(n / k), the last ones short
    or empty)."""
    full = -(-n // k)
    start = min(r * full, n)
    return start, min(full, n - start)


def local_slices(shape: Sequence[int], pls: Sequence, dm) -> tuple:
    """This rank's slice of each dim of a tensor of global `shape` placed
    by `pls` on DeviceMesh `dm` (shards nest in mesh-dim order, and split
    as `torch.chunk` does, as DTensor's)."""
    lo = [0] * len(shape)
    n = list(shape)
    for i, p in enumerate(pls):
        k = dm.size(i)
        if p is None or not p.is_shard() or k == 1:
            continue
        start, size = _chunk(n[p.dim], k, dm.get_local_rank(i))
        lo[p.dim] += start
        n[p.dim] = size
    return tuple(slice(a, a + b) for a, b in zip(lo, n))


def _stride(shape) -> tuple:
    return torch.empty(tuple(shape), device="meta").stride()


def _span(shape, pls, dm) -> list:
    """The length of each dim of a tensor of `shape` after the shards of
    `pls` (the first mesh dims' placements) cut it on this rank."""
    return [sl.stop - sl.start for sl in local_slices(
        shape, list(pls) + [None] * (dm.ndim - len(pls)), dm)]


def _move(x: torch.Tensor, pls: Sequence) -> torch.Tensor:
    """`redistribute`'s data movement, outside autograd: DTensor `x` with
    placements `pls` (a new DTensor; `x` itself when nothing moves). Each
    mesh dim that changes is made whole (`all_gather_into_tensor`,
    `all_reduce`), last mesh dim first, then cut; a partial sum that
    becomes a shard of a dim no other mesh dim splits is reduce-scattered
    instead (`reduce_scatter_tensor`: gloo carries it, on CUDA tensors
    too)."""
    pls = tuple(pls)
    have = tuple(x.placements)
    if have == pls:
        return x
    dm = x.device_mesh
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    local = x.to_local()
    cur = list(have)
    # shards nest in mesh-dim order: a mesh dim after one that changes,
    # splitting (before or after) a tensor dim that the changing one
    # splits (before or after), holds or will hold a piece of its piece,
    # so it is made whole first and cut again after it
    change = [h != w for h, w in zip(have, pls)]
    for i in range(len(cur)):
        if not change[i]:
            continue
        dims = {p.dim for p in (cur[i], pls[i]) if p.is_shard()}
        for j in range(i + 1, len(cur)):
            if any(p.is_shard() and p.dim in dims for p in (cur[j], pls[j])):
                change[j] = True
    for i in reversed(range(len(cur))):
        if not change[i] or cur[i].is_replicate():
            continue
        group = dm.get_group(i)
        if _scatters(cur, pls, i):
            # a partial sum to a shard of a dim no other mesh dim splits:
            # reduce-scatter, the padded pieces as torch.chunk cuts them
            d, n = pls[i].dim, dm.size(i)
            span = local.shape[d]
            full = -(-span // n)
            part = local.movedim(d, 0)
            if part.shape[0] < n * full:
                part = torch.cat([part, part.new_zeros(
                    (n * full - part.shape[0],) + part.shape[1:])])
            part = part.contiguous()
            piece = part.new_empty((full,) + part.shape[1:])
            dist.reduce_scatter_tensor(piece, part, group=group)
            size = _chunk(span, n, dm.get_local_rank(i))[1]
            local = piece[:size].movedim(0, d)
            if cur[i].reduce_op == "avg":
                local = local / n
            cur[i] = pls[i]
            continue
        if cur[i].is_partial():
            op = cur[i].reduce_op
            # a copy: the all-reduce writes in place, and `x` keeps its own
            local = local.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(local, group=group, op={
                "sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
                "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op])
            if op == "avg":
                local = local / dm.size(i)
        else:
            d, n = cur[i].dim, dm.size(i)
            # the piece's length along d: that of the tensor as this mesh
            # dim sees it (the mesh dims before it have cut it already)
            span = _span(x.shape, cur[:i], dm)[d]
            full = -(-span // n)
            part = local.movedim(d, 0)
            if part.shape[0] < full:        # a short last piece: padded
                part = torch.cat([part, part.new_zeros(
                    (full - part.shape[0],) + part.shape[1:])])
            part = part.contiguous()
            gathered = part.new_empty((n * full,) + part.shape[1:])
            dist.all_gather_into_tensor(gathered, part, group=group)
            local = torch.cat([gathered[r * full:r * full + sz] for r, sz in
                               ((r, _chunk(span, n, r)[1])
                                for r in range(n))]).movedim(0, d)
        cur[i] = Replicate()
    for i, p in enumerate(pls):
        if p.is_shard() and cur[i] != p:
            if not cur[i].is_replicate():
                raise ValueError(f"redistributing {have} to {pls}")
            start, size = _chunk(local.shape[p.dim], dm.size(i),
                                 dm.get_local_rank(i))
            local = local.narrow(p.dim, start, size)
            cur[i] = p
        elif p.is_partial() and not cur[i].is_partial():
            raise ValueError(f"redistributing {have} to {pls}")
    return DTensor.from_local(local.contiguous(), dm, pls, run_check=False,
                              shape=x.shape, stride=_stride(x.shape))


def _scatters(cur, pls, i: int) -> bool:
    """Whether `_move` takes mesh dim i from a partial sum straight to a
    shard by one reduce-scatter: a sum or mean to Shard(d), where no
    other mesh dim splits d, before or after."""
    p = pls[i]
    if not (cur[i].is_partial() and cur[i].reduce_op in ("sum", "avg")
            and p.is_shard()):
        return False
    return not any(q.is_shard() and q.dim == p.dim
                   for j in range(len(cur)) if j != i
                   for q in (cur[j], pls[j]))


def _grad_of(pls: Sequence) -> tuple:
    """The placements a gradient takes where the value held `pls`: those
    of the value, but a partial sum's gradient is whole on every rank
    (each partial adds into the sum once, so each gets the whole
    gradient of the sum)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() else p for p in pls)


def _as_dtensor(g, dm, pls, shape) -> torch.Tensor:
    """A gradient as the DTensor it stands for: a DTensor as it is; a
    plain tensor (this rank's local gradient) with placements `pls`."""
    if is_dtensor(g):
        return g
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(g.contiguous(), dm, tuple(pls),
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))


class _Redistribute(torch.autograd.Function):
    """`_move` with its transpose as the backward, on the same groups by
    the same path: the gradient, as it comes, is moved to the placements
    `_grad_of` gives the input's. Per mesh dim that is a local cut where
    the forward gathered a shard and the gradient is whole, a
    reduce-scatter where the gradient is a partial sum, nothing where the
    forward reduced a partial sum, and a gather where the forward cut a
    whole value into shards."""

    @staticmethod
    def forward(ctx, x, pls):
        ctx.have = tuple(x.placements)
        ctx.meta = (x.device_mesh, tuple(x.shape))
        return _move(x, pls)

    @staticmethod
    def backward(ctx, g):
        dm, shape = ctx.meta
        g = _as_dtensor(g, dm, ctx.have, shape)
        return _move(g, _grad_of(ctx.have)), None


class _LocalOf(torch.autograd.Function):
    """This rank's local shard of DTensor `x` moved to `pls` (cast to
    `dtype`); backward: the local gradient as a DTensor placed `grads`,
    moved back to `x`'s placements (in `dtype`: a float32 product's
    partial sums are reduced in float32), then cast to `x`'s dtype."""

    @staticmethod
    def forward(ctx, x, pls, grads, dtype):
        ctx.have = tuple(x.placements)
        ctx.meta = (x.device_mesh, tuple(x.shape), x.dtype, tuple(grads))
        local = _move(x, pls).to_local()
        return local if dtype is None else local.to(dtype)

    @staticmethod
    def backward(ctx, g):
        dm, shape, dtype, grads = ctx.meta
        g = _as_dtensor(g, dm, grads, shape)
        return _move(g, _grad_of(ctx.have)).to(dtype), None, None, None


class _FromLocal(torch.autograd.Function):
    """A DTensor from this rank's `local` shard or partial sum; backward:
    the gradient moved to `_grad_of(pls)`, this rank's local piece."""

    @staticmethod
    def forward(ctx, local, pls, shape, dm):
        from torch.distributed.tensor import DTensor
        ctx.meta = (tuple(pls), dm, tuple(shape))
        return DTensor.from_local(local, dm, tuple(pls), run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_stride(shape))

    @staticmethod
    def backward(ctx, g):
        pls, dm, shape = ctx.meta
        g = _as_dtensor(g, dm, _grad_of(pls), shape)
        return _move(g, _grad_of(pls)).to_local(), None, None, None


def redistribute(x: torch.Tensor, pls: Sequence) -> torch.Tensor:
    """DTensor `x` with placements `pls` on its mesh, on every backend by
    the same path (`_move`): each mesh dim that changes is made whole
    with `all_gather_into_tensor` or `all_reduce` in its group, last mesh
    dim first, and then cut locally, or reduce-scattered straight to its
    shard. DTensor's own `x.redistribute` is not
    used: over gloo on CUDA tensors the all-gather of the functional
    collectives that it calls reads device memory as host memory (the
    ranks die with SIGSEGV; torch 2.11, two ranks on an H100), and one
    path is the one that the CPU tests hold against the reference. Under
    autograd the backward is the transpose, by the same path
    (`_Redistribute`)."""
    pls = tuple(pls)
    if tuple(x.placements) == pls:
        return x
    return _Redistribute.apply(x, pls)


def whole_on_mesh(x: torch.Tensor) -> torch.Tensor:
    """DTensor `x` replicated on every rank of its mesh (a DTensor); a
    plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, (Replicate(),) * x.device_mesh.ndim)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (`redistribute` to
    replicas); a plain tensor as it is. Under autograd every rank is
    taken to compute the same from it (its gradient is whole)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return local_of(x, (Replicate(),) * x.device_mesh.ndim)


def sum_over(local: torch.Tensor, dm, mesh_dims: Sequence[int]
             ) -> torch.Tensor:
    """A plain tensor summed over the ranks of the mesh dims `mesh_dims`
    of DeviceMesh `dm` (an all-reduce in each one's group, by
    `redistribute`'s path), outside autograd; the same on each of those
    ranks. No mesh dim: `local` as it is."""
    mesh_dims = set(mesh_dims)
    if not mesh_dims:
        return local
    from torch.distributed.tensor import Partial, Replicate
    pls = tuple(Partial() if i in mesh_dims else Replicate()
                for i in range(dm.ndim))
    return _move(_as_dtensor(local, dm, pls, local.shape),
                 (Replicate(),) * dm.ndim).to_local()


def split_dims(t: torch.Tensor, dim: Optional[int] = None) -> list:
    """The mesh dims that split DTensor `t` (along tensor dim `dim` only,
    when given); none for a plain tensor."""
    if not is_dtensor(t):
        return []
    if dim is not None:
        dim %= t.dim()
    return [i for i, p in enumerate(t.placements)
            if p.is_shard() and (dim is None or p.dim == dim)]


def shard_sums(sums: Sequence[torch.Tensor], like: Sequence[torch.Tensor]
               ) -> list:
    """Each `sums[j]`, a 0-dim sum over this rank's shard of `like[j]`, as
    the sum over the whole tensor, equal on every rank: the ranks that
    hold one shard twice (along a mesh dim that does not split the
    tensor) count it once, and one all-reduce over the mesh adds the
    rest. Plain tensors (one rank): `sums` as they are."""
    dts = [t for t in like if is_dtensor(t)]
    if not dts:
        return list(sums)
    dm = dts[0].device_mesh
    keep = [all(p.is_shard() or dm.get_local_rank(i) == 0
                for i, p in enumerate(t.placements)) for t in like]
    vec = torch.stack([v if k else torch.zeros_like(v)
                       for v, k in zip(sums, keep)])
    return list(sum_over(vec, dm, range(dm.ndim)).unbind(0))


def placed_like(local: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`local` as a DTensor placed as DTensor `t` (this rank's shard of a
    tensor of t's shape), outside autograd; a plain `t`: `local`."""
    if not is_dtensor(t):
        return local
    return _as_dtensor(local, t.device_mesh, t.placements, t.shape)


def placed_zeros(shape, like: torch.Tensor, pls: Optional[Sequence] = None,
                 dtype=torch.float32) -> torch.Tensor:
    """Zeros of global `shape` in `dtype` on `like`'s device; for a
    DTensor `like`, this rank's shard of them placed `pls` (default:
    like's placements) on its mesh."""
    if not is_dtensor(like):
        return torch.zeros(tuple(shape), dtype=dtype, device=like.device)
    dm = like.device_mesh
    pls = tuple(like.placements) if pls is None else tuple(pls)
    sl = local_slices(shape, pls, dm)
    return _as_dtensor(torch.zeros([x.stop - x.start for x in sl],
                                   dtype=dtype, device=like.device),
                       dm, pls, shape)


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of DTensor `t` outside autograd; a plain `t` as
    it is."""
    return t.to_local() if is_dtensor(t) else t


def place(t: torch.Tensor, pls: Sequence, mesh,
          device: Optional[torch.device] = None) -> torch.Tensor:
    """`t` as a DTensor on `mesh` (a mesh of `launch.mesh`, or a
    DeviceMesh) with placements `pls`: a DTensor is redistributed; a
    plain tensor, the same whole value on every rank, is cut to this
    rank's shard locally (no collective), and the shard is a copy of its
    own, so the whole tensor can be freed. `device` (None: t's) is where
    the shard goes: the cut comes first, so the whole tensor never
    reaches it (a checkpoint's leaf, read on the host). A Partial
    placement is not a placement of a whole value and raises."""
    from torch.distributed.tensor import DTensor
    dm = _device_mesh(mesh)
    pls = tuple(pls)
    if any(p.is_partial() for p in pls):
        raise ValueError(f"placing a whole tensor as {pls}")
    if isinstance(t, DTensor):
        return redistribute(t, pls)
    local = t[local_slices(t.shape, pls, dm)]
    if device is not None and torch.device(device) != local.device:
        local = local.to(device, memory_format=torch.contiguous_format)
    elif any(p.is_shard() for p in pls):
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, dm, pls, run_check=False,
                              shape=t.shape, stride=_stride(t.shape))


def place_tree(tree, pls_tree, mesh):
    """`place` over a tree and its placements tree (None stays None)."""
    return tree_map(lambda t, pls: place(t, pls, mesh), tree, pls_tree)


def require_placed(tree, what: str, rules: Optional[AxisRules] = None):
    """Raise unless every tensor leaf of `tree` is a DTensor on a mesh of
    several ranks (one rank: nothing to check), so that no plain tensor
    is taken for a replicated one."""
    if not on_ranks(rules):
        return
    def check(t):
        if isinstance(t, torch.Tensor) and not is_dtensor(t):
            raise TypeError(f"{what}: a leaf {tuple(t.shape)} is not placed "
                            f"on the mesh (models.sharding.place_params)")
        return t
    tree_map(check, tree)


def mesh_context(rules: Optional[AxisRules] = None):
    """The context a model runs in on a mesh of several ranks: DTensor's
    implicit replication, so that the constants a module builds (positions,
    masks, slot indices; equal on every rank) combine with DTensors as
    replicated ones. It nests: DTensor's own `implicit_replication`
    switches the replication off when it exits, so only the outermost of
    nested contexts enters it (a train step's update runs after the
    model's forward has left its own). One rank: nothing."""
    if not on_ranks(rules):
        return contextlib.nullcontext()
    return _mesh_context()


@contextlib.contextmanager
def _mesh_context():
    depth = getattr(_CTX, "implicit", 0)
    _CTX.implicit = depth + 1
    try:
        if depth:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
    finally:
        _CTX.implicit = depth


def _lead_letter(i: int, ins, ops, out: str):
    """The output letter that the first operand (the activation) is split
    along on mesh dim `i`, if any: the result keeps that layout, so that
    it meets the residual stream as it is (an elementwise op between
    DTensors split along different dims makes DTensor move one of them
    with its own collectives)."""
    o = ops[0]
    if is_dtensor(o):
        p = o.placements[i]
        if p.is_shard() and ins[0][p.dim] in out:
            return ins[0][p.dim]
    return None


def _split_letter(i: int, ins, ops, out: str, out_bytes: int):
    """The letter mesh dim `i` splits an einsum along (None: no split),
    by the bytes each choice moves there: an operand split along another
    letter, or holding a partial sum, is gathered or reduced whole; a
    whole operand is cut locally for free; a summed letter leaves a
    partial result of `out_bytes` to reduce. Ties go to the earlier
    operand's letter."""
    def held(o):
        return o.placements[i] if is_dtensor(o) else None

    cands = []
    for letters, o in zip(ins, ops):
        p = held(o)
        if p is not None and p.is_shard() and letters[p.dim] not in cands:
            cands.append(letters[p.dim])
    lead = _lead_letter(i, ins, ops, out)
    best, best_cost = None, None
    for c in cands + [None]:
        cost = 0 if c is None or c in out else out_bytes
        if lead is not None and c != lead:
            cost += out_bytes           # the result laid out as the lead's
        for letters, o in zip(ins, ops):
            p = held(o)
            if p is None or p.is_replicate():
                continue
            if p.is_partial() or letters[p.dim] != c:
                cost += o.numel() * o.element_size()
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def contract(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` (operands of mixed float dtypes cast to their
    promoted dtype first, as jnp does), run on each rank's shards on a
    mesh of several ranks.

    On each mesh axis the product splits along one letter, or none: of
    the letters an operand is split along there, the one that moves the
    fewest bytes (`_split_letter`). Every operand that has the letter is
    split along it there and the others are whole there. The ranks then
    multiply their shards as plain tensors, and the result is split along
    that letter, or, where the letter is summed, a partial sum. So a
    weight split over "data" (FSDP's "embed") is not gathered where
    splitting the activations along its dim moves fewer bytes, as at
    decode. In bf16 each partial sum would round before the ranks add them,
    where one device's product accumulates in float32 and rounds once: so
    a product that splits a sum runs in float32 (bf16 operands widen
    exactly), its partial sums are reduced in float32, and the result is
    cast back, one rounding as on one device. DTensor's own einsum
    flattens dims it may not flatten when a later one is split (torch
    2.11: "Attempted to flatten multiple dimensions"). Under autograd an
    operand whole on a mesh dim that splits the product gets a partial
    gradient there, reduced back to its placements: a product that is
    differentiated and split runs in float32 as well, so that those
    partial sums too are reduced in float32 and rounded once."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    ops = tuple(o.to(dt) for o in ops)
    dts = [o for o in ops if is_dtensor(o)]
    if not dts or not on_ranks():
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = dts[0].device_mesh
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    size = {c: n for letters, o in zip(ins, ops)
            for c, n in zip(letters, o.shape)}
    out_bytes = 4
    for c in out:
        out_bytes *= size[c]
    split = [_split_letter(i, ins, ops, out, out_bytes)
             for i in range(dm.ndim)]
    y_pls = tuple(Shard(out.index(c)) if c is not None and c in out
                  else Partial() if c is not None else Replicate()
                  for c in split)
    op_pls = [tuple(Shard(letters.index(c)) if c is not None and c in letters
                    else Replicate() for c in split) for letters in ins]
    summed = any(c is not None and c not in out for c in split)
    # under autograd an operand whole on a mesh dim that splits the
    # product gets a partial gradient: the product runs in float32 so that
    # it is reduced in float32 too
    partial = torch.is_grad_enabled() and any(
        o.requires_grad and grads_where(p, y_pls) != p
        for o, p in zip(ops, op_pls))
    cd = torch.float32 if (summed or partial) and dt != torch.float64 else dt
    local = [local_of(o, p, out=y_pls, dtype=cd) if is_dtensor(o)
             else o[local_slices(o.shape, p, dm)].to(cd)
             for o, p in zip(ops, op_pls)]
    y = from_local_like(torch.einsum(eq, *local), y_pls,
                        tuple(size[c] for c in out), dm)
    want = []
    for i, p in enumerate(y_pls):
        lead = _lead_letter(i, ins, ops, out)
        want.append(Shard(out.index(lead)) if lead is not None else
                    Replicate() if p.is_partial() else p)
    return redistribute(y, want).to(dt)


def grads_where(pls: Sequence, out: Sequence) -> tuple:
    """The placements of the gradient of a local shard taken by `pls`
    when the ranks compute from it a result placed `out`: where the shard
    is whole on a mesh dim but the results differ across that dim (split,
    or partial sums), each rank's gradient is its share of a sum
    (Partial); elsewhere it is placed as the shard is (whole where every
    rank computed the same)."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if p.is_replicate() and not o.is_replicate()
                 else p for p, o in zip(pls, out))


def local_of(x: torch.Tensor, pls: Sequence, out: Optional[Sequence] = None,
             dtype=None) -> torch.Tensor:
    """The local shard of DTensor `x` after redistributing it to `pls` on
    its own mesh (cast to `dtype`). Under autograd `out` says how the
    result the rank computes from the shard is placed (`grads_where`;
    None: as the shard, every rank computing the same where it is whole);
    the backward moves the gradient back to `x`'s placements through the
    port's collectives (`_LocalOf`)."""
    pls = tuple(pls)
    grads = pls if out is None else grads_where(pls, out)
    return _LocalOf.apply(x, pls, grads, dtype)


def from_local_like(local: torch.Tensor, pls: Sequence, shape: Sequence[int],
                    dm) -> torch.Tensor:
    """A DTensor of global `shape` on DeviceMesh `dm` from this rank's
    `local` shard (or partial sum, under a Partial placement); under
    autograd the backward hands each rank its piece of the gradient (the
    whole gradient to a partial sum: `_FromLocal`)."""
    return _FromLocal.apply(local, tuple(pls), tuple(shape), dm)


def _row_placements(x: torch.Tensor):
    """(the column mesh dims of DTensor `x`, those splitting its last dim;
    x's placements with the shards kept and the rest whole; its rows'
    placements, a shard of a leading dim kept and the rest whole)."""
    from torch.distributed.tensor import Replicate
    last = x.dim() - 1
    cols = [p.is_shard() and p.dim == last for p in x.placements]
    x_pls = tuple(q if q.is_shard() else Replicate() for q in x.placements)
    r_pls = tuple(q if (q.is_shard() and q.dim < last) else Replicate()
                  for q in x.placements)
    return cols, x_pls, r_pls


def _pick_local(xl, x, x_pls, idx, r_pls):
    """This rank's x[..., idx] from its local shard `xl` of DTensor `x`
    (placed `x_pls`): the entries whose index falls in its columns, zeros
    for the others."""
    il = (local_of(idx, r_pls) if is_dtensor(idx)
          else idx[local_slices(idx.shape, r_pls, x.device_mesh)])
    il = il.long() - local_slices(x.shape, x_pls, x.device_mesh)[-1].start
    hit = (il >= 0) & (il < xl.shape[-1])
    g = torch.gather(xl, -1, il.clamp(0, xl.shape[-1] - 1)[..., None])
    return torch.where(hit, g[..., 0], torch.zeros((), dtype=xl.dtype,
                                                    device=xl.device))


def pick_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] row by row (`torch.gather` on the last dim) for a
    DTensor `x` whose last dim may be split (the logits' "vocab"): each
    rank reads the indices that fall in its columns (zeros elsewhere)
    and the result is a partial sum over those axes; its gradient lands
    only on the rank whose columns hold the index. DTensor's own gather
    strategy fails on columns split under rows split by batch."""
    from torch.distributed.tensor import Partial
    cols, x_pls, r_pls = _row_placements(x)
    g_pls = tuple(Partial() if c else q for c, q in zip(cols, r_pls))
    xl = local_of(x, x_pls, out=g_pls)
    return from_local_like(_pick_local(xl, x, x_pls, idx, r_pls), g_pls,
                           tuple(idx.shape), x.device_mesh)


def token_nll(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(x)[label] over the last dim of the DTensor logits `x`
    (float32; its "vocab" dim may be split), a DTensor placed as x's
    rows. Each rank takes its columns' largest value (made the rows'
    largest over the column axes by an all-reduce outside autograd: it
    only steadies the exponentials), the sum of their exponentials and
    the label's logit where it falls in its columns; one all-reduce adds
    the last two over the column axes, and each rank computes the loss of
    its rows. DTensor's logsumexp would move the logits with collectives
    of its own."""
    from torch.distributed.tensor import Partial
    dm = x.device_mesh
    cols, x_pls, r_pls = _row_placements(x)
    part = tuple(Partial() if c else q for c, q in zip(cols, r_pls))
    rows = tuple(x.shape[:-1])
    xl = local_of(x, x_pls, out=part)
    gold = _pick_local(xl, x, x_pls, labels, r_pls)
    m = _move(_as_dtensor(xl.detach().amax(dim=-1), dm, tuple(
        Partial("max") if c else q for c, q in zip(cols, r_pls)), rows),
        r_pls).to_local()
    s = torch.exp(xl - m[..., None]).sum(dim=-1)
    both = local_of(from_local_like(torch.stack([s, gold], dim=-1), part,
                                    rows + (2,), dm), r_pls, out=r_pls)
    return from_local_like(m + torch.log(both[..., 0]) - both[..., 1],
                           r_pls, rows, dm)


# --------------------------------------------------------------------------
# Param specs and placements
# --------------------------------------------------------------------------


def _leaf_spec(shape, axes, rules: AxisRules) -> tuple:
    """A param leaf's spec: `resolve_spec` over the param rules (logical
    axes of another rank than the leaf's resolve to no axis)."""
    if len(axes) != len(shape):
        axes = (None,) * len(shape)
    return resolve_spec(tuple(shape), axes, rules.param_rules, rules)


def param_spec(params, logical, rules: AxisRules):
    """The spec tree of a param tree (tensors or TensorSpecs) and its
    logical tree ('|'-joined strings): each leaf's `resolve_spec` over the
    param rules, as the reference's `param_sharding` resolves its
    PartitionSpecs."""
    return tree_map(lambda arr, log: _leaf_spec(arr.shape, log_parse(log),
                                                rules), params, logical)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec as DTensor placements, one per mesh dim in `axis_names`
    order: `Shard(d)` on each mesh dim that the spec names at tensor dim
    d, `Replicate()` on the others."""
    # imported here: DTensor's modules take most of a second to import
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_sharding(params, logical, rules: AxisRules):
    """The placements tree of a param tree and its logical tree: each
    leaf's `param_spec` as DTensor placements on `rules.mesh`, as the
    reference's `param_sharding` gives a NamedSharding per leaf."""
    specs = param_spec(params, logical, rules)
    return tree_map(lambda _p, spec: placements(spec, rules.mesh), params,
                    specs)


def place_params(params, logical, rules: AxisRules):
    """The param tree on `rules.mesh` by `param_sharding` (the reference's
    `jax.device_put(params, p_sh)`): every rank passes the same whole
    tree and keeps its shard of each leaf. One rank: `params` as they
    are."""
    if mesh_size(rules.mesh) == 1:
        return params
    return place_tree(params, param_sharding(params, logical, rules),
                      rules.mesh)


class PlacingMaker(Maker):
    """A Maker that places each leaf on `rules.mesh` by its param spec as
    it is drawn (`init_model(rules=)`): the draws are the plain Maker's,
    in the same order, but a rank keeps only its shard of a leaf before
    the next is drawn, so it never holds the whole tree (grok-1's float32
    tree is 26 GB at one layer). Stacked layers are stacked shard by
    shard (`stack`)."""

    def __init__(self, rules: AxisRules, generator: torch.Generator,
                 dtype=torch.bfloat16, device=None):
        super().__init__(generator, dtype=dtype, device=device)
        self.rules = rules

    def _placed(self, leaf: PL) -> PL:
        spec = _leaf_spec(leaf.arr.shape, leaf.logical, self.rules)
        return PL(place(leaf.arr, placements(spec, self.rules.mesh),
                        self.rules.mesh), leaf.logical)

    def w(self, *a, **k) -> PL:
        return self._placed(super().w(*a, **k))

    def z(self, *a, **k) -> PL:
        return self._placed(super().z(*a, **k))

    def ones(self, *a, **k) -> PL:
        return self._placed(super().ones(*a, **k))

    def const(self, *a, **k) -> PL:
        return self._placed(super().const(*a, **k))


def stack(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """`torch.stack` along a new leading dim. DTensors of one placement
    are stacked shard by shard, with no collective: the new dim is whole
    on every rank and each sharded dim moves one place up, as the
    stacked leaf's spec (its "stack" axis unsharded) resolves."""
    if not is_dtensor(ts[0]):
        return torch.stack(list(ts))
    from torch.distributed.tensor import Shard
    first = ts[0]
    if any(tuple(t.placements) != tuple(first.placements)
           or t.shape != first.shape for t in ts):
        raise ValueError("stacking DTensors of different placements or "
                         "shapes")
    pls = tuple(Shard(p.dim + 1) if p.is_shard() else p
                for p in first.placements)
    return from_local_like(torch.stack([t.to_local() for t in ts]), pls,
                           (len(ts),) + tuple(first.shape),
                           first.device_mesh)
