"""Logical-axis -> mesh-axis resolution: the port of
`repro/models/sharding.py`, as pure Python over a mesh's shape.

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
mesh dim, and `param_sharding` gives them for a whole param tree.
`shard_act` constrains nothing on one device; the language models on a
mesh of several ranks (activation, batch and cache shardings) wait for
ROADMAP.md Queue 1 item 10b.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.common import log_parse, tree_map

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


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Check an activation's logical axes and return it unchanged: on one
    device there is nothing to constrain. Without rules it checks
    nothing, as in the reference; on a mesh of several ranks it raises
    (the language models across ranks are ROADMAP.md Queue 1 item 10b)."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"logical {logical} vs shape {tuple(x.shape)}")
    if mesh_size(rules.mesh) > 1:
        raise NotImplementedError(
            f"activations on a mesh of {mesh_size(rules.mesh)} ranks: the "
            f"language models across ranks are ROADMAP.md Queue 1 item 10b")
    return x


def param_spec(params, logical, rules: AxisRules):
    """The spec tree of a param tree (tensors or TensorSpecs) and its
    logical tree ('|'-joined strings): each leaf's `resolve_spec` over the
    param rules, as the reference's `param_sharding` resolves its
    PartitionSpecs (a logical string of another rank than the leaf's
    resolves to no axis)."""
    def one(arr, log):
        axes = log_parse(log)
        if len(axes) != len(arr.shape):
            axes = (None,) * len(arr.shape)
        return resolve_spec(tuple(arr.shape), axes, rules.param_rules, rules)
    return tree_map(one, params, logical)


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
