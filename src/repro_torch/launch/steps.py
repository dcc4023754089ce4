"""The train, prefill and decode steps, and the shapes and specs around
them: the port of `repro/launch/steps.py`. Each step runs under the mesh's
axis rules (`models.sharding.use_rules`); the serve steps without
autograd. The train step takes its gradients by autograd over the plain
PyTorch model (the reference differentiates its jnp model with
`jax.value_and_grad`; no kernel of the port lies on this path).

On a mesh of several ranks the serve steps place what they are given as
the reference's jitted steps do by their in_shardings: the batch by
`batch_spec`'s specs and the decode cache by `cache_spec`'s (a plain
tensor, whole and equal on every rank, is cut to this rank's shard; a
DTensor is redistributed). The params must be placed already
(`models.sharding.place_params`). The train step on such a mesh takes
placed params and optimizer state and places its batch the same way;
its gradients cross the ranks through the port's own collectives (the
transposes of `models.sharding.redistribute`'s), for every trunk: dense,
MoE, encoder-decoder, the Mamba2 hybrid and RWKV6."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import tokens as tok_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import (MetaMaker, TensorSpec, log_parse,
                                       split_pl, tree_map)
from repro_torch.models.sharding import (AxisRules, is_dtensor,
                                         mesh_context, mesh_size,
                                         place, place_tree, placed_zeros,
                                         placements, redistribute,
                                         resolve_spec, use_rules, whole)
from repro_torch.optim import clip_by_global_norm
from repro_torch.optim.optimizers import Optimizer, tree_leaves

GRAD_CLIP = 1.0


# --------------------------------------------------------------------------
# abstract params + specs
# --------------------------------------------------------------------------


def _spec(t) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def abstract_params(cfg: ModelConfig):
    """(TensorSpec tree, logical tree) of `cfg`'s params without drawing or
    allocating a number (the tree is built on the meta device)."""
    params, logical = split_pl(tf.init_with(MetaMaker(), cfg))
    return tree_map(_spec, params), logical


def count_params(specs) -> int:
    n = 0
    for s in tree_leaves(specs):
        k = 1
        for d in s.shape:
            k *= d
        n += k
    return n


def batch_spec(cfg: ModelConfig, shape: ShapeConfig, rules: AxisRules):
    """(TensorSpec dict, spec dict) of one batch: each spec the
    `resolve_spec` tuple over the activation rules, the entries of the
    reference's `batch_sharding` PartitionSpecs."""
    specs = tok_lib.input_specs(cfg, shape)
    logical = tok_lib.input_logical(cfg, shape)
    return specs, {k: resolve_spec(s.shape, log_parse(logical[k]),
                                   rules.act_rules, rules)
                   for k, s in specs.items()}


def opt_state_spec(opt: Optimizer, param_specs, param_spec_tree,
                   rules: AxisRules):
    """(TensorSpec tree, spec tree) of `opt`'s state, the entries of the
    reference's `opt_state_sharding`: AdamW's m and v take their param's
    spec; adafactor's vr drops its param's last axis and vc the one before
    it; a step counter (and any other optimizer's state) is replicated,
    `()`. `param_spec_tree` is `models.sharding.param_spec`'s."""
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), param_specs)
    state = tree_map(_spec, opt.init(meta))
    if opt.name == "adamw":
        return state, {"step": (), "m": param_spec_tree,
                       "v": param_spec_tree}
    if opt.name == "adafactor":
        def one(spec, v):
            return {k: (spec[:-1] if k == "vr" else
                        spec[:-2] + spec[-1:] if k == "vc" else spec)
                    for k in v}
        return state, {"step": (), "v": tree_map(one, param_spec_tree,
                                                 state["v"])}
    return state, tree_map(lambda _: (), state)


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------


def track(params) -> Tuple[Dict, List[torch.Tensor]]:
    """(a tree of the params as leaves that autograd tracks, those leaves
    in the tree's order). The leaves share the params' storage."""
    leaves: List[torch.Tensor] = []

    def one(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t
    return tree_map(one, params), leaves


def grads_of(loss, tracked, leaves):
    """d loss / d each tracked leaf, as a tree of `tracked`'s structure (a
    leaf the loss does not read gets zeros, as `jax.grad` gives). On a
    mesh each gradient is placed as its param (the reference's
    `constrain_grads` pin to `param_sh`): no partial sum leaves here."""
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))

    def one(p):
        g = next(grads)
        return (redistribute(g, p.placements) if is_dtensor(p) else g)
    return tree_map(one, tracked)


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads) of `tf.model_loss` at `params`; the loss and
    metrics detached, the grads in the params' dtypes. On a mesh of
    several ranks (under `use_rules`) the backward runs in
    `sharding.mesh_context`, as the forward does, and every byte it moves
    goes through the port's collectives (`sharding.redistribute`'s
    transposes); the loss and metrics are plain tensors, equal on every
    rank, and the gradients are placed as the params."""
    tracked, leaves = track(params)
    with torch.enable_grad():
        loss, metrics = tf.model_loss(tracked, cfg, batch)
    with mesh_context():
        grads = grads_of(loss, tracked, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _microbatches(batch, m: int):
    """The batch's rows in `m` consecutive microbatches (the reference's
    reshape to (m, B / m, ...)): rows [i B / m, (i + 1) B / m) of the
    whole batch (a placed leaf is made whole first: its rows are a few
    integers each)."""
    for k, v in batch.items():
        if v.shape[0] % m:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split into grad_accum={m} microbatches")
    batch = {k: whole(v) for k, v in batch.items()}
    return [{k: v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)]
             for k, v in batch.items()} for i in range(m)]


def build_train_step(cfg: ModelConfig, rules: AxisRules, opt: Optimizer,
                     param_sh=None):
    """train_step(params, opt_state, batch) -> (new params, new state,
    metrics with grad_norm). With cfg.grad_accum = m > 1 the batch splits
    into m microbatches whose gradients are summed in a bfloat16
    accumulator and divided by m, as the reference's are (and the metrics
    are then the mean loss alone). The gradients are clipped to global
    norm GRAD_CLIP, then `opt.update`d.

    On a mesh of several ranks the params and optimizer state must be
    placed (`sharding.place_params`, `opt.init` of placed params), and
    the batch is placed by `batch_spec` (each microbatch after its rows
    are cut); every gradient is placed as its param, as the reference's
    `constrain_grads` / `param_sh` pin does (`param_sh` itself is not
    needed: the placements travel with the params), and the new params
    and state keep the placements of the old."""
    def train_step(params, opt_state, batch):
        with use_rules(rules), mesh_context():
            if cfg.grad_accum > 1:
                m = cfg.grad_accum
                g_acc = tree_map(lambda p: placed_zeros(
                    p.shape, p, dtype=torch.bfloat16), params)
                loss_sum = None
                for mb in _microbatches(batch, m):
                    loss, _, grads = loss_and_grads(
                        cfg, params, place_batch(cfg, mb, rules))
                    g_acc = tree_map(lambda a, g: a + g.to(a.dtype), g_acc,
                                     grads)
                    del grads
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                grads = tree_map(lambda g: g / torch.tensor(
                    m, dtype=g.dtype, device=g.device), g_acc)
                del g_acc
                metrics = {"loss": loss_sum / torch.tensor(
                    m, dtype=loss_sum.dtype, device=loss_sum.device)}
            else:
                loss, metrics, grads = loss_and_grads(
                    cfg, params, place_batch(cfg, batch, rules))
            grads, gn = clip_by_global_norm(grads, GRAD_CLIP)
            new_params, new_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = gn
        return new_params, new_state, metrics
    return train_step


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------


def place_batch(cfg: ModelConfig, batch, rules: AxisRules):
    """The batch on the rules' mesh by `batch_spec`'s specs (its keys'
    logical axes resolved over the activation rules); one rank: as it
    is."""
    if mesh_size(rules.mesh) == 1:
        return batch
    logical = tok_lib.input_logical(cfg, ShapeConfig("batch", 0, 0, "train"))
    return {k: place(v, placements(resolve_spec(
        tuple(v.shape), log_parse(logical[k]), rules.act_rules, rules),
        rules.mesh), rules.mesh) for k, v in batch.items()}


def build_prefill_step(cfg: ModelConfig, rules: AxisRules):
    def prefill_step(params, batch):
        batch = place_batch(cfg, batch, rules)
        with use_rules(rules), torch.no_grad():
            return tf.model_prefill(params, cfg, batch)
    return prefill_step


def build_decode_step(cfg: ModelConfig, rules: AxisRules, seq_len: int):
    """decode_step(params, token (B, 1), pos, cache) -> (logits, cache).
    On a mesh of several ranks the token is placed as a batch and the
    cache by `cache_spec` at this horizon (the first step redistributes
    prefill's cache; later steps find it placed)."""
    cache_pls = {}

    def decode_step(params, token, pos, cache):
        if mesh_size(rules.mesh) > 1:
            token = place_batch(cfg, {"tokens": token}, rules)["tokens"]
            B = token.shape[0]
            if B not in cache_pls:
                cache_pls[B] = tree_map(
                    lambda spec: placements(spec, rules.mesh),
                    cache_spec(cfg, B, seq_len, rules)[1])
            cache = place_tree(cache, cache_pls[B], rules.mesh)
        with use_rules(rules), torch.no_grad():
            return tf.model_decode(params, cfg, token, pos, cache,
                                   seq_len=seq_len)
    return decode_step


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, rules: AxisRules):
    """(TensorSpec tree, spec tree) of the decode cache, for every family:
    each spec the `resolve_spec` tuple over the activation rules, the
    entries of the reference's `cache_sharding` PartitionSpecs (None
    subtrees stay None)."""
    shapes, logical = tf.serve_cache_spec(cfg, batch, seq_len)
    return shapes, tree_map(
        lambda s, log: resolve_spec(s.shape, log_parse(log), rules.act_rules,
                                    rules), shapes, logical)
