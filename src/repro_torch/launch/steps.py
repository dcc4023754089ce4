"""The prefill and decode steps: the port of the serving part of
`repro/launch/steps.py`. Each step runs under the mesh's axis rules
(`models.sharding.use_rules`) and without autograd."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import log_parse, tree_map
from repro_torch.models.sharding import AxisRules, resolve_spec, use_rules


def build_prefill_step(cfg: ModelConfig, rules: AxisRules):
    def prefill_step(params, batch):
        with use_rules(rules), torch.no_grad():
            return tf.model_prefill(params, cfg, batch)
    return prefill_step


def build_decode_step(cfg: ModelConfig, rules: AxisRules, seq_len: int):
    def decode_step(params, token, pos, cache):
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
