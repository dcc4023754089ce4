"""Parity of the port's serving path for the five archs beyond the dense
trunk (MLA + MoE, GQA + MoE, encoder-decoder, Mamba2 hybrid, RWKV6) with
the reference's in float32, on their reduced configs and the reference's
params carried across (`transformer.params_from_numpy`); the port's own
prefill-then-decode against its forward for the six cache families of
tests/test_decode_parity.py; and decode into caches built from the spec
for all ten archs. The bf16 cases of the reference parity are in
tests/test_torch_lm_families_bf16.py.

Tolerances (tests/_lm_parity.py): float32 to 1e-5. Prefill-then-decode
against the forward: the reference's 3e-2 in bf16 (MLA 8e-2: the
absorbed decode reassociates) and 1e-5 in float32 (MLA 1e-4); the MoE
archs at capacity_factor 16 there, since prefill groups tokens by
sequence and decode puts the batch in one group
(tests/test_decode_parity.py:23-27).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _lm_parity import (B, CPU, DTYPES, FAMILIES, N_GEN, S,
                        check_prefill_and_decode, close)
from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf


@pytest.mark.parametrize("name", FAMILIES)
def test_init_tree_matches_reference(name):
    """init_model's branches (ssm, hybrid, enc-dec, moe, the MTP block):
    the reference's keys, shapes, dtypes and logical axes."""
    jcfg = jreg.reduced(jreg.ARCHS[name])
    box = {}

    def init(k):
        p, box["logical"] = jcommon.split_pl(jtf.init_model(jcfg, k))
        return p
    want = jax.eval_shape(init, jax.ShapeDtypeStruct((2,), np.uint32))
    got, got_log = tcommon.split_pl(ttf.init_model(
        treg.reduced(treg.ARCHS[name]), torch.Generator().manual_seed(0),
        device=CPU))
    assert got_log == box["logical"]
    assert tcommon.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace(
        "torch.", "")), got) == jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), want)
    assert ("mtp" in got) == jcfg.mtp


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and every cache leaf, then N_GEN - 1 decode steps,
    float32, against the reference."""
    check_prefill_and_decode(name, "float32")


def forward_logits(params, cfg, batch):
    """Every position's logits through the port's training trunk (the
    encoder first for enc-dec)."""
    memory = (ttf._encode(params, cfg, batch["enc_frames"]) if cfg.enc_dec
              else None)
    x, positions = ttf._assemble_input(params, cfg, batch)
    h, _, _ = ttf._trunk(params, cfg, x, positions, memory=memory)
    return ttf._logits(params, cfg, h)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["llama3.2-1b"] + FAMILIES)
def test_prefill_then_decode_matches_forward(name, dtype):
    """tests/test_decode_parity.py on the port: prefill the prompt,
    teacher-force the last N_GEN tokens through decode, and compare with
    the full forward's logits at the same positions."""
    _, tdt, tol = DTYPES[dtype]
    cfg = treg.reduced(treg.ARCHS[name])
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    if cfg.attention == "mla":
        tol = 8e-2 if dtype == "bfloat16" else 1e-4
    params, _ = tcommon.split_pl(ttf.init_model(
        cfg, torch.Generator().manual_seed(0), dtype=tdt, device=CPU))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    extra = {}
    if cfg.enc_dec:
        extra["enc_frames"] = torch.randn(B, S, cfg.d_model, generator=gen
                                          ).to(torch.bfloat16)
    logits, cache = ttf.model_prefill(params, cfg,
                                      dict(extra, tokens=toks[:, :S - N_GEN]))
    shapes, _ = ttf.serve_cache_spec(cfg, B, S, enc_len=S)
    cache = ttf.grow_cache(cache, shapes)
    dec = [logits]
    for i in range(N_GEN - 1):
        p = S - N_GEN + i
        lg, cache = ttf.model_decode(params, cfg, toks[:, p:p + 1], p, cache,
                                     seq_len=S)
        dec.append(lg)
    want = forward_logits(params, cfg, dict(extra, tokens=toks))
    close(torch.cat(dec, dim=1), want[:, S - N_GEN - 1:S - 1], tol)


@pytest.mark.parametrize("name", list(jreg.ARCHS))
def test_decode_into_a_cache_built_from_the_spec(name):
    """tests/test_archs_smoke.py::test_prefill_decode_shapes on the port:
    bf16 params decode one token into zero caches of `serve_cache_spec`'s
    shapes and dtypes, and the tree keeps its structure and dtypes."""
    cfg = treg.reduced(treg.ARCHS[name])
    params, _ = tcommon.split_pl(ttf.init_model(
        cfg, torch.Generator().manual_seed(2), device=CPU))
    shapes, _ = ttf.serve_cache_spec(cfg, B, 16, enc_len=8)
    zero = tcommon.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                            shapes)
    lg, cache = ttf.model_decode(params, cfg, torch.zeros(B, 1, dtype=torch.long),
                                 3, zero, seq_len=16)
    assert tuple(lg.shape) == (B, 1, cfg.vocab_padded)
    assert torch.isfinite(lg.float()).all()
    assert tcommon.tree_map(lambda c: (tuple(c.shape), c.dtype), cache) == \
        tcommon.tree_map(lambda s: (s.shape, s.dtype), shapes)
