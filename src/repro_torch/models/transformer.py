"""Model assembly: the port of the dense part of
`repro/models/transformer.py` (the archs whose trunk is a stack of
GQA + MLP layers: llama3.2-1b, granite-3-8b, qwen1.5-32b, granite-34b,
and internvl2-76b behind its stub vision frontend).

Layer params are stacked on a leading "stack" axis, as in the reference;
where the reference scans the stack, the port loops over it in Python and
indexes each layer's slice. Param trees are nested dicts keyed as the
reference's `split_pl` trees (`params_from_numpy` carries those across).
Entry points:

  init_model(cfg, generator, device=)           -> PL tree
  model_prefill(params, cfg, batch)             -> (last_logits, cache)
  model_decode(params, cfg, token, pos, cache, seq_len=) -> (logits, cache)
  serve_cache_spec(cfg, batch, seq)             -> (spec tree, logical tree)

Tokens index the embedding directly: every token must be < cfg.vocab
(PyTorch raises on an index past the table, where the reference's
`jnp.take` clamps). The MoE, encoder-decoder, hybrid and RWKV trunks
raise NotImplementedError (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (PL, Maker, TensorSpec, gelu, geglu,
                                       rms_norm, swiglu, tree_map)
from repro_torch.models.sharding import shard_act

# window kicks in only for long-context decode (the zamba2 deviation)
WINDOW_MIN_SEQ = 131_072


def is_dense(cfg: ModelConfig) -> bool:
    """Does `cfg` run the dense GQA trunk (the archs the port serves)?"""
    return (cfg.family in ("dense", "vlm") and cfg.attention == "gqa"
            and not (cfg.is_moe or cfg.enc_dec or cfg.mtp))


def require_dense(cfg: ModelConfig) -> None:
    if not is_dense(cfg):
        raise attn_lib.not_ported(f"{cfg.name} (family {cfg.family!r}, "
                                  f"attention {cfg.attention!r})")


def tree_index(tree, i: int):
    """Layer i's params (or cache) from a stacked tree."""
    return tree_map(lambda a: a[i], tree)


def tree_stack(trees):
    """A stacked tree from per-layer trees of one structure."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# --------------------------------------------------------------------------
# layer init
# --------------------------------------------------------------------------


def _init_mlp(mk: Maker, cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    p = {"w1": mk.w((d, d_ff), ("embed", "mlp"), fan_in=d),
         "w2": mk.w((d_ff, d), ("mlp", "embed"), fan_in=d_ff)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = mk.w((d, d_ff), ("embed", "mlp"), fan_in=d)
    return p


def _init_dense_layer(mk: Maker, cfg: ModelConfig):
    return {"ln1": mk.ones((cfg.d_model,), ("embed",)),
            "attn": attn_lib.init_attention(mk, cfg),
            "ln2": mk.ones((cfg.d_model,), ("embed",)),
            "mlp": _init_mlp(mk, cfg, cfg.d_ff)}


def _init_stack(mk: Maker, cfg, layer_init, n: int):
    """n layers drawn one after another and stacked; the logical axes get
    a leading 'stack' axis."""
    layers = [layer_init(mk, cfg) for _ in range(n)]
    return tree_map(lambda *ls: PL(torch.stack([l.arr for l in ls]),
                                   ("stack",) + ls[0].logical), *layers)


def init_model(cfg: ModelConfig, generator: torch.Generator, *,
               dtype=torch.bfloat16, device: DeviceLike = None
               ) -> Dict[str, Any]:
    """Random params (a PL tree) for a dense or vlm arch: normal draws
    from `generator` with the reference's fan-in scales, in `dtype` (the
    reference's params are always bfloat16) on `device` (None: the
    card). The numbers are PyTorch's, not the reference's: parity tests
    carry the reference's params across (`params_from_numpy`)."""
    require_dense(cfg)
    mk = Maker(generator, dtype=dtype, device=resolve_device(device))
    d, Vp = cfg.d_model, cfg.vocab_padded
    p: Dict[str, Any] = {
        "embed": mk.w((Vp, d), ("vocab", "embed"), fan_in=d),
        "final_norm": mk.ones((d,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        p["head"] = mk.w((d, Vp), ("embed", "vocab"), fan_in=d)
    p["layers"] = _init_stack(mk, cfg, _init_dense_layer, cfg.n_layers)
    return p


def params_from_numpy(tree, *, device: DeviceLike = None,
                      dtype=torch.bfloat16):
    """The reference's param tree (`split_pl(init_model(cfg, key))[0]`,
    its leaves as numpy arrays, bf16 ones included) as the port's: each
    leaf through float32 (exact for bf16) to `dtype` on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dtype).to(dev), tree)


# --------------------------------------------------------------------------
# layer forward
# --------------------------------------------------------------------------


def _mlp_fwd(p, cfg: ModelConfig, x):
    h1 = torch.einsum("bsd,df->bsf", x, p["w1"])
    h1 = shard_act(h1, "batch", "seq", "mlp")
    if "w3" in p:
        act = geglu if cfg.act == "geglu" else swiglu
        h = act(h1, torch.einsum("bsd,df->bsf", x, p["w3"]))
    else:
        h = gelu(h1.float()).to(h1.dtype)
    return torch.einsum("bsf,fd->bsd", h, p["w2"])


def _dense_layer_fwd(lp, cfg, x, positions, *, causal=True, window=0,
                     return_cache=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, cache = attn_lib.attention_forward(
        lp["attn"], cfg, h, positions, causal=causal, window=window,
        return_cache=return_cache)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + _mlp_fwd(lp["mlp"], cfg, h)
    x = shard_act(x, "batch", "seq", None)
    return x, cache


def _scan_dense(stack, cfg, x, positions, *, window=0, collect_cache=False):
    """The layer stack over x; with collect_cache, each layer's K/V
    stacked on a leading layer axis (the reference's scan output)."""
    n = stack["ln1"].shape[0]
    caches = []
    for i in range(n):
        x, cache = _dense_layer_fwd(tree_index(stack, i), cfg, x, positions,
                                    window=window,
                                    return_cache=collect_cache)
        caches.append(cache)
    return x, (tree_stack(caches) if collect_cache else None)


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------


def _embed(params, cfg, tokens):
    e = params["embed"][tokens]
    return shard_act(e, "batch", "seq", None)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    return shard_act(h @ w, "batch", "seq", "vocab")


def _assemble_input(params, cfg, batch):
    """tokens (+ stub frontend embeddings, prepended) -> (x, positions)."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend and "frontend" in batch:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    S = x.shape[1]
    return x, torch.arange(S, device=x.device)


def _trunk(params, cfg, x, positions, *, window=0):
    """Train/prefill trunk of the dense family. Returns (h, aux, caches)
    as the reference's (aux is 0 and no cache is collected here)."""
    require_dense(cfg)
    h, _ = _scan_dense(params["layers"], cfg, x, positions, window=window)
    return h, torch.zeros((), dtype=torch.float32, device=x.device), None


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------


def model_prefill(params, cfg: ModelConfig, batch):
    """Full-prompt forward; returns (last-position logits (B,1,Vp), cache
    {"layers": {"k","v"}: (L,B,S,K,h), "memory": None})."""
    require_dense(cfg)
    x, positions = _assemble_input(params, cfg, batch)
    h, kv = _scan_dense(params["layers"], cfg, x, positions,
                        collect_cache=True)
    logits = _logits(params, cfg, h[:, -1:])
    return logits, {"layers": kv, "memory": None}


def _decode_window(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.window and seq_len > WINDOW_MIN_SEQ:
        return cfg.window
    return 0


def model_decode(params, cfg: ModelConfig, token, pos: int, cache, *,
                 seq_len: int):
    """One-token step. token (B,1) integer; pos its absolute position (a
    Python int). The cache's K/V rows are written in place
    (`attention.gqa_decode`); returns (logits (B,1,Vp), cache)."""
    require_dense(cfg)
    x = _embed(params, cfg, token)
    window = _decode_window(cfg, seq_len)
    stack, kv = params["layers"], cache["layers"]
    for i in range(stack["ln1"].shape[0]):
        lp = tree_index(stack, i)
        hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.attention_decode(lp["attn"], cfg, hh, pos,
                                         tree_index(kv, i), window=window)
        x = x + a
        hh = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_fwd(lp["mlp"], cfg, hh)
    logits = _logits(params, cfg, x)
    return logits, {"layers": kv, "memory": cache.get("memory")}


# --------------------------------------------------------------------------
# cache specs (TensorSpec + logical axes)
# --------------------------------------------------------------------------


def _with_stack(tree, n):
    return tree_map(lambda s: TensorSpec((n,) + tuple(s.shape), s.dtype),
                    tree)


def serve_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                     enc_len: int = 0):
    """(TensorSpec tree, logical-string tree) of the decode cache at a
    horizon of `seq_len` positions (bf16, as the reference's). `enc_len`
    is the encoder-decoder archs' and is unused by the dense family."""
    require_dense(cfg)
    window = _decode_window(cfg, seq_len)
    seq_ax = "seq" if attn_lib.heads_shardable(cfg) else "seq_model"
    kv_log = {"k": f"stack|batch|{seq_ax}|kv_heads|head_dim",
              "v": f"stack|batch|{seq_ax}|kv_heads|head_dim"}
    shapes = {"layers": _with_stack(attn_lib.attention_cache_shape(
        cfg, batch, seq_len, window=window), cfg.n_layers), "memory": None}
    return shapes, {"layers": kv_log, "memory": None}


def grow_cache(cache, shapes):
    """Prefill's cache zero-padded to the shapes of `serve_cache_spec`
    (the serving horizon), keeping its own dtype: the params' (bf16 for
    the reference's params)."""
    def fit(c, s):
        if tuple(c.shape) == tuple(s.shape):
            return c
        out = torch.zeros(s.shape, dtype=c.dtype, device=c.device)
        out[tuple(slice(0, n) for n in c.shape)] = c
        return out
    return tree_map(fit, cache, shapes)
