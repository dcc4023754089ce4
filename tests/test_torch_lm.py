"""Parity of the port's language-model serving path (`repro_torch.models`)
with the reference's (`repro.models`) on the same numpy inputs and the
reference's own params carried across (`transformer.params_from_numpy`).

Tolerances: float32 results to 1e-5 (rtol and atol: the two packages sum
in other orders, about 1e-7 relative a product); bfloat16 results to
3e-2, the reference's own decode-parity bound (tests/test_decode_parity.py).
The whole-model bf16 comparisons run the reference op by op
(`jax.disable_jit`): under jit, XLA fuses across the reference's bf16
casts and rounds elsewhere, 4 bf16 ulps (0.031) off its own op-by-op
logits, while the port's bf16 logits equal the op-by-op ones (max diff 0
on this machine). The float32 ones run it jitted. Integer results (shapes, logical trees) are exact."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, n
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf

F32_TOL = 1e-5
BF16_TOL = 3e-2
DENSE = ["llama3.2-1b", "granite-3-8b", "qwen1.5-32b", "granite-34b",
         "internvl2-76b"]
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def f32(x) -> np.ndarray:
    """A tensor (bf16 too) or JAX/numpy array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def tt(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# common numerics
# --------------------------------------------------------------------------


def test_norms_and_activations_match_reference():
    rng = np.random.RandomState(0)
    x, g, b = rand(rng, 3, 5, 64), rand(rng, 64), rand(rng, 64)
    close(tcommon.rms_norm(tt(x), tt(g), 1e-5),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5), F32_TOL)
    close(tcommon.layer_norm(tt(x), tt(g), tt(b)),
          jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)),
          F32_TOL)
    a, u = rand(rng, 4, 7, 32, scale=3.0), rand(rng, 4, 7, 32)
    close(tcommon.swiglu(tt(a), tt(u)),
          jcommon.swiglu(jnp.asarray(a), jnp.asarray(u)), F32_TOL)
    close(tcommon.geglu(tt(a), tt(u)),
          jcommon.geglu(jnp.asarray(a), jnp.asarray(u)), F32_TOL)
    # jax.nn.gelu's default is the tanh form, 1e-3 off the erf form here
    close(tcommon.gelu(tt(a)), jax.nn.gelu(jnp.asarray(a)), F32_TOL)
    assert float((torch.nn.functional.gelu(tt(a)) - tcommon.gelu(tt(a)))
                 .abs().max()) > 1e-4
    bx = jnp.asarray(x, jnp.bfloat16)
    close(tcommon.rms_norm(tt(np.asarray(bx, np.float32)).bfloat16(),
                           tt(g).bfloat16()),
          jcommon.rms_norm(bx, jnp.asarray(g, jnp.bfloat16)), BF16_TOL)


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.RandomState(1)
    x = rand(rng, 2, 9, 6, 16)
    pos = np.arange(3, 12, dtype=np.int32)
    close(tcommon.rope_freqs(16, theta), jcommon.rope_freqs(16, theta),
          F32_TOL)
    close(tcommon.apply_rope(tt(x), tt(pos), theta),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
          F32_TOL)
    # halves, not interleaved pairs: dim 0 pairs with dim 8
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    got = n(tcommon.apply_rope(tt(one), torch.tensor([5]), theta))[0, 0, 0]
    assert got[8] != 0 and got[1] == 0


def test_cross_entropy_matches_reference():
    rng = np.random.RandomState(2)
    logits = rand(rng, 2, 6, 48, scale=3.0)
    labels = rng.randint(0, 48, (2, 6)).astype(np.int32)
    mask = (rng.rand(2, 6) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tcommon.cross_entropy(tt(logits), tt(labels),
                                    None if m is None else tt(m))
        close(got, want, F32_TOL)


def test_pl_helpers_and_init_tree_match_reference():
    """The port's init tree has the reference's keys, shapes, dtypes and
    logical axes; Maker draws the fan-in scale."""
    for name in DENSE:
        jcfg = jreg.reduced(jreg.ARCHS[name])
        tcfg = treg.reduced(treg.ARCHS[name])
        box = {}

        def init(k, jcfg=jcfg):
            p, box["logical"] = jcommon.split_pl(jtf.init_model(jcfg, k))
            return p
        jparams = jax.eval_shape(init, jax.ShapeDtypeStruct((2,), np.uint32))
        jlog = box["logical"]
        tparams, tlog = tcommon.split_pl(ttf.init_model(
            tcfg, torch.Generator().manual_seed(0), device=CPU))
        assert tlog == jlog
        shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                              jparams)
        assert tcommon.tree_map(lambda a: (tuple(a.shape), str(a.dtype)
                                           .replace("torch.", "")),
                                tparams) == shapes
    for log in (("embed", None, "mlp"), (), (None,)):
        assert tcommon.log_str(log) == jcommon.log_str(log)
        s = jcommon.log_str(log)
        assert tcommon.log_parse(s) == jcommon.log_parse(s)
    mk = tcommon.Maker(torch.Generator().manual_seed(3), dtype=torch.float32)
    w = mk.w((4096, 8), (None, None), fan_in=64, scale=2.0).arr
    assert abs(float(w.std()) - 2.0 / 8.0) < 0.01
    with pytest.raises(ValueError, match="logical"):
        mk.w((2, 2), ("embed",))


# --------------------------------------------------------------------------
# GQA: forward (naive and chunked) and decode (with and without a window)
# --------------------------------------------------------------------------


def _gqa_case(seed, qkv_bias=True, kv=2):
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=kv, d_ff=64, vocab=64,
                      head_dim=8, qkv_bias=qkv_bias, rope_theta=1e4)
    rng = np.random.RandomState(seed)
    d, hq, hkv, hd = 32, 4, kv, 8
    p = {"wq": rand(rng, d, hkv, hq // hkv, hd, scale=d ** -0.5),
         "wk": rand(rng, d, hkv, hd, scale=d ** -0.5),
         "wv": rand(rng, d, hkv, hd, scale=d ** -0.5),
         "wo": rand(rng, hkv, hq // hkv, hd, d, scale=(hq * hd) ** -0.5)}
    if qkv_bias:
        p.update(bq=rand(rng, hkv, hq // hkv, hd), bk=rand(rng, hkv, hd),
                 bv=rand(rng, hkv, hd))
    return cfg, p, rng


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tp(p):
    return {k: tt(v) for k, v in p.items()}


@pytest.mark.parametrize("impl,T,window", [
    ("naive", 24, 0), ("naive", 24, 5), ("chunked", 600, 0),
    ("chunked", 1100, 300), ("auto", 40, 0)])
def test_gqa_forward_matches_reference(impl, T, window):
    """T > QK_CHUNK (512) runs the chunked path over several chunks and a
    ragged last one."""
    cfg, p, rng = _gqa_case(T)
    x = rand(rng, 2, T, 32)
    pos = np.arange(T, dtype=np.int32)
    want, wcache = jattn.gqa_forward(_jp(p), cfg, jnp.asarray(x),
                                     jnp.asarray(pos), window=window,
                                     impl=impl, return_cache=True)
    got, gcache = tattn.gqa_forward(_tp(p), cfg, tt(x), tt(pos),
                                    window=window, impl=impl,
                                    return_cache=True)
    close(got, want, F32_TOL)
    close(gcache["k"], wcache["k"], F32_TOL)
    close(gcache["v"], wcache["v"], F32_TOL)


def test_chunked_and_naive_agree_past_one_chunk():
    cfg, p, rng = _gqa_case(9, kv=1)
    T = 700
    x, pos = tt(rand(rng, 1, T, 32)), torch.arange(T)
    a, _ = tattn.gqa_forward(_tp(p), cfg, x, pos, impl="naive")
    b, _ = tattn.gqa_forward(_tp(p), cfg, x, pos, impl="chunked")
    close(a, n(b), F32_TOL)


@pytest.mark.parametrize("window,C,pos", [(0, 16, 9), (0, 16, 15),
                                          (0, 16, 20), (6, 6, 4),
                                          (6, 6, 13)])
def test_gqa_decode_matches_reference(window, C, pos):
    """A cache of C slots holding random K/V; the new row goes to
    min(pos, C-1), or pos % C in a ring of `window`, and slots are masked
    by the true positions they hold."""
    cfg, p, rng = _gqa_case(pos + C)
    x1 = rand(rng, 2, 1, 32)
    cache = {"k": rand(rng, 2, C, 2, 8), "v": rand(rng, 2, C, 2, 8)}
    want, wc = jattn.gqa_decode(_jp(p), cfg, jnp.asarray(x1),
                                jnp.int32(pos), _jp(cache), window=window)
    tc = _tp(cache)
    got, gc = tattn.gqa_decode(_tp(p), cfg, tt(x1), pos, tc, window=window)
    close(got, want, F32_TOL)
    close(gc["k"], wc["k"], F32_TOL)
    close(gc["v"], wc["v"], F32_TOL)
    assert gc["k"] is tc["k"]                       # written in place
    assert tattn.gqa_cache_shape(cfg, 2, 40, window=window)["k"].shape == \
        tuple(jattn.gqa_cache_shape(cfg, 2, 40, window=window)["k"].shape)


def test_gqa_decode_refuses_a_cache_of_another_dtype():
    cfg, p, rng = _gqa_case(0)
    cache = {"k": torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16),
             "v": torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)}
    with pytest.raises(TypeError, match="dtype"):
        tattn.gqa_decode(_tp(p), cfg, tt(rand(rng, 1, 1, 32)), 0, cache)


def _mla_case(seed):
    """deepseek-v3's reduced config and its MLA params drawn with numpy at
    the reference's shapes and fan-in scales (norms 1 + 0.1 N(0, 1))."""
    cfg = treg.reduced(treg.ARCHS["deepseek-v3-671b"])
    rng = np.random.RandomState(seed)
    d, h, qr, kr = cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    p = {"wdq": rand(rng, d, qr, scale=d ** -0.5),
         "q_norm": 1.0 + rand(rng, qr, scale=0.1),
         "wuq": rand(rng, qr, h, nope + rope, scale=qr ** -0.5),
         "wdkv": rand(rng, d, kr + rope, scale=d ** -0.5),
         "kv_norm": 1.0 + rand(rng, kr, scale=0.1),
         "wuk": rand(rng, kr, h, nope, scale=kr ** -0.5),
         "wuv": rand(rng, kr, h, vh, scale=kr ** -0.5),
         "wo": rand(rng, h, vh, d, scale=(h * vh) ** -0.5)}
    return cfg, p, rng


def test_other_attention_kinds_raise_naming_item_8():
    """MLA (deepseek-v3), which this test once found unported, against
    the reference: its init tree, the prefill forward (k and v expanded
    from the latent) with its latent cache, and the weight-absorbed
    decode against a latent cache at, inside and past the cache's end
    (the row clamps to slot C-1, as dynamic_update_slice does); float32
    to 1e-5. The entry points route by cfg.attention."""
    cfg, p, rng = _mla_case(0)
    jcfg = jreg.reduced(jreg.ARCHS["deepseek-v3-671b"])
    want_p, want_log = jcommon.split_pl(jattn.init_attention(
        jcommon.Maker(jax.random.PRNGKey(0)), jcfg))
    got_p, got_log = tcommon.split_pl(tattn.init_attention(
        tcommon.Maker(torch.Generator().manual_seed(0)), cfg))
    assert got_log == want_log and set(got_p) == set(p)
    assert {k: tuple(v.shape) for k, v in got_p.items()} == \
        {k: tuple(v.shape) for k, v in want_p.items()} == \
        {k: v.shape for k, v in p.items()}

    S = 10
    x = rand(rng, 2, S, cfg.d_model)
    pos = np.arange(S, dtype=np.int32)
    want, wcache = jattn.attention_forward(_jp(p), jcfg, jnp.asarray(x),
                                           jnp.asarray(pos),
                                           return_cache=True)
    got, gcache = tattn.attention_forward(_tp(p), cfg, tt(x), tt(pos),
                                          return_cache=True)
    close(got, want, F32_TOL)
    close(gcache["c"], wcache["c"], F32_TOL)
    close(gcache["kr"], wcache["kr"], F32_TOL)
    spec = tattn.attention_cache_shape(cfg, 2, 16)
    jspec = jattn.attention_cache_shape(jcfg, 2, 16)
    assert {k: s.shape for k, s in spec.items()} == \
        {k: tuple(s.shape) for k, s in jspec.items()}

    C = 12
    for step in (5, 11, 14):
        x1 = rand(rng, 2, 1, cfg.d_model)
        cache = {"c": rand(rng, 2, C, cfg.kv_lora_rank),
                 "kr": rand(rng, 2, C, cfg.qk_rope_head_dim)}
        want, wc = jattn.attention_decode(_jp(p), jcfg, jnp.asarray(x1),
                                          jnp.int32(step), _jp(cache))
        tc = _tp(cache)
        got, gc = tattn.attention_decode(_tp(p), cfg, tt(x1), step, tc)
        close(got, want, F32_TOL)
        close(gc["c"], wc["c"], F32_TOL)
        close(gc["kr"], wc["kr"], F32_TOL)
        assert gc["c"] is tc["c"]                       # written in place


# --------------------------------------------------------------------------
# model_prefill / model_decode on the reduced configs of the dense archs
# --------------------------------------------------------------------------

B, S, N_GEN = 2, 12, 4


def _batch(cfg, rng, S_text):
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S_text)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        batch["frontend"] = rand(rng, B, cfg.n_frontend_tokens, cfg.d_model)
    return batch


def _fp(cfg):
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


def numpy_lm_params(cfg, seed):
    """Params at the reference's shapes (`jax.eval_shape` of its
    init_model), drawn with numpy in float32 at its fan-in scales; norms
    1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), so that both are exercised."""
    shapes = jax.eval_shape(
        lambda k: jcommon.split_pl(jtf.init_model(cfg, k))[0],
        jax.ShapeDtypeStruct((2,), np.uint32))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        z = rng.randn(*shape).astype(np.float32)
        if name in ("ln1", "ln2", "final_norm"):
            return 1.0 + 0.1 * z
        if name in ("bq", "bk", "bv"):
            return 0.1 * z
        fan_in = {"embed": shape[-1], "head": shape[0],
                  "wo": int(np.prod(shape[1:-1]))}.get(name, shape[1])
        return z / np.float32(np.sqrt(fan_in))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_reference(name, dtype):
    """Params drawn with numpy at the reference's shapes, cast to `dtype`
    in both packages; prefill logits and K/V, then N_GEN - 1 decode steps
    against caches padded to the horizon (prefill's own caches padded,
    in `dtype`: the reference's cache spec is bf16 only)."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jreg.reduced(jreg.ARCHS[name])
    np_params = numpy_lm_params(jcfg, len(name))
    tcfg = treg.reduced(treg.ARCHS[name])
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), np_params)
    tparams = ttf.params_from_numpy(np_params, device=CPU, dtype=tdt)
    rng = np.random.RandomState(len(name))
    batch = _batch(jcfg, rng, S - N_GEN)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: tt(v) for k, v in batch.items()}

    run = jax.disable_jit if dtype == "bfloat16" else contextlib.nullcontext
    with run():
        want, wcache = jax.jit(lambda p, b: jtf.model_prefill(p, jcfg, b))(
            jparams, jbatch)
    got, gcache = ttf.model_prefill(tparams, tcfg, tbatch)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape) == \
        (B, 1, tcfg.vocab_padded)
    close(got, want, tol)
    for k in ("k", "v"):
        close(gcache["layers"][k], wcache["layers"][k], tol)

    horizon = _fp(jcfg) + S
    shapes, _ = jtf.serve_cache_spec(jcfg, B, horizon)
    tshapes, _ = ttf.serve_cache_spec(tcfg, B, horizon)
    wcache = jax.tree.map(
        lambda c, s: jnp.pad(c, [(0, a - b) for a, b in zip(s.shape,
                                                            c.shape)]),
        wcache, shapes)
    gcache = ttf.grow_cache(gcache, tshapes)
    for k in ("k", "v"):
        assert tuple(gcache["layers"][k].shape) == \
            tuple(wcache["layers"][k].shape) == tshapes["layers"][k].shape
        assert gcache["layers"][k].dtype == tdt
    decode = jax.jit(lambda p, t, pos, c: jtf.model_decode(
        p, jcfg, t, pos, c, seq_len=horizon))
    toks = rng.randint(0, jcfg.vocab, (B, N_GEN - 1)).astype(np.int32)
    for i in range(N_GEN - 1):
        pos = _fp(jcfg) + S - N_GEN + i
        with run():
            want, wcache = decode(jparams, jnp.asarray(toks[:, i:i + 1]),
                                  jnp.int32(pos), wcache)
        got, gcache = ttf.model_decode(tparams, tcfg, tt(toks[:, i:i + 1]),
                                       pos, gcache, seq_len=horizon)
        close(got, want, tol)
    for k in ("k", "v"):
        close(gcache["layers"][k], wcache["layers"][k], tol)


def _full_logits(params, cfg, batch):
    x, positions = ttf._assemble_input(params, cfg, batch)
    h, _, _ = ttf._trunk(params, cfg, x, positions)
    return ttf._logits(params, cfg, h)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_matches_forward(name, dtype):
    """tests/test_decode_parity.py on the port: prefill the prompt,
    teacher-force the last N_GEN tokens through decode, and compare with
    the full forward's logits at the same positions."""
    _, tdt, tol = DTYPES[dtype]
    cfg = treg.reduced(treg.ARCHS[name])
    params, _ = tcommon.split_pl(ttf.init_model(
        cfg, torch.Generator().manual_seed(0), dtype=tdt, device=CPU))
    rng = np.random.RandomState(7)
    batch = {k: tt(v) for k, v in _batch(cfg, rng, S).items()}
    toks = batch["tokens"]
    fp = _fp(cfg)
    logits, cache = ttf.model_prefill(
        params, cfg, dict(batch, tokens=toks[:, :S - N_GEN]))
    shapes, _ = ttf.serve_cache_spec(cfg, B, fp + S)
    cache = ttf.grow_cache(cache, shapes)
    dec = [logits]
    for i in range(N_GEN - 1):
        p = S - N_GEN + i
        lg, cache = ttf.model_decode(params, cfg, toks[:, p:p + 1], fp + p,
                                     cache, seq_len=fp + S)
        dec.append(lg)
    dec = torch.cat(dec, dim=1)
    want = _full_logits(params, cfg, batch)[:, fp + S - N_GEN - 1:
                                            fp + S - 1]
    close(dec, want, tol)


def test_params_from_numpy_carries_bf16_exactly():
    """bf16 reference arrays (numpy gives them as ml_dtypes arrays)
    carried across bit for bit."""
    cfg = jreg.reduced(jreg.ARCHS["llama3.2-1b"])
    np_params = jax.tree.map(lambda a: np.asarray(jnp.asarray(
        a, jnp.bfloat16)), numpy_lm_params(cfg, 0))
    got = ttf.params_from_numpy(np_params, device=CPU)
    e = np_params["embed"]
    assert str(e.dtype) == "bfloat16"
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  np.asarray(e, np.float32))
    np.testing.assert_array_equal(
        got["layers"]["attn"]["wq"].float().numpy(),
        np.asarray(np_params["layers"]["attn"]["wq"], np.float32))
    assert set(got) == {"embed", "final_norm", "layers"}     # tied head
