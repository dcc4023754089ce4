"""Helpers of the language-model family parity tests
(tests/test_torch_lm_families*.py): the reference's params with every
constant leaf moved, cache-tree comparison, and the prefill + decode
comparison that the float32 and bf16 files each run.

Tolerances: float32 to 1e-5 (rtol and atol); bf16 to 3e-2 against the
reference run op by op (`jax.disable_jit`; its jitted bf16 rounds apart,
ROADMAP.md Queue 3 item 16). The reference's float32 prefill of the
enc-dec arch runs op by op too: jitted, its encoder scan refuses the
carry that bf16 frames promote to float32 (ROADMAP.md Queue 3 item 18).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf

CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_TOL = 3e-2
FAMILIES = ["deepseek-v3-671b", "grok-1-314b", "zamba2-7b", "rwkv6-1.6b",
            "seamless-m4t-large-v2"]
B, S, N_GEN = 2, 12, 4
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def close_trees(got, want, tol):
    """Every leaf of two cache trees (None leaves on both sides), each to
    `tol` relative and `tol` times its largest magnitude absolute: the
    RWKV wkv state reaches |x| 26 at the reduced config, and there the
    reference's own jitted and op-by-op float32 runs differ by 2.2e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            close_trees(got[k], want[k], tol)
    elif want is None:
        assert got is None
    else:
        assert tuple(got.shape) == tuple(want.shape)
        scale = max(1.0, float(np.abs(f32(want)).max()))
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol,
                                   atol=tol * scale)


def family_params(cfg, seed):
    """The reference's init (its tree, shapes and scales) as float32
    numpy, every leaf that it made constant (norms, biases, mixes, decay)
    moved by 0.1 N(0, 1) so that it is exercised."""
    params, _ = jcommon.split_pl(jtf.init_model(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def perturb(a):
        a = np.array(a, np.float32)
        flat = a.reshape(a.shape[0], -1) if a.ndim > 1 else a[None]
        if a.size > 1 and np.all(flat == flat[:, :1]):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        return a
    return jax.tree.map(perturb, params)


def frames(cfg, rng, M):
    return rng.randn(B, M, cfg.d_model).astype(np.float32)


def _pad(cache, shapes):
    """The reference's prefill cache padded to the horizon in its own
    dtype (its spec is bf16 only)."""
    return jax.tree.map(lambda c, s: jnp.pad(c, [
        (0, a - b) for a, b in zip(s.shape, c.shape)]), cache, shapes)


def check_prefill_and_decode(name, dtype):
    """Prefill logits and every cache leaf, then N_GEN - 1 decode steps
    against caches padded to the horizon (each package's prefill cache,
    in `dtype`), the caches again at the end."""
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jreg.reduced(jreg.ARCHS[name])
    tcfg = treg.reduced(treg.ARCHS[name])
    np_params = family_params(jcfg, len(name))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), np_params)
    tparams = ttf.params_from_numpy(np_params, device=CPU, dtype=tdt)
    rng = np.random.RandomState(len(name))
    batch = {"tokens": rng.randint(0, jcfg.vocab, (B, S - N_GEN)).astype(
        np.int32)}
    if jcfg.enc_dec:
        batch["enc_frames"] = frames(jcfg, rng, S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    eager = dtype == "bfloat16" or jcfg.enc_dec
    run = jax.disable_jit if eager else contextlib.nullcontext
    with run():
        want, wcache = jax.jit(lambda p, b: jtf.model_prefill(p, jcfg, b))(
            jparams, jbatch)
    got, gcache = ttf.model_prefill(tparams, tcfg, tbatch)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    close(got, want, tol)
    close_trees(gcache, wcache, tol)

    shapes, _ = jtf.serve_cache_spec(jcfg, B, S, enc_len=S)
    tshapes, _ = ttf.serve_cache_spec(tcfg, B, S, enc_len=S)
    wcache = _pad(wcache, shapes)
    gcache = ttf.grow_cache(gcache, tshapes)
    decode = jax.jit(lambda p, t, pos, c: jtf.model_decode(
        p, jcfg, t, pos, c, seq_len=S))
    toks = rng.randint(0, jcfg.vocab, (B, N_GEN - 1)).astype(np.int32)
    for i in range(N_GEN - 1):
        pos = S - N_GEN + i
        with (jax.disable_jit() if dtype == "bfloat16"
              else contextlib.nullcontext()):
            want, wcache = decode(jparams, jnp.asarray(toks[:, i:i + 1]),
                                  jnp.int32(pos), wcache)
        got, gcache = ttf.model_decode(tparams, tcfg,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       pos, gcache, seq_len=S)
        close(got, want, tol)
    close_trees(gcache, wcache, tol)
