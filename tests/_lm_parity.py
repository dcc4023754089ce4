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
from _train_bounds import adamw_first_step_excess

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
    return perturb_constants(params, seed)


def perturb_constants(params, seed):
    """`family_params`' move of the constant leaves of a reference param
    tree, as float32 numpy."""
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


# -- training (tests/test_torch_lm_train*.py) --------------------------------

TRAIN_B, TRAIN_S = 2, 16
# one bf16 ulp: the seamless encoder's first norm gain is read through the
# reference's bf16 cast of the frames, so its gradient's cotangent rounds
# to bf16 in both packages and may land on neighbouring bf16 values
BF16_ULP = 2.0 ** -8
# RWKV6's float32 gradients through its WKV recurrence carry 1e-4 of
# rounding against their leaf's largest, in the reference's own runs too
# (jitted against op by op; ROADMAP.md Queue 3 item 23): its leaves are
# held to this, 4x the largest seen
RWKV_F32_GRAD_TOL = 5e-4


def carry_batch(jbatch):
    """The reference's batch as the port's, on the CPU: integer and float32
    arrays as they are, bf16 ones through float32 (exact)."""
    out = {}
    for k, v in jbatch.items():
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(np.array(v.astype(jnp.float32))).to(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def train_batch(jcfg, batch=TRAIN_B, seq=TRAIN_S, step=0):
    """The reference's TokenStream batch (labels, loss_mask, and the
    frontend or encoder frames of the family)."""
    from repro.configs.base import ShapeConfig
    from repro.data.tokens import TokenStream
    return TokenStream(jcfg, ShapeConfig("t", seq, batch, "train")).batch(
        step)


def leaf_items(jtree, ttree):
    """(path string, reference leaf, port leaf) for every leaf of the
    reference's tree, the port's found under the same keys."""
    for path, want in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        got = ttree
        for key in path:
            got = got[key.key]
        yield jax.tree_util.keystr(path), want, got


def close_leaves(ttree, jtree, tol, loose=()):
    """Every leaf within `tol` times that leaf's largest magnitude (exactly
    where it is all zero); the paths in `loose` within BF16_ULP."""
    for path, want, got in leaf_items(jtree, ttree):
        w, g = f32(want), f32(got)
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        t = BF16_ULP if path in loose else tol
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= t * scale, f"{path}: {err} > {t} x {scale}"


def check_loss_and_grads(name, dtype, seed=None, jit=None):
    """`model_loss` and every gradient leaf of the port (autograd) against
    `jax.value_and_grad(model_loss)` on the reference's params (constant
    leaves moved; `seed` default len(name)) and its TokenStream batch.
    bf16 and the enc-dec arch's reference run op by op (ROADMAP.md Queue
    3 items 16 and 18) unless `jit` says otherwise. Returns both gradient
    trees (the reference's, the port's)."""
    from repro_torch.launch import steps as tsteps
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jreg.reduced(jreg.ARCHS[name])
    tcfg = treg.reduced(treg.ARCHS[name])
    np_params = family_params(jcfg, len(name) if seed is None else seed)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), np_params)
    tparams = ttf.params_from_numpy(np_params, device=CPU, dtype=tdt)
    jbatch = train_batch(jcfg)
    eager = (dtype == "bfloat16" or jcfg.enc_dec) if jit is None else not jit
    with (jax.disable_jit() if eager else contextlib.nullcontext()):
        (_, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: jtf.model_loss(p, jcfg, jbatch), has_aux=True))(jparams)
    loss, tm, tg = tsteps.loss_and_grads(tcfg, tparams, carry_batch(jbatch))
    assert set(tm) == set(jm)
    assert float(loss) == float(tm["loss"])
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                   atol=1e-7, err_msg=k)
    for _, _, g in leaf_items(jg, tg):
        assert g.dtype == tdt
    loose = ({"['enc']['ln1']"} if jcfg.enc_dec and dtype == "float32"
             else ())
    if jcfg.family == "ssm" and dtype == "float32":
        tol = RWKV_F32_GRAD_TOL
    close_leaves(tg, jg, tol, loose)
    return jg, tg


def leaf_rel_errs(ttree, jtree) -> dict:
    """{path: max|port - reference| / the reference leaf's largest}."""
    return {path: float(np.abs(f32(got) - f32(want)).max()
                        / np.abs(f32(want)).max())
            for path, want, got in leaf_items(jtree, ttree)}


def close_adamw_first_step(tp, jp, jm, lr, b1, eps, tol):
    """Params after one AdamW step, the port's against the reference's,
    each leaf within `_train_bounds.adamw_first_step_excess`'s bound (jm:
    the reference's first moment)."""
    for (path, want, got), m in zip(leaf_items(jp, tp), jax.tree.leaves(jm)):
        assert f32(got).shape == f32(want).shape, path
        excess = adamw_first_step_excess(f32(got), f32(want), f32(m), lr,
                                         b1, eps, tol)
        assert excess <= 1.0, f"{path}: {excess} of the first-step bound"
