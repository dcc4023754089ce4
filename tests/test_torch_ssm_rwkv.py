"""Parity of the port's Mamba2 (`repro_torch.models.ssm`) and RWKV6
(`repro_torch.models.rwkv`) blocks with the reference's: the chunked SSD
against the per-step scan and against the reference's at seq 8, 64 and
130 (a multiple of no chunk), forward and step-by-step decode, RWKV6 with
and without a carried state, and the constant-size RWKV state. The port
counterparts of tests/test_ssm_rwkv.py (not its grad-accum test, which
fails in the reference).

Params and inputs are drawn with numpy from a seed; constant-init leaves
(norms, biases, mixes, decay) get noise so that they are exercised.
Tolerances: float32 to 1e-5 against the reference (rtol and atol); the
chunked SSD against the scan, and decode against forward, at the
reference's own 2e-3; bf16 to 3e-2 against the reference run op by op
(`jax.disable_jit`, ROADMAP.md Queue 3 item 16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.models import common as tcommon
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

F32_TOL = 1e-5
BF16_TOL = 3e-2
REF_TOL = 2e-3          # tests/test_ssm_rwkv.py's scan-vs-chunk bound
ZAMBA = "zamba2-7b"
RWKV = "rwkv6-1.6b"


def cfgs(name):
    return jreg.reduced(jreg.ARCHS[name]), treg.reduced(treg.ARCHS[name])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def block_params(init, cfg, seed):
    """The reference init's leaves (its shapes and scales) as float32
    numpy, every leaf that init made constant moved by 0.1 N(0, 1)."""
    p, _ = jcommon.split_pl(init(jcommon.Maker(jax.random.PRNGKey(seed),
                                               dtype=jnp.float32), cfg))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in p.items():
        a = np.array(v, np.float32)
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def both(p, dtype="float32"):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return ({k: jnp.asarray(v).astype(jdt) for k, v in p.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in p.items()})


def inputs(seed, *shape, scale=0.5, dtype="float32"):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def test_constants_dims_and_inits_match_reference():
    jc, tc = cfgs(ZAMBA)
    assert tssm.SSD_CHUNK == jssm.SSD_CHUNK
    assert tssm.ssm_dims(tc) == jssm.ssm_dims(jc)
    rc_j, rc_t = cfgs(RWKV)
    assert (trwkv.N_MIX, trwkv.DDLERP_RANK, trwkv.DECAY_RANK) == \
        (jrwkv.N_MIX, jrwkv.DDLERP_RANK, jrwkv.DECAY_RANK)
    for jinit, tinit, j, t in ((jssm.init_mamba2, tssm.init_mamba2, jc, tc),
                               (jrwkv.init_rwkv6, trwkv.init_rwkv6, rc_j,
                                rc_t)):
        want_p, want_log = jcommon.split_pl(jinit(jcommon.Maker(
            jax.random.PRNGKey(0)), j))
        got_p, got_log = tcommon.split_pl(tinit(tcommon.Maker(
            torch.Generator().manual_seed(0)), t))
        assert got_log == want_log
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got_p.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want_p.items()}
        for k in ("a_log", "w0"):                       # constant inits
            if k in got_p:
                close(got_p[k], want_p[k], 0)


@pytest.mark.parametrize("seq", [8, 64, 130])
def test_ssd_chunked_matches_scan_and_reference(seq):
    """The chunked SSD against the port's scan (2e-3, as the reference
    holds its own pair) and each impl against the reference's (1e-5):
    outputs and final states."""
    jc, tc = cfgs(ZAMBA)
    jp, tp = both(block_params(jssm.init_mamba2, jc, 0))
    jx, tx = inputs(1, 2, seq, jc.d_model)
    out = {}
    for impl in ("scan", "chunked"):
        want, wst = jax.jit(lambda p, x: jssm.mamba2_forward(
            p, jc, x, impl=impl))(jp, jx)
        got, gst = tssm.mamba2_forward(tp, tc, tx, impl=impl)
        close(got, want, F32_TOL)
        close(gst["h"], wst["h"], F32_TOL)
        close(gst["conv"], wst["conv"], F32_TOL)
        assert gst["h"].dtype == torch.float32
        out[impl] = (got, gst)
    close(out["chunked"][0], out["scan"][0], REF_TOL)
    close(out["chunked"][1]["h"], out["scan"][1]["h"], REF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_decode_match_reference(dtype):
    """Forward (scan) and 10 decode steps from a zero state, each against
    the reference's, and decode against the port's forward."""
    jc, tc = cfgs(ZAMBA)
    jp, tp = both(block_params(jssm.init_mamba2, jc, 2), dtype)
    B, S = 2, 10
    jx, tx = inputs(3, B, S, jc.d_model, dtype=dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with jax.disable_jit(dtype == "bfloat16"):
        want, _ = jssm.mamba2_forward(jp, jc, jx)
        _, nh, conv_ch = jssm.ssm_dims(jc)
        wstate = {"h": jnp.zeros((B, nh, jc.ssm_head_dim, jc.ssm_state)),
                  "conv": jnp.zeros((B, jc.ssm_conv - 1, conv_ch), jx.dtype)}
        wdec = []
        for t in range(S):
            y, wstate = jssm.mamba2_decode(jp, jc, jx[:, t:t + 1], wstate)
            wdec.append(y)
    got, _ = tssm.mamba2_forward(tp, tc, tx)
    close(got, want, tol)
    spec = tssm.mamba2_state_shape(tc, B)
    gstate = {"h": torch.zeros(spec["h"].shape),
              "conv": torch.zeros(spec["conv"].shape, dtype=tx.dtype)}
    gdec = []
    for t in range(S):
        y, gstate = tssm.mamba2_decode(tp, tc, tx[:, t:t + 1], gstate)
        close(y, wdec[t], tol)
        gdec.append(y)
    close(gstate["h"], wstate["h"], tol)
    close(gstate["conv"], wstate["conv"], tol)
    if dtype == "float32":
        close(torch.cat(gdec, dim=1), got, REF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_forward_matches_reference_with_and_without_state(dtype):
    """A fresh sequence (state None), then the next tokens from the state
    it left: outputs and states against the reference's."""
    jc, tc = cfgs(RWKV)
    jp, tp = both(block_params(jrwkv.init_rwkv6, jc, 4), dtype)
    jx, tx = inputs(5, 2, 9, jc.d_model, dtype=dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with jax.disable_jit(dtype == "bfloat16"):
        want1, wst = jrwkv.rwkv6_forward(jp, jc, jx[:, :6])
        want2, wst2 = jrwkv.rwkv6_forward(jp, jc, jx[:, 6:], state=wst)
    got1, gst = trwkv.rwkv6_forward(tp, tc, tx[:, :6])
    for k in ("shift_t", "shift_c", "wkv"):
        close(gst[k], wst[k], tol)
    assert gst["wkv"].dtype == torch.float32 and gst["shift_t"].dtype == \
        tx.dtype
    got2, gst2 = trwkv.rwkv6_forward(tp, tc, tx[:, 6:], state=gst)
    close(got1, want1, tol)
    close(got2, want2, tol)
    for k in ("shift_t", "shift_c", "wkv"):
        close(gst2[k], wst2[k], tol)


def test_rwkv_decode_matches_forward():
    """tests/test_ssm_rwkv.py::test_rwkv_decode_matches_forward on the
    port: one token at a time from the carried state equals the whole
    sequence."""
    jc, tc = cfgs(RWKV)
    _, tp = both(block_params(jrwkv.init_rwkv6, jc, 6))
    _, tx = inputs(7, 2, 9, tc.d_model)
    y_full, _ = trwkv.rwkv6_forward(tp, tc, tx)
    state, outs = None, []
    for t in range(9):
        y, state = trwkv.rwkv6_forward(tp, tc, tx[:, t:t + 1], state=state)
        outs.append(y)
    close(torch.cat(outs, dim=1), y_full, REF_TOL)


def test_rwkv_state_is_constant_size():
    """The decode state's specs equal the reference's, and a state after
    4 and after 64 tokens has those shapes: O(1) in sequence length."""
    jc, tc = cfgs(RWKV)
    want = jrwkv.rwkv6_state_shape(jc, batch=4)
    spec = trwkv.rwkv6_state_shape(tc, batch=4)
    for k in ("shift_t", "shift_c", "wkv"):
        assert spec[k].shape == tuple(want[k].shape)
        assert str(spec[k].dtype).replace("torch.", "") == str(want[k].dtype)
    n_bytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                  for s in spec.values())
    assert n_bytes < 1e6
    _, tp = both(block_params(jrwkv.init_rwkv6, jc, 8))
    for S in (4, 64):
        _, tx = inputs(9, 4, S, tc.d_model)
        _, st = trwkv.rwkv6_forward(tp, tc, tx)
        assert {k: tuple(v.shape) for k, v in st.items()} == \
            {k: s.shape for k, s in spec.items()}
