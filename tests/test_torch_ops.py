"""The port's `bitmap_matmul`, `volume_render` and `flash_attention`
against the reference on the CPU: each plain version held against the
reference's Pallas kernel in interpret mode and against its jnp oracle in
`repro.kernels.ref`, on inputs made with numpy from a seed; and the
dispatch contract of `repro_torch.kernels.ops` (CPU tensors take the
plain versions and launch nothing; force="ref" names the plain version).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n
from repro.core import sparse as jsparse
from repro.kernels import ref as jref
from repro.kernels.bitmap_decode import bitmap_matmul as pallas_bitmap_matmul
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.volume_render import volume_render as pallas_volume_render
from repro_torch.kernels import bitmap_decode, ops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import volume_render as tvr

WRAPPERS = (bitmap_decode.bitmap_matmul, tvr.volume_render,
            tflash.flash_attention)


def _launches():
    return tuple(w.launches for w in WRAPPERS)


# --------------------------------------------------------- bitmap matmul ---
def _bitmap_case(rows, cols, n_cols, dtype, density, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype(dtype)
    w[rng.rand(rows, cols) >= density] = 0
    x = rng.randn(cols, n_cols).astype(dtype)
    return w, x, jsparse.encode_bitmap(w)


def _carry_bitmap(jenc):
    """The reference's encoding as the port holds it: uint32 words as
    int32 bit patterns."""
    words = torch.from_numpy(np.asarray(jenc.words).view(np.int32).copy())
    rowptr = torch.from_numpy(np.asarray(jenc.rowptr).copy())
    values = torch.from_numpy(np.asarray(jenc.values).copy())
    return words, rowptr, values


@pytest.mark.parametrize("rows,cols,n_cols", [(8, 32, 4), (16, 64, 8),
                                              (8, 96, 16)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-2)])
@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
def test_bitmap_matmul_plain_matches_pallas_and_oracle(rows, cols, n_cols,
                                                       dtype, tol, density):
    w, x, jenc = _bitmap_case(rows, cols, n_cols, dtype, density,
                              rows * cols + n_cols)
    pal = np.asarray(pallas_bitmap_matmul(
        jenc.words, jenc.rowptr, jenc.values, jnp.asarray(x), cols=cols,
        interpret=True), np.float32)
    oracle = np.asarray(jref.bitmap_decode_matmul_ref(
        jenc.words, jenc.rowptr, jenc.values, jnp.asarray(x), cols),
        np.float32)
    words, rowptr, values = _carry_bitmap(jenc)
    before = _launches()
    got = bitmap_decode.bitmap_matmul(words, rowptr, values,
                                      torch.from_numpy(x), cols=cols)
    assert _launches() == before
    assert got.dtype == torch.from_numpy(x).dtype
    got = n(got).astype(np.float32)
    np.testing.assert_allclose(got, pal, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got, w.astype(np.float32) @ x.astype(np.float32), rtol=2e-2,
        atol=2e-2)


@pytest.mark.parametrize("rows,cols,n_cols", [(8, 70, 1), (24, 200, 9),
                                              (48, 1000, 8), (16, 3200, 16)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-2)])
def test_bitmap_matmul_plain_matches_pallas_at_split_row_shapes(
        rows, cols, n_cols, dtype, tol):
    """Shapes the card kernel splits into 1 to 8 segments a row, ragged
    last words, n on and off its 8-column tile: the plain version against
    the Pallas kernel (8-row blocks) in interpret mode."""
    w, x, jenc = _bitmap_case(rows, cols, n_cols, dtype, 0.4, rows + cols)
    pal = np.asarray(pallas_bitmap_matmul(
        jenc.words, jenc.rowptr, jenc.values, jnp.asarray(x), cols=cols,
        interpret=True), np.float32)
    words, rowptr, values = _carry_bitmap(jenc)
    got = n(bitmap_decode.bitmap_matmul(words, rowptr, values,
                                        torch.from_numpy(x), cols=cols))
    np.testing.assert_allclose(got.astype(np.float32), pal, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("rows,cols,n_cols", [(5, 70, 3), (3, 1000, 9)])
def test_bitmap_matmul_plain_off_pallas_blocks(rows, cols, n_cols):
    """Row counts off the Pallas 8-row block and ragged last words: the
    plain version against the jnp oracle and the dense product."""
    w, x, jenc = _bitmap_case(rows, cols, n_cols, np.float32, 0.3, cols)
    oracle = np.asarray(jref.bitmap_decode_matmul_ref(
        jenc.words, jenc.rowptr, jenc.values, jnp.asarray(x), cols))
    words, rowptr, values = _carry_bitmap(jenc)
    got = n(bitmap_decode.bitmap_matmul(words, rowptr, values,
                                        torch.from_numpy(x), cols=cols))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, w @ x, rtol=1e-5, atol=1e-5)


def test_bitmap_matmul_all_zero():
    w = np.zeros((8, 32), np.float32)
    jenc = jsparse.encode_bitmap(w)
    x = np.ones((32, 2), np.float32)
    pal = np.asarray(pallas_bitmap_matmul(jenc.words, jenc.rowptr,
                                          jenc.values, jnp.asarray(x),
                                          cols=32, interpret=True))
    words, rowptr, values = _carry_bitmap(jenc)
    got = n(bitmap_decode.bitmap_matmul(words, rowptr, values,
                                        torch.from_numpy(x), cols=32))
    assert np.all(pal == 0) and np.all(got == 0)


# --------------------------------------------------------- volume render ---
@pytest.mark.parametrize("r,n_samples", [(128, 64), (256, 128), (128, 192)])
@pytest.mark.parametrize("scale", [0.1, 3.0, 50.0])
def test_volume_render_plain_matches_pallas_and_oracle(r, n_samples, scale):
    rng = np.random.RandomState(r + n_samples)
    sigma = (np.abs(rng.randn(r, n_samples)) * scale).astype(np.float32)
    rgb = rng.rand(r, n_samples, 3).astype(np.float32)
    want = [jref.volume_render_ref(jnp.asarray(sigma), jnp.asarray(rgb),
                                   0.02, 1e-4),
            pallas_volume_render(jnp.asarray(sigma), jnp.asarray(rgb),
                                 delta=0.02, term_eps=1e-4, interpret=True)]
    before = _launches()
    color, t_final, nproc = tvr.volume_render(
        torch.from_numpy(sigma), torch.from_numpy(rgb), delta=0.02,
        term_eps=1e-4)
    assert _launches() == before
    assert color.shape == (r, 3) and t_final.shape == (r,)
    assert nproc.shape == () and nproc.dtype == torch.float32
    for c, t, cnt in want:
        np.testing.assert_allclose(n(color), np.asarray(c), atol=1e-5)
        np.testing.assert_allclose(n(t_final), np.asarray(t), atol=1e-6)
        assert float(nproc) == float(cnt)


@pytest.mark.parametrize("r,n_samples", [(37, 50), (1, 1)])
def test_volume_render_plain_off_pallas_blocks(r, n_samples):
    rng = np.random.RandomState(r)
    sigma = (np.abs(rng.randn(r, n_samples)) * 20.0).astype(np.float32)
    rgb = rng.rand(r, n_samples, 3).astype(np.float32)
    c, t, cnt = jref.volume_render_ref(jnp.asarray(sigma), jnp.asarray(rgb),
                                       0.05, 1e-3)
    color, t_final, nproc = tvr.volume_render(
        torch.from_numpy(sigma), torch.from_numpy(rgb), delta=0.05,
        term_eps=1e-3)
    np.testing.assert_allclose(n(color), np.asarray(c), atol=1e-5)
    np.testing.assert_allclose(n(t_final), np.asarray(t), atol=1e-6)
    assert float(nproc) == float(cnt)


def test_volume_render_opaque_wall():
    """An opaque wall at sample 2: the samples behind it are dead."""
    sigma = np.zeros((64, 64), np.float32)
    sigma[:, 2] = 1e4
    rgb = np.full((64, 64, 3), 0.5, np.float32)
    c, t, cnt = pallas_volume_render(jnp.asarray(sigma), jnp.asarray(rgb),
                                     delta=0.1, term_eps=1e-4,
                                     interpret=True)
    color, t_final, nproc = tvr.volume_render(
        torch.from_numpy(sigma), torch.from_numpy(rgb), delta=0.1,
        term_eps=1e-4)
    assert float(nproc) == float(cnt) == 64 * 3
    np.testing.assert_allclose(n(t_final), 0.0, atol=1e-6)
    np.testing.assert_allclose(n(color), 0.5, atol=1e-4)
    np.testing.assert_allclose(n(color), np.asarray(c), atol=1e-5)


# ----------------------------------------------------------------- flash ---
def _qkv(shape_q, shape_kv, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(*shape_q) * 0.3).astype(np.float32)
    k = (rng.randn(*shape_kv) * 0.3).astype(np.float32)
    v = rng.randn(*shape_kv).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 64), (2, 2, 256, 64),
                                     (1, 1, 256, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_oracle(b, h, s, d, causal):
    q, k, v = _qkv((b, h, s, d), (b, h, s, d), b * s + d)
    pal = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  interpret=True))
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    before = _launches()
    got = n(tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal))
    assert _launches() == before
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-3)


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _qkv((1, 2, 128, 64), (1, 2, 128, 64), 7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    assert np.array_equal(np.asarray(jq, np.float32), n(tq.float()))
    pal = np.asarray(pallas_flash(jq, jk, jv, interpret=True), np.float32)
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv), np.float32)
    got = tflash.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    got = n(got.float())
    np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=3e-2)


def test_flash_causal_mask_is_top_left_as_in_pallas():
    """sq=128 < sk=256, causal: query i sees keys 0..i, as the Pallas
    kernel masks (qpos >= kpos). The reference's jnp oracle masks from
    the bottom right here, so it is not the yardstick of this case."""
    q, k, v = _qkv((1, 1, 128, 64), (1, 1, 256, 64), 11)
    pal = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  interpret=True))
    got = n(tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0, 0, 0], v[0, 0, 0], rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------------- dispatch ---
def _small_inputs():
    w, x, jenc = _bitmap_case(8, 64, 4, np.float32, 0.5, 3)
    words, rowptr, values = _carry_bitmap(jenc)
    rng = np.random.RandomState(4)
    sigma = torch.from_numpy(np.abs(rng.randn(16, 40)).astype(np.float32))
    rgb = torch.from_numpy(rng.rand(16, 40, 3).astype(np.float32))
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 32, 16),
                                                 (1, 2, 32, 16), 5))
    return {
        "bitmap_matmul": ((words, rowptr, values, torch.from_numpy(x)),
                          dict(cols=64)),
        "volume_render": ((sigma, rgb), dict(delta=0.1, term_eps=1e-4)),
        "flash_attention": ((q, k, v), dict(causal=True)),
    }


WRAPPER_OF = {"bitmap_matmul": (bitmap_decode, "bitmap_matmul"),
              "volume_render": (tvr, "volume_render"),
              "flash_attention": (tflash, "flash_attention")}


@pytest.mark.parametrize("name", sorted(WRAPPER_OF))
def test_ops_dispatch_contract(name, monkeypatch):
    """CPU tensors through ops.* take the plain version inside the kernel
    wrapper and launch nothing; force="ref" goes straight to the plain
    version and never reaches the wrapper."""
    args, kw = _small_inputs()[name]
    before = _launches()
    default = getattr(ops, name)(*args, **kw)
    forced_kernel = getattr(ops, name)(*args, force="kernel", **kw)
    assert _launches() == before
    mod, attr = WRAPPER_OF[name]
    calls = []
    real = getattr(mod, attr)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mod, attr, spy)
    forced_ref = getattr(ops, name)(*args, force="ref", **kw)
    assert calls == []
    getattr(ops, name)(*args, **kw)
    assert calls == [1]
    outs = [o if isinstance(o, tuple) else (o,)
            for o in (default, forced_kernel, forced_ref)]
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("name", sorted(WRAPPER_OF))
def test_wrappers_refuse_meta_and_mixed_tensors(name):
    """The plain version runs only when every tensor lies on the CPU: a
    device that is not CUDA is refused, and so is a CPU/other mix."""
    args, kw = _small_inputs()[name]
    mod, attr = WRAPPER_OF[name]
    fn = getattr(mod, attr)
    meta_kw = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
    with pytest.raises(ValueError):
        fn(*(a.to("meta") for a in args), **meta_kw)
    with pytest.raises(ValueError):
        fn(args[0].to("meta"), *args[1:], **kw)
