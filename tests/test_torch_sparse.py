"""Parity of the port's hybrid codec (`repro_torch.core.sparse`) with the
reference's (`repro.core.sparse`): encode stream for stream, decode and
`bitmap_rank` exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, numpy_params, tiny_cfg, torch_cfg
from repro.core import field as jfield
from repro.core import sparse as jsparse
from repro_torch.core import field as tfield
from repro_torch.core import sparse as tsparse


def _matrix(rows, cols, density, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype(np.float32)
    w[rng.rand(rows, cols) >= density] = 0
    return w


SHAPES = [(8, 32), (16, 96), (40, 70), (4, 576), (1, 24)]
DENSITIES = [0.0, 0.1, 0.5, 1.0]


@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
def test_encode_bitmap_matches_reference(rows, cols, density):
    w = _matrix(rows, cols, density, rows * cols)
    got = tsparse.encode_bitmap(w, device="cpu")
    want = jsparse.encode_bitmap(w)
    assert got.shape == want.shape and got.nnz == want.nnz
    np.testing.assert_array_equal(n(got.words).view(np.uint32),
                                  np.asarray(want.words))
    np.testing.assert_array_equal(n(got.rowptr), np.asarray(want.rowptr))
    np.testing.assert_array_equal(n(got.values), np.asarray(want.values))
    np.testing.assert_array_equal(n(got.rank), np.asarray(want.rank))
    np.testing.assert_array_equal(n(tsparse.decode_bitmap(got)), w)
    np.testing.assert_array_equal(n(tsparse.decode_bitmap(got)),
                                  np.asarray(jsparse.decode_bitmap(want)))


@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
def test_encode_coo_matches_reference(rows, cols, density):
    w = _matrix(rows, cols, density, rows + cols)
    got = tsparse.encode_coo(w, device="cpu")
    want = jsparse.encode_coo(w)
    assert got.shape == want.shape and got.nnz == want.nnz
    np.testing.assert_array_equal(n(got.coords), np.asarray(want.coords))
    np.testing.assert_array_equal(n(got.values), np.asarray(want.values))
    assert int(n(got.coords)[-1]) == tsparse.PAD_COORD or got.nnz % 128 == 0
    np.testing.assert_array_equal(n(tsparse.decode_coo(got)), w)
    np.testing.assert_array_equal(n(tsparse.decode_coo(got)),
                                  np.asarray(jsparse.decode_coo(want)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitmap_rank_and_popcount_match_reference(seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2 ** 32, size=(7, 13), dtype=np.uint64).astype(
        np.uint32)
    words[0, :3] = [0, 0xFFFFFFFF, 0x80000001]
    rowptr = rng.randint(0, 1000, size=(7,)).astype(np.int32)
    got = tsparse.bitmap_rank(torch.from_numpy(words.view(np.int32)),
                              torch.from_numpy(rowptr))
    want = jsparse.bitmap_rank(jnp.asarray(words), jnp.asarray(rowptr))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    bits = np.unpackbits(words.view(np.uint8), axis=1).reshape(
        7, 13, 32).sum(-1)
    np.testing.assert_array_equal(
        n(tsparse.popcount32(torch.from_numpy(words.view(np.int32)))), bits)


@pytest.mark.parametrize("density,threshold", [
    (0.05, 0.80), (0.5, 0.80), (0.99, 0.80), (0.5, 0.3), (0.0, 0.80)])
def test_encode_factor_matches_reference(density, threshold):
    w = _matrix(12, 200, density, 7)
    got = tsparse.encode_factor(w, threshold, device="cpu")
    want = jsparse.encode_factor(w, threshold)
    assert (got.fmt, got.shape, got.nnz) == (want.fmt, want.shape, want.nnz)
    assert got.sparsity == want.sparsity
    assert got.storage() == want.storage()
    assert got.dense_storage() == want.dense_storage()
    np.testing.assert_array_equal(n(got.value_array),
                                  np.asarray(want.value_array))
    np.testing.assert_array_equal(n(got.decode()), np.asarray(want.decode()))


@pytest.mark.parametrize("shape,nnz", [((16, 25600), 1000), ((48, 160), 7),
                                       ((3,), 0)])
def test_storage_model_and_format_rule_match_reference(shape, nnz):
    for fmt in ("dense", "bitmap", "coo"):
        assert tsparse.storage_bytes(shape, nnz, fmt) == \
            jsparse.storage_bytes(shape, nnz, fmt)
    for s in (0.0, 0.5, 0.79, 0.8, 0.95):
        assert tsparse.choose_format(s) == jsparse.choose_format(s)


@pytest.mark.parametrize("sparsity", [0.5, 0.9])
def test_field_encode_matches_reference_stream_for_stream(sparsity):
    """DenseField.encode over the same numpy params: every slice's format,
    nnz and streams equal the reference's."""
    cfg = tiny_cfg()
    params = numpy_params(cfg, 3)
    for k in tsparse.FACTOR_KEYS:
        w = params[k]
        cut = np.quantile(np.abs(w), sparsity)
        params[k] = np.where(np.abs(w) <= cut, 0.0, w).astype(np.float32)
    got = tfield.DenseField({k: torch.from_numpy(v) for k, v in
                             params.items()}, torch_cfg(cfg)).encode()
    want = jfield.DenseField({k: jnp.asarray(v) for k, v in params.items()},
                             cfg).encode()
    for k in tsparse.FACTOR_KEYS:
        for g, w in zip(got.factors[k], want.factors[k]):
            assert (g.fmt, g.nnz, g.nd_shape) == (w.fmt, w.nnz, w.nd_shape)
            np.testing.assert_array_equal(n(g.decode()), np.asarray(w.decode()))
            if g.fmt == "bitmap":
                np.testing.assert_array_equal(
                    n(g.bitmap.words).view(np.uint32),
                    np.asarray(w.bitmap.words))
                np.testing.assert_array_equal(n(g.bitmap.rank),
                                              np.asarray(w.bitmap.rank))
            elif g.fmt == "coo":
                np.testing.assert_array_equal(n(g.coo.coords),
                                              np.asarray(w.coo.coords))
    assert got.factor_bytes() == want.factor_bytes()
    assert got.dense_factor_bytes() == want.dense_factor_bytes()
