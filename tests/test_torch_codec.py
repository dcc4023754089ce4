"""Parity of the port's codec report and lookup helpers
(`repro_torch.core.sparse` lookups, `encode_hybrid`, `factor_report`;
`core.tensorf.factor_sparsity` and `init_field_pl`; `configs.rtnerf`'s
`CONFIG`, `NeRFShape`, `NERF_SHAPES`) with the reference's, on the same
numpy inputs. Everything is exact: formats, nnz, byte counts, looked-up
values, and sparsities as equal floats."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, n, numpy_params
from repro.configs import rtnerf as jrtnerf
from repro.core import sparse as jsparse
from repro.core import tensorf as jtensorf
from repro.models import common as jcommon
from repro_torch.configs import rtnerf as trtnerf
from repro_torch.core import sparse as tsparse
from repro_torch.core import tensorf as ttensorf
from repro_torch.models import common as tcommon


def _matrix(rows, cols, sparsity, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype(np.float32)
    w[rng.rand(rows, cols) < sparsity] = 0
    return w


LOOKUP_CASES = [(16, 16, 0.85, 3), (13, 70, 0.5, 7), (8, 40, 1.0, 1),
                (1, 24, 0.0, 2), (40, 70, 0.3, 5)]


@pytest.mark.parametrize("rows,cols,sparsity,seed", LOOKUP_CASES)
@pytest.mark.parametrize("with_rank", [True, False])
def test_bitmap_lookup_matches_reference(rows, cols, sparsity, seed,
                                         with_rank):
    w = _matrix(rows, cols, sparsity, seed)
    jenc = jsparse.encode_bitmap(w)
    tenc = tsparse.encode_bitmap(w, device=CPU)
    q = np.random.RandomState(seed + 1).randint(
        0, rows * cols, 300).astype(np.int32)
    q = np.concatenate([np.arange(rows * cols, dtype=np.int32), q])
    want = np.asarray(jsparse.bitmap_lookup_linear(
        jenc.words, jenc.rowptr, jenc.values, jnp.asarray(q), cols,
        rank=jenc.rank if with_rank else None))
    got = n(tsparse.bitmap_lookup_linear(
        tenc.words, tenc.rowptr, tenc.values, torch.from_numpy(q), cols,
        rank=tenc.rank if with_rank else None))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, w.reshape(-1)[q])
    np.testing.assert_array_equal(
        n(tsparse.bitmap_lookup(tenc, torch.from_numpy(q))),
        np.asarray(jsparse.bitmap_lookup(jenc, jnp.asarray(q))))


@pytest.mark.parametrize("rows,cols,sparsity,seed", LOOKUP_CASES)
def test_coo_lookup_matches_reference(rows, cols, sparsity, seed):
    w = _matrix(rows, cols, sparsity, seed)
    jenc = jsparse.encode_coo(w)
    tenc = tsparse.encode_coo(w, device=CPU)
    q = np.arange(rows * cols, dtype=np.int32)
    want = np.asarray(jsparse.coo_lookup(jenc, jnp.asarray(q)))
    got = n(tsparse.coo_lookup(tenc, torch.from_numpy(q)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, w.reshape(-1))


def test_lookups_on_empty_rows_match_reference():
    """tests/test_sparse.py's all-zero and empty-row cases."""
    w = np.zeros((8, 40), np.float32)
    rng = np.random.RandomState(1)
    for r in (1, 2, 4, 5, 6):
        w[r, rng.randint(0, 40, 7)] = rng.randn(7)
    q = np.arange(8 * 40, dtype=np.int32)
    for m in (np.zeros_like(w), w):
        got_b = n(tsparse.bitmap_lookup(tsparse.encode_bitmap(m, device=CPU),
                                        torch.from_numpy(q)))
        got_c = n(tsparse.coo_lookup(tsparse.encode_coo(m, device=CPU),
                                     torch.from_numpy(q)))
        want = np.asarray(jsparse.bitmap_lookup(jsparse.encode_bitmap(m),
                                                jnp.asarray(q)))
        np.testing.assert_array_equal(got_b, want)
        np.testing.assert_array_equal(got_c, want)
        np.testing.assert_array_equal(got_b, m.reshape(-1))


@pytest.mark.parametrize("n_zero", [0, 30, 79, 80, 81, 100])
def test_encode_hybrid_matches_reference(n_zero):
    """The format rule at and around the 80% boundary, streams equal."""
    rng = np.random.RandomState(n_zero)
    w = rng.randn(10, 10).astype(np.float32)
    w[np.unravel_index(rng.permutation(100)[:n_zero], w.shape)] = 0
    jfmt, js, jenc = jsparse.encode_hybrid(w)
    tfmt, ts, tenc = tsparse.encode_hybrid(torch.from_numpy(w), device=CPU)
    assert (tfmt, ts, tenc.nnz, tenc.shape) == (jfmt, js, jenc.nnz,
                                                jenc.shape)
    if tfmt == "coo":
        np.testing.assert_array_equal(n(tenc.coords), np.asarray(jenc.coords))
        np.testing.assert_array_equal(n(tsparse.decode_coo(tenc)), w)
    else:
        np.testing.assert_array_equal(n(tenc.words).view(np.uint32),
                                      np.asarray(jenc.words))
        np.testing.assert_array_equal(n(tsparse.decode_bitmap(tenc)), w)
    np.testing.assert_array_equal(n(tenc.values), np.asarray(jenc.values))


def test_encode_hybrid_of_a_vector_matches_reference():
    """A 1-D input: COO keeps its shape, bitmap encodes it as one row."""
    w = np.zeros(40, np.float32)
    w[[3, 17]] = [1.5, -2.0]
    for thr in (0.80, 0.99):
        jfmt, js, jenc = jsparse.encode_hybrid(w, threshold=thr)
        tfmt, ts, tenc = tsparse.encode_hybrid(w, threshold=thr, device=CPU)
        assert (tfmt, ts, tenc.shape, tenc.nnz) == (jfmt, js, jenc.shape,
                                                    jenc.nnz)


def _report_params(seed, tol):
    """tests/test_sparse.py's report field: NeRFConfig(grid_res=16, ...)
    drawn with numpy and pruned at `tol` (some slices go COO)."""
    cfg = jrtnerf.NeRFConfig(grid_res=16, r_sigma=4, r_color=4, app_dim=6,
                             mlp_hidden=8)
    params = numpy_params(cfg, seed)
    params["sigma_lines"][1] = 0.0
    return {k: np.where(np.abs(v) < tol, np.float32(0), v)
            if k in jsparse.FACTOR_KEYS else v for k, v in params.items()}


@pytest.mark.parametrize("seed,tol", [(0, 0.05), (1, 0.2), (2, 0.0)])
def test_factor_report_matches_reference(seed, tol):
    params = _report_params(seed, tol)
    want = jsparse.factor_report({k: jnp.asarray(v)
                                  for k, v in params.items()})
    got = tsparse.factor_report({k: torch.from_numpy(v)
                                 for k, v in params.items()})
    assert list(got) == list(want) and len(got) == 12
    assert got == want
    # sigma_lines[1] is all zeros (COO); a light prune leaves bitmap slices
    assert {v["format"] for v in got.values()} == (
        {"coo"} if tol >= 0.2 else {"bitmap", "coo"})


@pytest.mark.parametrize("target", [0.5, 0.9])
def test_factor_sparsity_matches_reference(target):
    """tests/test_nerf.py:52 and tests/test_compressed_field.py:30: a
    field pruned by tolerance and by target sparsity, each tensor's zero
    fraction the reference's float."""
    cfg = jrtnerf.demo_config(tiny=True)
    params = numpy_params(cfg, 3)
    for prune_j, prune_t in (
            (lambda p: jtensorf.prune_factors(p, tol=0.05),
             lambda p: ttensorf.prune_factors(p, tol=0.05)),
            (lambda p: jtensorf.prune_to_sparsity(p, target),
             lambda p: ttensorf.prune_to_sparsity(p, target))):
        jp = prune_j({k: jnp.asarray(v) for k, v in params.items()})
        tp = prune_t({k: torch.from_numpy(v) for k, v in params.items()})
        want = jtensorf.factor_sparsity(jp)
        got = ttensorf.factor_sparsity(tp)
        assert got == want and list(got) == list(jsparse.FACTOR_KEYS)
        assert all(0.0 < v < 1.0 for v in got.values())


def test_factor_sparsity_is_the_float32_mean_at_full_width():
    """At NeRFConfig()'s widths (app_planes: 3,686,400 entries) the
    integer count divided in float32 is the reference's float32 mean."""
    cfg = jrtnerf.NeRFConfig()
    rng = np.random.RandomState(0)
    params = {}
    for k, shape in ttensorf.field_shapes(trtnerf.NeRFConfig()).items():
        if k in jsparse.FACTOR_KEYS:
            w = rng.randn(*shape).astype(np.float32)
            w[rng.rand(*shape) < 0.37] = 0
            params[k] = w
    want = jtensorf.factor_sparsity({k: jnp.asarray(v)
                                     for k, v in params.items()})
    got = ttensorf.factor_sparsity({k: torch.from_numpy(v)
                                    for k, v in params.items()})
    assert got == want
    assert cfg.param_count() == trtnerf.NeRFConfig().param_count()


def test_init_field_pl_wraps_init_field_with_the_reference_axes():
    cfg = trtnerf.demo_config(tiny=True)
    tree = ttensorf.init_field_pl(cfg, torch.Generator().manual_seed(5),
                                  device=CPU)
    params, logical = tcommon.split_pl(tree)
    plain = ttensorf.init_field(cfg, torch.Generator().manual_seed(5),
                                device=CPU)
    assert list(params) == list(plain)
    for k in plain:
        assert torch.equal(params[k], plain[k])
    jcfg = jrtnerf.demo_config(tiny=True)
    box = {}

    def f(key):
        p, box["logical"] = jcommon.split_pl(jtensorf.init_field_pl(jcfg,
                                                                    key))
        return p
    shapes = jax.eval_shape(f, jax.ShapeDtypeStruct((2,), np.uint32))
    assert logical == box["logical"]
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    assert all(v.dtype == torch.float32 for v in params.values())


def test_rtnerf_config_tables_match_reference():
    assert dataclasses.asdict(trtnerf.CONFIG) == \
        dataclasses.asdict(jrtnerf.CONFIG)
    assert {k: dataclasses.asdict(v) for k, v in trtnerf.NERF_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jrtnerf.NERF_SHAPES.items()}
    assert trtnerf.NeRFShape("x", 1, "train") == trtnerf.NeRFShape(
        "x", 1, "train")
    for cfg in (jrtnerf.CONFIG, jrtnerf.demo_config(True),
                jrtnerf.demo_config(False)):
        assert trtnerf.NeRFConfig(**dataclasses.asdict(cfg)).param_count() \
            == cfg.param_count()
