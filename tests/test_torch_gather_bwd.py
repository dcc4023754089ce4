"""The gathers' backward on contended query streams
(`tests/_gather_bwd_cases.py`: one slot, runs across lanes, warps and
tiles, shuffled, long zero stretches, queries past the matrix, an
unaligned gradient view, wide COO windows), on the CPU: the port's plain
versions, its wrappers and autograd against `jax.grad` of the reference's
jnp oracles; and the backward kernels' host-side plan (tile, window
capacity, the windows it stages, the 16-byte flag). The kernels run on
the card (tests/test_torch_cuda.py, the same cases).

Tolerance: per value slot, 2 k 2^-24 times the sum of the |g| of its k
queries (two fp32 sums of the same terms in other orders); slots no query
reads exactly 0 on every side. The one-slot case's whole-number
gradients sum exactly in any order: it is held with no tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gather_bwd_cases import CASES, EXACT, EXACT_GRAD_MAX, case_inputs
from _torch_parity import CPU, n, t
from repro.kernels import ref as jref
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import _build, bitmap_decode, coo_gather, ops

NQ = 1 << 13


def _matrix(rows, cols, density, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, cols).astype(np.float32)
    w[rng.rand(rows, cols) >= density] = 0
    return w


def _grad(g, offset):
    """g as a CPU tensor `offset` floats into a buffer of its own."""
    buf = torch.zeros(g.shape[0] + offset)
    buf[offset:] = t(g)
    return buf[offset:]


def _reorder_tol(slot, hit, g, nvalues, case):
    """2 k 2^-24 sum|g| per slot; 0 for an EXACT case."""
    slot, hit = n(slot), n(hit)
    k = np.bincount(slot[hit], minlength=nvalues)
    s = np.bincount(slot[hit], weights=np.abs(g[hit]).astype(np.float64),
                    minlength=nvalues)
    exact = case in EXACT
    return (0.0 if exact else 2.0) * k * 2.0 ** -24 * s, k


def _check(got, want, tol, k):
    got = n(got).astype(np.float64)
    assert (np.abs(got - want) <= tol).all(), float(
        (np.abs(got - want) - tol).max())
    assert not got[k == 0].any() and not want[k == 0].any()


@pytest.mark.parametrize("case", CASES)
def test_bitmap_gather_bwd_matches_jax_grad_on_contended_queries(case):
    rows, cols = 6, 300
    w = _matrix(rows, cols, 0.3, 11)
    enc = tsparse.encode_bitmap(w, device=CPU)
    q, g, off = case_inputs(case, w, NQ, 12, far=3 * cols)
    nvalues = enc.values.shape[0]
    words = jnp.asarray(n(enc.words).view(np.uint32))
    rowptr, qj = jnp.asarray(n(enc.rowptr)), jnp.asarray(q)

    def f(v):
        return jnp.vdot(jref.bitmap_gather_ref(words, rowptr, v, qj, cols),
                        g)
    want = np.asarray(jax.grad(f)(n(enc.values))).astype(np.float64)
    gt = _grad(g, off)
    slot, bit = bitmap_decode.bitmap_slots(enc.words, enc.rowptr, nvalues,
                                           t(q), cols, enc.rank)
    tol, k = _reorder_tol(slot, bit, g, nvalues, case)
    assert k.sum() > 0
    for rank in (enc.rank, None):
        _check(bitmap_decode.bitmap_gather_bwd_ref(
            enc.words, enc.rowptr, t(q), gt, nvalues, cols, rank=rank),
            want, tol, k)
        _check(bitmap_decode.bitmap_gather_bwd(
            enc.words, enc.rowptr, t(q), gt, nvalues=nvalues, cols=cols,
            rank=rank), want, tol, k)
    v = enc.values.clone().requires_grad_(True)
    ops.bitmap_gather(enc.words, enc.rowptr, v, t(q), cols=cols,
                      rank=enc.rank).backward(gt)
    _check(v.grad, want, tol, k)
    assert not n(v.grad)[enc.nnz:].any()              # pad slots


@pytest.mark.parametrize("case", CASES)
def test_coo_gather_bwd_matches_jax_grad_on_contended_queries(case):
    rows, cols = 4, 3000
    w = _matrix(rows, cols, 0.5, 13)
    enc = tsparse.encode_coo(w, device=CPU)
    q, g, off = case_inputs(case, w, NQ, 14, far=10 ** 6)
    coords = jnp.asarray(n(enc.coords))
    qj = jnp.asarray(q)

    def f(v):
        return jnp.vdot(jref.coo_gather_ref(coords, v, qj), g)
    want = np.asarray(jax.grad(f)(n(enc.values))).astype(np.float64)
    gt = _grad(g, off)
    slot, found = coo_gather.coo_slots(enc.coords, t(q))
    tol, k = _reorder_tol(slot, found, g, enc.coords.shape[0], case)
    assert k.sum() > 0
    _check(coo_gather.coo_gather_bwd_ref(enc.coords, t(q), gt), want, tol,
           k)
    _check(coo_gather.coo_gather_bwd(enc.coords, t(q), gt), want, tol, k)
    v = enc.values.clone().requires_grad_(True)
    ops.coo_gather(enc.coords, v, t(q)).backward(gt)
    _check(v.grad, want, tol, k)
    assert not n(v.grad)[enc.nnz:].any()              # pad entries


@pytest.mark.parametrize("nq", [NQ, 1 << 20])
def test_exact_cases_sum_exactly_in_any_order(nq):
    """An EXACT case's gradients are whole numbers in [-2, 2], zeros and
    both signs among them, and their |g| sum below 2^24 at the card
    tests' size too: every partial sum of any order is an fp32 integer,
    so the kernels' sums must equal the plain versions' bit for bit."""
    w = _matrix(16, 256, 0.3, 21)
    for case in EXACT:
        _, g, _ = case_inputs(case, w, nq, 22, far=10)
        assert (g == np.round(g)).all()
        assert np.abs(g).max() == EXACT_GRAD_MAX
        assert (g == 0).any() and (g < 0).any() and (g > 0).any()
        assert np.abs(g).astype(np.float64).sum() < 2.0 ** 24
        fwd = np.cumsum(g, dtype=np.float32)
        back = np.cumsum(g[::-1], dtype=np.float32)
        assert fwd[-1] == back[-1] == g.astype(np.float64).sum()


# ------------------------------------------------- the kernels' plan ---
def test_coo_bwd_plan_tiles_the_queries_and_fits_shared_memory():
    plan = coo_gather.coo_bwd_plan(100_663_296)
    assert plan.tile == coo_gather.BWD_THREADS * coo_gather.BWD_PER_THREAD
    assert plan == coo_gather.CooBwdPlan(4096, 3072, 16, 1536)
    assert coo_gather.coo_bwd_plan(16 * 4096 + 1).blocks == 2
    assert coo_gather.coo_bwd_plan(0).blocks == 0
    with pytest.raises(ValueError):
        coo_gather.coo_bwd_plan(-1)
    # static shared memory of the COO backward kernel: the staged range,
    # each warp's list of up to 64 runs a row (a query and a float), the
    # reduction scratch; under a block's static 48 KB, and the four CTAs
    # an SM holds (64 registers a thread) leave over half of its 256 KB
    # to L1, which the searches outside the staged range read
    warps = coo_gather.BWD_THREADS // 32
    rows = coo_gather.BWD_PER_THREAD // 4
    smem = (4 * plan.capacity + warps * rows * 64 * 8
            + 4 * (2 * warps + 2))
    assert smem <= 48 * 1024 and 4 * smem <= 128 * 1024


def _search_counts_by_hand(coords, q, g):
    """The kernel's decisions, one CTA and one warp at a time."""
    tile, span, cap = (coo_gather.BWD_TILE, coo_gather.BWD_SPAN,
                       coo_gather.BWD_CAPACITY)
    n, lo_key, hi_key = coords.shape[0], -(1 << 31), (1 << 31) - 1
    tiles = -(-q.shape[0] // tile)
    staged = live = 0
    for c0 in range(0, tiles, span):
        t = np.arange(c0 * tile, min((c0 + 1) * tile, q.shape[0]))
        lq = q[t][g[t] != 0]
        below, above, in_smem = hi_key, lo_key, False
        if lq.size:
            lo = int(np.searchsorted(coords, lq.min()))
            hi = max(int(np.searchsorted(coords, lq.max(), "right")), lo)
            in_smem = hi - lo <= cap
            if in_smem:
                start = max(0, lo - (cap - (hi - lo)) // 2)
                end = min(n, start + cap)
                start = max(0, end - cap)
            else:
                start, end = lo, hi
            below = int(coords[start - 1]) if start > 0 else lo_key
            above = int(coords[end]) if end < n else hi_key
        for ti in range(c0, min(c0 + span, tiles)):
            for w in range(coo_gather.BWD_THREADS // 32):
                idx = [ti * tile + v * 4 * coo_gather.BWD_THREADS + w * 128
                       + i for v in range(coo_gather.BWD_PER_THREAD // 4)
                       for i in range(128)]
                idx = [i for i in idx if i < q.shape[0] and g[i] != 0]
                if not idx:
                    continue
                live += 1
                wq = q[idx]
                staged += int(in_smem and below < wq.min()
                              and wq.max() < above)
    return staged, live


@pytest.mark.parametrize("case", CASES)
def test_bwd_search_counts_follow_the_kernels_decisions(case):
    """Which (tile, warp) pairs the backward kernel searches in its CTA's
    staged range, against the decisions made one CTA and one warp at a
    time: a stream of 6,000 entries (twice the capacity) and 12 CTAs of
    queries, so that a CTA of ascending queries spans a twelfth of it."""
    w = _matrix(4, 3000, 0.5, 13)
    enc = tsparse.encode_coo(w, device=CPU)
    assert enc.coords.shape[0] > coo_gather.BWD_CAPACITY
    cta = coo_gather.BWD_SPAN * coo_gather.BWD_TILE
    q, g, _ = case_inputs(case, w, 12 * cta, 15, far=10 ** 6)
    got = coo_gather.bwd_search_counts(enc.coords, t(q), t(g))
    assert got == _search_counts_by_hand(n(enc.coords), q, g)
    assert got[1] > 0
    if case.startswith("runs_") or case == "one_slot":
        assert got[0] == got[1]
    if case in ("shuffled", "wide"):
        assert got[0] == 0


def test_coo_gather_bwd_staged_count_needs_the_kernel():
    coords = torch.tensor([1, 5, tsparse.PAD_COORD], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        coo_gather.coo_gather_bwd_staged(
            coords, torch.tensor([5], dtype=torch.int32), torch.ones(1))


def test_aligned16_is_the_vector_flag():
    buf = torch.zeros(64)
    assert buf.data_ptr() % 16 == 0
    assert _build.aligned16(buf, buf[4:]) == 1
    assert _build.aligned16(buf, buf[1:]) == 0
    assert _build.aligned16(buf[2:]) == 0
