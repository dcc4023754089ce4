"""Contended inputs for the gathers' backward, made with numpy from a seed:
the query streams that the backward kernels' run merge and COO window
must get right (tests/test_torch_gather_bwd.py holds the plain versions
against jax.grad of the reference's oracles on them, at a small size;
tests/test_torch_cuda.py the kernels against the plain versions on the
card). Imports neither jax nor torch.

Cases:
  one_slot        every query the same, on a set bit / a present entry,
                  with whole-number gradients in [-2, 2]: every partial
                  sum of up to 2^22 of them is exact in fp32, so every
                  order of the sum gives the same result and the case
                  is held exactly (EXACT), not within the reordering
                  bound, which at this contention would be vacuous;
  runs_<k>        ascending queries in runs of k equal ones (2, 3, 31,
                  33, 257: runs across a lane's 4 queries, a warp's 128
                  and a CTA's tile), so COO tiles have narrow windows;
  shuffled        runs_33 in a random order: no runs, wide windows;
  zero_stretches  runs_3 with the gradient 0 on alternating stretches;
  out_of_range    runs_3 with every third query past the matrix (bitmap:
                  clamped into its last row; COO: above the last
                  coordinate, absent);
  offset_view     runs_3 with nq % 4 == 1, the gradient a view one float
                  into its buffer (the kernels' scalar path);
  wide            uniform queries in runs of 3: COO windows far wider
                  than the staging capacity.
"""
import numpy as np

CASES = ("one_slot", "runs_2", "runs_3", "runs_31", "runs_33", "runs_257",
         "shuffled", "zero_stretches", "out_of_range", "offset_view",
         "wide")
EXACT = ("one_slot",)    # whole-number gradients: sums exact in any order
EXACT_GRAD_MAX = 2       # |g| of an EXACT case's gradients
ZERO_STRETCH = 4999      # queries a stretch: crosses lanes, rows and tiles


def _runs(base: np.ndarray, k: int, nq: int, ascending: bool
          ) -> np.ndarray:
    """Runs of k equal queries drawn from `base` (over the whole matrix),
    in ascending order or as drawn."""
    heads = base[: -(-nq // k)]
    return np.repeat(np.sort(heads) if ascending else heads, k)[:nq]


def case_inputs(case: str, w: np.ndarray, nq: int, seed: int,
                far: int) -> tuple:
    """(queries int32 (nq',), gradient float32 (nq',), offset) for the
    (rows, cols) matrix w: nq' is nq, or nq - 3 for offset_view, whose
    gradient is to sit `offset` = 1 float into its buffer (0 otherwise).
    Queries past the matrix lie up to `far` beyond it."""
    rng = np.random.RandomState(seed)
    size = w.size
    uniform = rng.randint(0, size, nq)
    run3 = _runs(uniform, 3, nq, True)
    offset = 0
    if case == "one_slot":
        nz = np.flatnonzero(w.reshape(-1))
        q = np.full(nq, nz[len(nz) // 2] if len(nz) else size // 2)
    elif case.startswith("runs_"):
        q = _runs(uniform, int(case[5:]), nq, True)
    elif case == "shuffled":
        q = rng.permutation(_runs(uniform, 33, nq, True))
    elif case == "zero_stretches" or case == "offset_view":
        q = run3
    elif case == "out_of_range":
        q = run3.copy()
        q[::3] = size + rng.randint(0, far, q[::3].shape[0])
    elif case == "wide":
        q = _runs(uniform, 3, nq, False)
    else:
        raise ValueError(case)
    if case == "offset_view":
        q = q[: nq - 3]
        offset = 1
    if case in EXACT:
        g = rng.randint(-EXACT_GRAD_MAX, EXACT_GRAD_MAX + 1,
                        q.shape[0]).astype(np.float32)
    else:
        g = rng.randn(q.shape[0]).astype(np.float32)
        g[rng.rand(q.shape[0]) < 0.2] = 0.0
    if case == "zero_stretches":
        g[(np.arange(q.shape[0]) // ZERO_STRETCH) % 2 == 1] = 0.0
    return q.astype(np.int32), g, offset
