"""The bound that params after AdamW's first step are held to, shared by
the CPU parity tests and the card tests (numpy only: the card's machine
has no jax).

At step 1 AdamW moves a param by lr g / (|g| + eps), near sign(g): where
|g| sits at the gradients' own error, two correct runs move it apart by
up to 2 lr (ROADMAP.md Queue 3 item 25). Each param is held to tol x its
leaf's largest plus the first-order reach of a gradient error of tol x
max|g|, lr x 4 tol max|g| / (|g| + eps), with g = m / (1 - b1) (the
first moment of the run compared against)."""
import numpy as np


def adamw_first_step_excess(got, want, m, lr, b1, eps, tol) -> float:
    """The largest ratio over one leaf's params of |got - want| to the
    bound (arrays of one shape; at most 1 passes)."""
    got, want, m = (np.asarray(a, np.float64) for a in (got, want, m))
    g = np.abs(m) / (1 - b1)
    bound = tol * np.abs(want).max() + lr * 4 * tol * g.max() / (g + eps)
    diff = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(diff == 0, 0.0, diff / bound)
    return float(ratio.max()) if ratio.size else 0.0
