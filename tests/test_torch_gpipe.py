"""`launch/pipeline.gpipe` on 8 CPU ranks over gloo, a (4 stage, 2 data)
mesh, against the reference's `reference_apply` on the same numpy params
(`tests/test_sharding.py::test_gpipe_matches_reference`'s L 8, D 16,
F 32 and 6 micro-batches of 4) and against the port's own; `mlp_stage`
and `reference_apply` against the reference's on one device. The world
is spawned once (`_torch_mesh_ranks`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
import _torch_parity  # noqa: F401  (one intra-op thread per process)
from repro.launch import pipeline as jpipe
from repro_torch.launch import pipeline as tpipe

L, D, F, MICRO, BATCH = 8, 16, 32, 6, 4
STAGES, DATA = 4, 2


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.standard_normal((L, D, F)) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((L, F, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((MICRO, BATCH, D)).astype(np.float32)
    return params, x


def _reference(params, x):
    return np.asarray(jpipe.reference_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))


def _port_reference(params, x):
    return tpipe.reference_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params, x = _inputs()
    out = ranks.spawn(ranks.gpipe_job, STAGES * DATA,
                      tmp_path_factory.mktemp("gpipe"),
                      {"params": params, "x": x,
                       "mesh": {"stages": STAGES, "data": DATA, "model": 1}},
                      timeout_s=150.0)
    return out, _reference(params, x), _port_reference(params, x)


def test_gpipe_matches_the_reference_apply(world):
    out, want, _ = world
    assert want.shape == (MICRO, BATCH, D)
    for rank, res in enumerate(out):
        np.testing.assert_allclose(res["y"], want, atol=1e-5,
                                   err_msg=f"rank {rank}")


def test_gpipe_matches_the_ports_reference_apply(world):
    out, _, port = world
    for rank, res in enumerate(out):
        np.testing.assert_allclose(res["y"], port, atol=1e-5,
                                   err_msg=f"rank {rank}")


def test_gpipe_ranks_cover_the_mesh(world):
    """Rank r sits at (r // 2, r % 2) of (stage, data), and every rank
    returns the last stage's outputs."""
    out, _, _ = world
    coords = [(res["coords"]["stage"], res["coords"]["data"]) for res in out]
    assert coords == [(s, d) for s in range(STAGES) for d in range(DATA)]
    for res in out[1:]:
        np.testing.assert_array_equal(res["y"], out[0]["y"])


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_stage_and_reference_apply_match_the_references(seed):
    """jax.nn.gelu's tanh approximation, layer by layer, on one device."""
    params, x = _inputs(seed)
    np.testing.assert_allclose(_port_reference(params, x),
                               _reference(params, x), atol=1e-5)
    half = {k: v[:L // 2] for k, v in params.items()}
    got = tpipe.mlp_stage({k: torch.from_numpy(v) for k, v in half.items()},
                          torch.from_numpy(x[0])).numpy()
    want = np.asarray(jpipe.mlp_stage({k: jnp.asarray(v)
                                       for k, v in half.items()},
                                      jnp.asarray(x[0])))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gpipe_on_one_stage_is_the_reference_apply():
    """A one-stage mesh needs no process group: no send, no broadcast."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    params, x = _inputs(2)
    mesh = make_pipeline_mesh(stages=1, data=1, model=1, device="cpu")
    got = tpipe.gpipe(tpipe.mlp_stage, mesh)(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _reference(params, x), atol=1e-5)
