"""The port's synthetic token pipeline (`repro_torch.data.tokens`) against
the reference's: the batch layout of every family (keys, shapes, dtypes,
the zeros of labels and loss_mask over a vision frontend), the stream as a
pure function of (seed, step, shard) in any process, and the dry-run specs
and logical axes. The numbers differ by design (Philox against JAX's
threefry); parity tests of the model carry the reference's batches."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.data import tokens as jtok
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LM_SHAPES, ShapeConfig
from repro_torch.data import tokens as ttok

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ARCHS = sorted(treg.ARCHS)
JDT = {jnp.int32: torch.int32, jnp.float32: torch.float32,
       jnp.bfloat16: torch.bfloat16}


def _streams(name, seq=24, batch=4, **kw):
    jcfg = jreg.reduced(jreg.ARCHS[name])
    tcfg = treg.reduced(treg.ARCHS[name])
    return (jtok.TokenStream(jcfg, JShape("t", seq, batch, "train"), **kw),
            ttok.TokenStream(tcfg, ShapeConfig("t", seq, batch, "train"),
                             device=CPU, **kw))


@pytest.mark.parametrize("name", ARCHS)
def test_batch_layout_is_the_references(name):
    js, ts = _streams(name)
    want, got = js.batch(3), ts.batch(3)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == JDT[want[k].dtype.type], k
        assert got[k].device == CPU
    n_front = js.cfg.n_frontend_tokens if js.cfg.frontend == "vision" else 0
    for k in ("labels", "loss_mask"):
        w = np.asarray(want[k]) == 0
        g = got[k].numpy() == 0
        np.testing.assert_array_equal(g[:, :n_front], w[:, :n_front])
        assert g[:, :n_front].all()
    np.testing.assert_array_equal(got["loss_mask"].numpy(),
                                  np.asarray(want["loss_mask"]))
    # labels are the next tokens
    np.testing.assert_array_equal(got["labels"][:, n_front:-1].numpy(),
                                  got["tokens"][:, 1:].numpy())
    assert int(got["tokens"].min()) >= 0
    assert int(got["tokens"].max()) < ts.cfg.vocab


def test_batch_is_a_pure_function_of_seed_step_and_shard():
    _, a = _streams("internvl2-76b", n_shards=2, shard=1, seed=5)
    _, b = _streams("internvl2-76b", n_shards=2, shard=1, seed=5)
    it = iter(b)
    for step in range(3):
        x, y, z = a.batch(step), b.batch(step), next(it)
        for k in x:
            assert torch.equal(x[k], y[k]) and torch.equal(x[k], z[k])
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    assert a.batch(0)["tokens"].shape[0] == 2          # 4 rows over 2 shards


def test_shards_and_seeds_draw_different_batches():
    _, s0 = _streams("seamless-m4t-large-v2", n_shards=2, shard=0)
    _, s1 = _streams("seamless-m4t-large-v2", n_shards=2, shard=1)
    _, s2 = _streams("seamless-m4t-large-v2", n_shards=2, shard=0, seed=1)
    for k in ("tokens", "enc_frames"):
        assert not torch.equal(s0.batch(0)[k], s1.batch(0)[k])
        assert not torch.equal(s0.batch(0)[k], s2.batch(0)[k])
    with pytest.raises(ValueError, match="range"):
        s0.batch(-1)


def test_batch_is_the_same_in_another_process():
    """No per-process salt: a fresh interpreter draws the same batch."""
    _, ts = _streams("llama3.2-1b", seed=7)
    want = ts.batch(11)["tokens"].numpy()
    code = ("import torch\n"
            "from repro_torch.configs import registry as r\n"
            "from repro_torch.configs.base import ShapeConfig\n"
            "from repro_torch.data.tokens import TokenStream\n"
            "s = TokenStream(r.reduced(r.ARCHS['llama3.2-1b']), "
            "ShapeConfig('t', 24, 4, 'train'), seed=7, device='cpu')\n"
            "print(s.batch(11)['tokens'].flatten().tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTHONHASHSEED="123")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert eval(res.stdout) == want.flatten().tolist()


@pytest.mark.parametrize("shape", sorted(LM_SHAPES))
def test_input_specs_and_logical_are_the_references(shape):
    for name in ARCHS:
        jcfg, tcfg = jreg.ARCHS[name], treg.ARCHS[name]
        jshape, tshape = jreg.get_shape(shape), treg.get_shape(shape)
        want = jtok.input_specs(jcfg, jshape)
        got = ttok.input_specs(tcfg, tshape)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == tuple(want[k].shape)
            assert got[k].dtype == JDT[want[k].dtype.type]
        assert ttok.input_logical(tcfg, tshape) == \
            jtok.input_logical(jcfg, jshape)
