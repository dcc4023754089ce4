"""The port's `serving.finetune.FineTuneLoop` against the reference's, on
the CPU at `demo_config(tiny=True)`, deterministically: step and publish
counts, per-step losses (within 1e-5 relative of the reference's from
the same encoded field), stop, error propagation, and every thread
joined within a timeout. No timing or PSNR bound (those are the
reference's own failing tests)."""
import numpy as np
import pytest
import torch

from _torch_parity import CPU, carry_field, jax_case, torch_cfg
from repro.core import train as jtrain
from repro_torch.core import train as ttrain
from repro_torch.serving import FineTuneLoop, RenderEngine, SceneStore

JOIN_S = 120.0
KW = dict(steps=4, publish_every=2, n_views=2, image_hw=16)


@pytest.fixture(scope="module")
def start():
    cfg, cf, *_ = jax_case(0.6, threshold=0.99)
    return cfg, cf


def _store(start, name="lego"):
    cfg, cf = start
    store = SceneStore(torch_cfg(cfg), device=CPU)
    store.register(name, carry_field(cf, cfg))
    return store


def test_counts_and_losses_match_the_reference(start):
    """The loop's steps against the reference's trainer driven as its
    FineTuneLoop drives it (occ_every = publish_every), from the same
    field. (The reference's own loop runs over its store's sharded
    placement, which the multi-device reference failures sit behind.)"""
    cfg, cf = start
    jt = jtrain.NerfTrainer(cfg, "lego", field=cf,
                            occ_every=KW["publish_every"],
                            n_views=KW["n_views"], image_hw=KW["image_hw"])
    want = [jt.step() for _ in range(KW["steps"])]
    store = _store(start)
    loop = FineTuneLoop.attach(store, "lego", **KW)
    assert loop.trainer.device == CPU
    loop.start()
    loop.join(JOIN_S)
    assert not loop.running()
    assert [h["step"] for h in loop.history] == [0, 1, 2, 3]
    assert [s["step"] for s in loop.swaps] == [1, 3]
    for a, b in zip(want, loop.history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    st = store.stats(scene="lego")
    assert st["swaps"] == 2
    text = store.metrics.snapshot()
    assert any("finetune_steps" in k for k in text["counters"])
    # the published field is the trainer's last snapshot, encoded
    published = store.get_field("lego")
    assert published.kind == "compressed"
    for k, v in loop.trainer.snapshot().trainable().items():
        assert torch.equal(published.trainable()[k], v), k


def test_engine_target_routes_to_the_scene_and_serves_while_training(start):
    cfg, cf = start
    eng = RenderEngine(torch_cfg(cfg), carry_field(cf, cfg), device=CPU,
                       ray_chunk=256, scene_name="lego")
    loop = FineTuneLoop(eng, "lego", **KW)
    assert loop.scene == "lego"
    from repro_torch.data import rays as trays
    cam = trays.make_cameras(3, 8, 8, device="cpu")[0]
    loop.start()
    futs = [eng.submit(cam, scene="lego") for _ in range(2)]
    eng.flush()
    imgs = [f.result(timeout=JOIN_S).img for f in futs]
    loop.join(JOIN_S)
    assert all(np.isfinite(i).all() for i in imgs)
    assert len(loop.swaps) == 2
    other = FineTuneLoop(eng, "chair", **KW)       # not registered: default
    assert other.scene == "lego"


def test_stop_ends_after_the_current_step(start):
    loop = FineTuneLoop.attach(_store(start), "lego", steps=50,
                               publish_every=100, n_views=2, image_hw=16)
    step = loop.trainer.step

    def step_then_stop():
        rec = step()
        if loop.trainer.step_count == 2:
            loop.stop()
        return rec
    loop.trainer.step = step_then_stop
    loop.start()
    loop.join(JOIN_S)
    assert [h["step"] for h in loop.history] == [0, 1]
    assert loop.swaps == []                      # stopped before step 100


def test_context_manager_stops_and_joins(start):
    """Leaving the block asks the loop to stop and joins it: at most the
    step in progress finishes, and nothing is published after it."""
    with FineTuneLoop.attach(_store(start), "lego", steps=50,
                             publish_every=100, n_views=2,
                             image_hw=16) as loop:
        assert loop.running() or len(loop.history) == 50
    assert not loop.running()
    assert len(loop.history) <= 1 and loop.swaps == []


def test_trainer_errors_are_reraised_on_join(start):
    loop = FineTuneLoop.attach(_store(start), "lego", **KW)
    step = loop.trainer.step

    def fail_on_second():
        if loop.trainer.step_count == 1:
            raise FloatingPointError("boom")
        return step()
    loop.trainer.step = fail_on_second
    loop.start()
    with pytest.raises(FloatingPointError, match="boom"):
        loop.join(JOIN_S)
    assert len(loop.history) == 1 and not loop.running()
    loop.join(JOIN_S)                             # the error is reported once
    with pytest.raises(RuntimeError, match="already started"):
        loop.start()


def test_attach_checks_and_init_start(start):
    store = _store(start)
    with pytest.raises(KeyError, match="not registered"):
        FineTuneLoop.attach(store, "chair", **KW)
    with pytest.raises(TypeError, match="SceneStore or RenderEngine"):
        FineTuneLoop(object(), "lego", **KW)
    fresh = FineTuneLoop.attach(store, "lego", start_field="init", **KW)
    assert fresh.trainer.field.kind == "dense"
    assert fresh.trainer.device == CPU
    assert isinstance(fresh.trainer, ttrain.NerfTrainer)
