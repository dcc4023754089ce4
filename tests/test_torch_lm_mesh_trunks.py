"""The port's enc-dec, Mamba2-hybrid and RWKV6 trunks across ranks against
the reference's single-device results: reduced seamless-m4t-large-v2,
zamba2-7b and rwkv6-1.6b on the CPU worlds of
`tests/test_torch_lm_mesh.py` (2 x 2, 1 x 2 and 2 x 1 gloo ranks, each
spawned once through `_torch_mesh_ranks.lm_job`) run `model_loss`,
prefill, teacher-forced decode steps and `serve_lm` with every param,
batch and cache placed by its resolved spec. The same tolerances as
there: float32 logits and losses within 1e-4 and greedy tokens exactly;
bf16 losses within 5e-2 and bf16 logits by the 1.25 noise ratio against
the port's one-rank bf16; each rank's local shard of every leaf
(`in_proj`, `conv_w` and RWKV6's `cwr` among them) of the shape that the
reference's PartitionSpecs give; no `_c10d_functional::` op. The
reference's seamless runs op by op (ROADMAP.md Queue 3 item 18), the
other two jitted. The hybrid's `model_loss` is also held with the
chunked SSD (`ssm_impl="chunked"`).

After serving, the same worlds train (`_torch_mesh_ranks.train_cases`):
each trunk's `loss_and_grads` and one AdamW `build_train_step` step on
placed params, state and batch, held by `test_torch_lm_mesh_train`'s
tests against the reference's single-device `jax.value_and_grad` and
train step (seamless op by op): float32 loss, metrics and grad_norm
within 1e-4, every gradient leaf within 1e-4 of its largest (rwkv6
5e-4, ROADMAP.md Queue 3 item 23; the seamless `enc.ln1` one bf16 ulp,
item 24), the AdamW step by `close_adamw_first_step` (item 25), each
rank's shards of the resolved shapes and its share of the bytes, no
functional collective; on 2 x 2 also bf16 gradients by the 1.25 noise
ratio, adafactor on seamless and grad_accum=2 with sgd on zamba2.

Then the serving launcher under `torchrun --nproc-per-node 2` on the
CPU, for each of the three archs: it serves (the launcher refused them
across ranks before), and prints the one process's sample tokens."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import test_torch_lm_mesh as lm_mesh
import test_torch_lm_mesh_train as lm_train
from repro.models import transformer as jtf

TRUNKS = ("seamless-m4t-large-v2", "zamba2-7b", "rwkv6-1.6b")
CASES = [(w, n) for w in lm_mesh.WORLDS for n in TRUNKS]
IDS = [f"{w}-{n}" for w, n in CASES]
ADAFACTOR = "seamless-m4t-large-v2"
ACCUM = "zamba2-7b"             # grad_accum=2 with sgd
LAUNCH_ARGS = ["--device", "cpu", "--batch", "4", "--prompt-len", "8",
               "--gen", "4"]
LAUNCH_TIMEOUT_S = 300


def _launch(names):
    """The launcher in one process and under torchrun (two CPU ranks,
    one intra-op thread each), every run started at once: {name: (one
    process's output, torchrun's return code, output and errors)}."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = {}
    for name in names:
        args = ["--arch", name] + LAUNCH_ARGS
        procs[name] = (
            subprocess.Popen([sys.executable, "-m",
                              "repro_torch.launch.serve"] + args,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env),
            subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc-per-node", "2", "-m",
                              "repro_torch.launch.serve"] + args,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env))
    out = {}
    try:
        for name, (one, two) in procs.items():
            one_out, _ = one.communicate(timeout=LAUNCH_TIMEOUT_S)
            two_out, two_err = two.communicate(timeout=LAUNCH_TIMEOUT_S)
            out[name] = (one_out, two.returncode, two_out, two_err)
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return out


def _train_cases(world):
    """The train cases a world runs after serving: each trunk's float32
    gradients and AdamW step; on 2 x 2 also each trunk's bf16 gradients,
    adafactor on the enc-dec and grad_accum=2 with sgd on the hybrid."""
    cases = {f"{n}/adamw": {"arch": n, "dtype": "float32", "grads": True,
                            "opt": "adamw"} for n in TRUNKS}
    if world == "2x2":
        cases.update({f"{n}/bf16": {"arch": n, "dtype": "bfloat16",
                                    "grads": True} for n in TRUNKS})
        cases[f"{ADAFACTOR}/adafactor"] = {"arch": ADAFACTOR,
                                           "dtype": "float32",
                                           "opt": "adafactor"}
        cases[f"{ACCUM}/accum"] = {"arch": ACCUM, "dtype": "float32",
                                   "opt": "sgd",
                                   "accum": lm_train.ACCUM[1]}
    return cases


def _train_reference(cases):
    """The reference's train results on the worlds' params and loss
    batches (`test_torch_lm_mesh_train.reference`, `bf16_reference`)."""
    archs = {n: {"params": cases[n]["params"],
                 "batch": cases[n]["loss_batch"]} for n in TRUNKS}
    return {"want": {n: lm_train.reference(
                n, archs[n], adafactor=n == ADAFACTOR, sgd=False,
                accum=n == ACCUM) for n in TRUNKS},
            "bf16": {n: lm_train.bf16_reference(n, archs[n])
                     for n in TRUNKS}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three trunks on every world (serving, then the train cases)
    while this process computes the reference's results; then the
    launcher runs."""
    out = lm_mesh.run_worlds(tmp_path_factory.mktemp("lm_mesh_trunks"),
                             TRUNKS, during=_train_reference,
                             train=_train_cases)
    out["launch"] = _launch(TRUNKS)
    return out


@pytest.fixture(scope="module")
def trained(worlds):
    """The train results as `test_torch_lm_mesh_train`'s tests read
    them."""
    return {"ranks": worlds["ranks"], **worlds["during"]}


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_float32_matches_the_reference(worlds, world, name):
    lm_mesh.test_float32_matches_the_reference(worlds, world, name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_serve_lm_gives_the_references_greedy_tokens(worlds, world, name):
    lm_mesh.test_serve_lm_gives_the_references_greedy_tokens(worlds, world,
                                                            name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_bf16_within_the_noise_of_one_rank(worlds, world, name):
    lm_mesh.test_bf16_within_the_noise_of_one_rank(worlds, world, name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_local_shards_have_the_resolved_shapes(worlds, world, name):
    lm_mesh.test_local_shards_have_the_resolved_shapes(worlds, world, name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_init_model_places_each_leaf_as_it_is_drawn(worlds, world, name):
    lm_mesh.test_init_model_places_each_leaf_as_it_is_drawn(worlds, world,
                                                           name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_collectives_are_gloos_own(worlds, world, name):
    lm_mesh.test_collectives_are_gloos_own(worlds, world, name)


@pytest.mark.parametrize("world", lm_mesh.WORLDS)
def test_hybrid_chunked_loss_matches_the_reference(worlds, world):
    """zamba2's `model_loss` with the chunk-parallel SSD
    (`ssm_impl="chunked"`), which runs on each rank's batch rows as the
    scan does, within 1e-4 of the reference's jitted chunked loss."""
    name = "zamba2-7b"
    jcfg = dataclasses.replace(lm_mesh._cfgs(name)[0], ssm_impl="chunked")
    case = lm_mesh._case(name)
    want = float(jax.jit(lambda p, b: jtf.model_loss(p, jcfg, b)[0])(
        jax.tree.map(np.asarray, case["params"]), case["loss_batch"]))
    for r in worlds["ranks"][world]:
        got = r["archs"][f"{name}/float32"]["loss_chunked"]
        assert abs(got - want) <= lm_mesh.F32_TOL * max(1.0, abs(want))


def test_worlds_are_the_meshes_asked_for(worlds):
    lm_mesh.test_worlds_are_the_meshes_asked_for(worlds)


@pytest.mark.parametrize("name", TRUNKS)
def test_launcher_serves_the_trunk_under_torchrun(worlds, name):
    """`python -m repro_torch.launch.serve --arch <name>` under torchrun
    with two CPU ranks serves on the (2, 1) host mesh and prints the
    sample tokens that one process prints."""
    one_out, rc, out, err = worlds["launch"][name]
    assert rc == 0, err[-3000:]
    one = re.findall(r"^sample: (.*)$", one_out, re.M)
    two = re.findall(r"^sample: (.*)$", out, re.M)
    assert len(one) == 1 and two == one, (one, two, err[-2000:])
    assert "[serve] mesh: {'data': 2, 'model': 1}" in out


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_train_loss_and_grad_norm_match_the_reference(trained, world, name):
    lm_train.test_loss_and_grad_norm_match_the_reference(trained, world,
                                                         name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_train_gradients_match_the_reference(trained, world, name):
    """rwkv6's leaves at 5e-4 (ROADMAP.md Queue 3 item 23), the
    seamless encoder's first norm gain at one bf16 ulp (item 24)."""
    lm_train.test_gradients_match_the_reference(trained, world, name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_train_adamw_step_matches_the_reference(trained, world, name):
    lm_train.test_adamw_step_matches_the_reference(trained, world, name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_train_shards_have_the_resolved_shapes(trained, world, name):
    lm_train.test_shards_have_the_resolved_shapes(trained, world, name)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_train_no_functional_collectives(trained, world, name):
    lm_train.test_no_functional_collectives(trained, world, name)


@pytest.mark.parametrize("world", lm_mesh.WORLDS)
def test_train_each_rank_holds_its_resolved_share_of_params_and_state(
        trained, world):
    """The bytes of a rank's float32 params and AdamW state: exactly those
    of the local shapes that the reference's `param_sharding` and
    `opt_state_sharding` resolve on the world's axes, and less than the
    whole. Rule (b) leaves the trunks' ("embed",)-only leaves whole
    where "data" is 1 (reduced rwkv6-1.6b on 1 x 2: 69% a rank, not a
    half)."""
    for name in TRUNKS:
        shapes = trained["want"][name]["shapes"][world]
        leaves = list(shapes["params"].values()) + list(
            shapes["adamw"].values())
        want = (4 * sum(int(np.prod(local)) for _, local in leaves),
                4 * sum(int(np.prod(shape)) for shape, _ in leaves))
        assert want[0] < want[1]
        for got in lm_train._got(trained, world, f"{name}/adamw"):
            assert tuple(got["bytes"]) == want, (name, got["bytes"], want)


@pytest.mark.parametrize("name", TRUNKS)
def test_train_bf16_within_the_noise_of_one_process_on_2x2(trained, name):
    lm_train.test_bf16_within_the_noise_of_one_process(trained, "2x2",
                                                       name)


def test_train_adafactor_step_matches_the_reference_on_2x2(trained):
    lm_train.test_adafactor_step_matches_the_reference_on_2x2(trained,
                                                              ADAFACTOR)


def test_train_grad_accum_matches_the_reference_on_2x2(trained):
    lm_train.test_grad_accum_matches_the_reference_on_2x2(trained, ACCUM)
