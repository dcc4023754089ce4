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
from repro.models import transformer as jtf

TRUNKS = ("seamless-m4t-large-v2", "zamba2-7b", "rwkv6-1.6b")
CASES = [(w, n) for w in lm_mesh.WORLDS for n in TRUNKS]
IDS = [f"{w}-{n}" for w, n in CASES]
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three trunks on every world while this process computes the
    reference's results; then the launcher runs."""
    out = lm_mesh.run_worlds(tmp_path_factory.mktemp("lm_mesh_trunks"),
                             TRUNKS)
    out["launch"] = _launch(TRUNKS)
    return out


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
