"""Training launcher for the language-model archs: the port of
`repro/launch/train.py`. Real steps on the card (or the CPU when asked),
with the elastic runner's checkpoints, restore and injected failure, the
reference's cosine schedule and its optimizer size rule.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 100 --batch 8 --seq 128 --reduced --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 4 --batch 2 --seq 16 --device cpu --inject-failure 2

`--device` (default `cuda`) is where the model trains; the CPU runs only
when asked for, and without a card the default raises. `--reduced` (the
default) trains the arch's reduced config, `--no-reduced` its published
one. A `--ckpt-dir` that holds a checkpoint of the same model resumes
from it. Prints the device, `trained N steps in ...`, `loss: first=...
last=...` and one `event: ...` line per restore, failure, remesh or
straggler. Training runs in one process: under `torchrun` with more than
one rank the launcher exits before any rank starts: the train step runs
across ranks (`launch.steps.build_train_step` on placed params), but the
elastic runner and its checkpoints of placed state across ranks are
ROADMAP.md Queue 1 item 10e.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch, reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import ElasticRunner
from repro_torch.launch.steps import build_train_step, count_params
from repro_torch.models import transformer as tf
from repro_torch.models.common import split_pl
from repro_torch.models.sharding import make_rules
from repro_torch.optim import cosine_schedule, pick_optimizer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    return ap


def main(argv=None):
    """Train as the command line says; returns the runner's (state, log).
    Under a torchrun environment of several ranks (WORLD_SIZE > 1) it
    exits through argparse's error, code 2, before any rank starts."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        ap.error(f"training runs in one process: the elastic runner and "
                 f"its checkpoints of placed state across "
                 f"{os.environ['WORLD_SIZE']} ranks are ROADMAP.md Queue 1 "
                 f"item 10e")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    print("[train] device: " + (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"), flush=True)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    stream = TokenStream(cfg, shape, device=dev)
    sched = cosine_schedule(max(args.steps // 20, 1), args.steps)

    def build(mesh):
        rules = make_rules(mesh)
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        params, _ = split_pl(tf.init_model(cfg, gen, device=mesh.device))
        opt = pick_optimizer(count_params(params), lr=args.lr,
                             schedule=sched)
        opt_state = opt.init(params)
        fn = build_train_step(cfg, rules, opt)

        def step_fn(state, batch):
            params, opt_state = state
            params, opt_state, metrics = fn(params, opt_state, batch)
            return (params, opt_state), metrics

        return step_fn, (params, opt_state)

    runner = ElasticRunner(build=build, ckpt_dir=args.ckpt_dir,
                           model_axis=1, ckpt_every=args.ckpt_every)
    t0 = time.time()
    state, log = runner.run(args.steps, stream.batch, devices=[dev],
                            inject_failure_at=args.inject_failure)
    dt = time.time() - t0
    losses = [e for e in log if e[0] == "step"]
    print(f"trained {len(losses)} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1):.3f}s/step)")
    if losses:
        print(f"loss: first={losses[0][2]:.4f} last={losses[-1][2]:.4f}")
    for e in log:
        if e[0] != "step":
            print("event:", e)
    return state, log


if __name__ == "__main__":
    main()
