"""Training launcher for the language-model archs: the port of
`repro/launch/train.py`. Real steps on the card (or the CPU when asked),
with the elastic runner's checkpoints, restore and injected failure, the
reference's cosine schedule and its optimizer size rule.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 100 --batch 8 --seq 128 --reduced --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 4 --batch 2 --seq 16 --device cpu --inject-failure 2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch llama3.2-1b --device cpu --inject-failure 2

`--device` (default `cuda`) is where the model trains; the CPU runs only
when asked for, and without a card the default raises. `--reduced` (the
default) trains the arch's reduced config, `--no-reduced` its published
one. A `--ckpt-dir` that holds a checkpoint of the same model resumes
from it, on any number of ranks. Prints the device, `trained N steps in
...`, `loss: first=... last=...` and one `event: ...` line per restore,
failure, remesh or straggler. Under torchrun each process is one rank
(`--device cuda`: its own card; ranks that share one card need
`--device cuda:0 --backend gloo`), and the ranks train on the (world, 1)
("data", "model") mesh, as the reference's launcher on all of its
host's devices: params drawn placed (`init_model(rules=)`), optimizer
state placed as they are, the batch placed by the step. An injected
failure drops half of the ranks; the survivors restore the latest
checkpoint onto their mesh. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch, reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import ElasticRunner
from repro_torch.launch.mesh import init_ranks
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
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the process group's backend; "
                         "gloo for ranks that share one card (default: "
                         "nccl on cards, gloo on the CPU)")
    return ap


def main(argv=None):
    """Train as the command line says; returns the runner's (state, log)
    (None for the state of a rank that an injected failure dropped).
    Under torchrun (WORLD_SIZE set) this process starts its rank first."""
    ap = build_parser()
    args = ap.parse_args(argv)
    started = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        # torchrun: this process is one rank ("cuda" means its own card)
        args.device = str(init_ranks(
            None if args.device == "cuda" else args.device,
            backend=args.backend))
        started = True
    try:
        with contextlib.ExitStack() as stack:
            if dist.is_initialized() and dist.get_rank() != 0:
                # rank 0 prints
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            out = train(args)
        if started:
            # no rank tears its connections down under another's last
            # collective
            dist.barrier()
        return out
    finally:
        if started:
            dist.destroy_process_group()


def train(args):
    """The run of `main` on parsed arguments, on this process's rank."""
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
        params, _ = split_pl(tf.init_model(cfg, gen, device=mesh.device,
                                           rules=rules))
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
                           model_axis=1, ckpt_every=args.ckpt_every,
                           device=dev)
    ranks = (list(range(dist.get_world_size())) if dist.is_initialized()
             else [dev])
    t0 = time.time()
    state, log = runner.run(args.steps, stream.batch, devices=ranks,
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
