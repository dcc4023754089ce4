"""Pipeline parallelism (GPipe schedule) over a "stage" mesh axis: the
port of `repro/launch/pipeline.py`.

The reference realises it with `shard_map` + `ppermute`; the port runs
one rank a device (`launch.mesh.make_pipeline_mesh`): each rank applies
its stage's slice of the layer stack, micro-batch activations go to the
next stage over `torch.distributed` point-to-point in the "stage" group,
and the bubble is the usual (S - 1) / (M + S - 1): M + S - 1 ticks, every
stage computing on every tick. The last stage's outputs are broadcast to
its stage group, so every rank returns them. Ranks along the other axes
("data", "model") each run the whole pipeline on the same inputs, as the
reference's replicated in_specs do.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F


def gpipe(apply_stage: Callable, mesh, *, axis: str = "stage"):
    """Build a pipelined apply: (params_stacked, x_micro) -> y_micro.

    apply_stage(params_local, x) applies ONE stage's layer block.
    params_stacked leaves: (n_stages * per_stage, ...), each rank takes
    its stage's rows of dim 0. x_micro: (n_micro, micro_batch, ...), the
    same on every rank; stage 0 ingests it."""
    n_stage = mesh.shape[axis]
    group = mesh.group(axis)
    s = mesh.coordinate(axis)

    def peer(i):
        return dist.get_global_rank(group, i)

    def pipelined(params: Dict[str, torch.Tensor], x_micro: torch.Tensor):
        local = {}
        for k, v in params.items():
            if v.shape[0] % n_stage:
                raise ValueError(f"{k}: {v.shape[0]} layers over "
                                 f"{n_stage} stages")
            per = v.shape[0] // n_stage
            local[k] = v[s * per:(s + 1) * per]
        n_micro = x_micro.shape[0]
        buf = torch.zeros_like(x_micro[0])
        outs = torch.zeros_like(x_micro)
        for t in range(n_micro + n_stage - 1):
            inp = x_micro[min(t, n_micro - 1)] if s == 0 else buf
            h = apply_stage(local, inp)
            # emit on the last stage once the pipe is full
            if s == n_stage - 1 and t >= n_stage - 1:
                outs[t - (n_stage - 1)] = h
            ops = []
            if s < n_stage - 1:
                ops.append(dist.P2POp(dist.isend, h.contiguous(), peer(s + 1),
                                      group))
            if s > 0:
                buf = torch.empty_like(buf)
                ops.append(dist.P2POp(dist.irecv, buf, peer(s - 1), group))
            for work in (dist.batch_isend_irecv(ops) if ops else ()):
                work.wait()
        if group is not None:
            # replicate the outputs from the last stage
            dist.broadcast(outs, src=peer(n_stage - 1), group=group)
        return outs

    return pipelined


def _layer(h, w1, w2):
    # jax.nn.gelu's default: the tanh approximation
    return h + F.gelu(h @ w1, approximate="tanh") @ w2


def mlp_stage(params_local: Dict[str, torch.Tensor], x: torch.Tensor):
    """Demonstrator stage: a block of gelu-MLP layers, one after another
    over the local layer dim."""
    h = x
    for w1, w2 in zip(params_local["w1"], params_local["w2"]):
        h = _layer(h, w1, w2)
    return h


def reference_apply(params_stacked: Dict[str, torch.Tensor],
                    x_micro: torch.Tensor):
    """Sequential oracle for tests: the same math over every micro-batch,
    no pipeline."""
    return mlp_stage(params_stacked, x_micro)
