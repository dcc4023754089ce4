"""How far the float32 gradients of the LM train step across ranks and in
one process each lie from a float64 pass, on one CUDA card.

    python3 scripts/lm_mesh_train_f64.py [--seed 0] [--arch zamba2-7b ...]

For each of `chip_smoke.LM_MESH_TRAIN_RUNS`' enc-dec, hybrid and RWKV6
runs (published widths, depth cut; batch 4 x 128; float32, AdamW), as
the smoke's lm_mesh_train part runs it: step 1's gradients in one
process and on the run's mesh (two gloo ranks sharing the card), and
the same params and batch in one process in float64. Prints one JSON
line a run: each leaf's max |difference| over its float64 gradient's
largest, mesh against one process, one process against float64 and
mesh against float64 (on the smoke's fixed stride of samples), the
largest first. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TRUNKS = ("zamba2-7b", "rwkv6-1.6b", "seamless-m4t-large-v2")
SHOWN = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", nargs="*", default=list(TRUNKS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_mesh_train_f64: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    lm = cs.lm_modules()
    runs = tuple(dict(r, dtypes=("float32",))
                 for r in cs.LM_MESH_TRAIN_RUNS if r["arch"] in args.arch)
    cs.LM_MESH_TRAIN_RUNS = runs
    single = cs.lm_mesh_train_single_all(torch, lm, args.seed, dev)
    one_rank = lm.sharding.make_rules(lm.elastic.make_mesh_from([dev], 1))
    truth = {}
    for run in runs:
        cfg = cs.lm_mesh_train_cfg(lm, run)
        params = cs.lm_mesh_params(torch, lm, cfg, "float64", args.seed, dev)
        batch = cs.lm_train_batch(lm, cfg, cs.LM_MESH_TRAIN["batch"],
                                  cs.LM_MESH_TRAIN["seq"], args.seed, 0, dev)
        with lm.sharding.use_rules(one_rank):
            _, _, grads = lm.steps.loss_and_grads(cfg, params, batch)
        del params
        truth[run["key"]] = (cs.tree_samples(torch, lm, grads),
                             cs.leaf_maxes(torch, grads))
        del grads
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lm_mesh_train_f64_") as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), none=np.zeros(1))
        for shape in sorted({tuple(r["world"]) for r in runs}):
            wdir = os.path.join(tmp, f"w{shape[0]}x{shape[1]}")
            os.makedirs(wdir)
            os.symlink(os.path.join(tmp, "inputs.npz"),
                       os.path.join(wdir, "inputs.npz"))
            world = [r for r in runs if tuple(r["world"]) == shape]
            cs.lm_mesh_world(wdir, str(dev), shape, [], args.seed, world)
            for run in world:
                one, one_sets = single[cs.lm_mesh_ref(
                    dict(run, dispatch=None))]["float32"]
                got = cs.assemble_samples(
                    [os.path.join(wdir, cs.lm_mesh_train_file(
                        run["key"], "float32", r))
                     for r in range(shape[0] * shape[1])], one_sets)
                t_sets, t_max = truth[run["key"]]
                leaves = []
                for path, (_, o), g, (_, t), m in zip(
                        one["leaf_paths"], one_sets["grads"], got["grads"],
                        t_sets, t_max):
                    if m:
                        leaves.append({
                            "leaf": path,
                            "mesh_vs_one": float(np.abs(g - o).max() / m),
                            "one_vs_f64": float(np.abs(o - t).max() / m),
                            "mesh_vs_f64": float(np.abs(g - t).max() / m)})
                leaves.sort(key=lambda x: -x["mesh_vs_one"])
                print(json.dumps({
                    "key": run["key"],
                    "max": {k: max(x[k] for x in leaves) for k in (
                        "mesh_vs_one", "one_vs_f64", "mesh_vs_f64")},
                    "leaves": leaves[:SHOWN]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
