"""Checkpoints in the reference's on-disk format. The port of
`repro/ckpt/checkpoint.py`.

API: `save_checkpoint`/`restore_checkpoint` round-trip a tree of tensors
(dicts, lists, tuples, named tuples; None is an empty subtree) through
`step_XXXXXXXX/` directories (restore needs a `like` template);
`save_state_dict`/`restore_state_dict` round-trip flat {name: array} dicts
with the key order in the manifest (no template needed);
`save_field`/`restore_field` checkpoint a `core.field.FieldBackend` in its
current representation: an encoded field's bitmap/COO streams are written
and rebuilt bit for bit, never decompressed. `spill_field`/`unspill_field`
are the serving store's eviction path. `CheckpointManager` adds an async
save and retention.

The format is the reference's, byte for byte, so a checkpoint written by
either package restores in the other:

  * `step_XXXXXXXX/` is written as `step_XXXXXXXX.tmp/`, fsynced and
    renamed, so a crash never leaves a readable partial checkpoint;
  * `manifest.json` holds `{step, treedef, leaves, extra}` with
    `leaves[i] = {shape, dtype, crc}`, `crc = zlib.crc32(arr.tobytes())`,
    checked on restore; a bfloat16 leaf is its raw bits (`<V2` in the
    .npy header, "bfloat16" in the manifest) and restores bit for bit;
  * `leaf_NNNNN.npy` holds leaf i, in the reference's flatten order: a
    dict's keys sorted, lists and tuples in order, None dropped
    (`flatten`). `treedef` is written for readers only; neither package
    parses it;
  * the last `keep` steps are retained.

A tree placed on a mesh of several ranks (DTensor leaves, as the train
step across ranks holds its params and optimizer state) is saved as its
whole values, leaf by leaf through the port's collectives, and written
by the mesh's rank 0 alone: the files are those of one process holding
the same values. A restore places each leaf as its `like` leaf, cut on
each rank with no collective, so a checkpoint written on any mesh
restores onto any other, and onto one process (the reference passes
`shardings=`; here the placements travel with `like`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# -- tree flattening in the reference's leaf order ---------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, treedef string) with leaf i where the reference's
    `jax.tree.flatten` puts it: dict keys in sorted order, list, tuple and
    named-tuple items in order, None an empty subtree, anything else a
    leaf. The string mimics the reference's `str(treedef)`."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            inner = ", ".join(walk(v) for v in x)
            return f"CustomNode(namedtuple[{type(x).__name__}], [{inner}])"
        if isinstance(x, (list, tuple)):
            inner = [walk(v) for v in x]
            if isinstance(x, list):
                return "[" + ", ".join(inner) + "]"
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
                + ")"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(like, leaves: List[Any]):
    """The structure of `like` with its leaves replaced, in `flatten`
    order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}          # the template's key order
        if _is_namedtuple(x):
            return type(x)(*[build(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


# A bfloat16 leaf travels as its raw bits: numpy has no bfloat16, and the
# reference (through ml_dtypes) writes such a leaf as a '<V2' .npy whose
# manifest dtype is "bfloat16", with the crc over the same bytes.
_BF16_BITS = np.dtype("V2")


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array; a bfloat16 tensor as a V2 array of its bits
    (the other tensors keep their dtype). `copy`: an array of its own,
    never a view of a CPU tensor's memory. A DTensor raises: it is made
    whole first (`_host_leaves`)."""
    if _is_dtensor(leaf):
        raise TypeError("a DTensor leaf is made whole on its mesh before "
                        "it is copied to the host")
    if isinstance(leaf, torch.Tensor):
        fresh = leaf.device.type != "cpu"       # .cpu() copies it
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            arr = leaf.contiguous().view(torch.int16).numpy().view(
                _BF16_BITS)
        else:
            arr = leaf.numpy()
        return np.array(arr) if copy and not fresh else arr
    return np.array(leaf) if copy else np.asarray(leaf)


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh_of(flat):
    """The DeviceMesh that the DTensor leaves of `flat` lie on (None where
    none is a DTensor); leaves on two meshes raise."""
    dm = None
    for x in flat:
        if _is_dtensor(x):
            if dm is None:
                dm = x.device_mesh
            elif x.device_mesh != dm:
                raise ValueError(f"a tree on two meshes: {dm} and "
                                 f"{x.device_mesh}")
    return dm


def _writes(dm) -> bool:
    """Whether this rank writes a tree on DeviceMesh `dm`: the mesh's rank
    0 does (and one process, `dm` None)."""
    return dm is None or all(c == 0 for c in dm.get_coordinate())


def _host_leaves(flat, copy: bool = False):
    """Each leaf of `flat` in turn as a host array on the rank that
    writes, None on the others. A DTensor leaf is made whole on its mesh
    by the port's collectives (`sharding.whole_on_mesh`): every rank of
    the mesh takes the leaves in the same order, on its own thread, and
    the whole leaf leaves the device before the next is gathered, so no
    rank holds the whole tree on its device."""
    writer = _writes(_mesh_of(flat))
    for leaf in flat:
        if _is_dtensor(leaf):
            from repro_torch.models.sharding import whole_on_mesh
            with torch.no_grad():
                w = whole_on_mesh(leaf.detach()).to_local().contiguous()
            arr = _host(w, copy) if writer else None
            del w
            yield arr
        else:
            yield _host(leaf, copy) if writer else None


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_BITS else str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray) -> None:
    """`np.save`, except that a bfloat16 leaf's header says '<V2', as the
    reference's does (numpy writes '|V2' for a plain V2 array)."""
    if arr.dtype != _BF16_BITS:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False,
            "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


# -- step directories ---------------------------------------------------------


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3,
                    extra_meta: Optional[dict] = None):
    """Write `tree` as step `step` of `directory` and return its path. A
    tree placed on a mesh of several ranks (DTensor leaves) is written
    as its whole values, the files those of one process: every rank of
    the mesh must call this (each leaf is made whole by a collective),
    and only the mesh's rank 0 writes (the others return None)."""
    flat, treedef = flatten(tree)
    arrays = _host_leaves(flat)
    if not _writes(_mesh_of(flat)):
        for _ in arrays:                        # the collectives only
            pass
        return None
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "treedef": treedef, "leaves": [],
                "extra": extra_meta or {}}
    for i, arr in enumerate(arrays):
        _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({
            "shape": list(arr.shape), "dtype": _dtype_name(arr),
            "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _apply_retention(directory, keep)
    return final


def _apply_retention(directory: str, keep: int):
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _load_leaf(path: str, i: int, meta: dict) -> np.ndarray:
    """Leaf i as a fresh, writable array of its manifest dtype; a bfloat16
    leaf as int16 holding its bits (`_tensor` makes it bfloat16 again)."""
    arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
    crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
    if crc != meta["crc"]:
        raise IOError(f"checkpoint corruption in leaf {i} of {path}")
    if meta["dtype"] == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise IOError(f"leaf {i} of {path}: bfloat16 in the manifest, "
                          f"{arr.dtype} on disk")
        return arr.view(np.int16)
    return arr.astype(np.dtype(meta["dtype"]))


def _tensor(arr: np.ndarray, meta: dict) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device: DeviceLike = None) -> Any:
    """Restore into the structure of `like`, every leaf a tensor on
    `device` (None: the card), but a leaf whose `like` is a DTensor is
    placed as it (`sharding.place` of the whole value: this rank's shard
    is cut on the host, with no collective, and copied to the device of
    like's shard). The files hold whole values, so a checkpoint written
    on any mesh restores onto any other, and onto one process."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = read_manifest(directory, step)
    flat_like, _ = flatten(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: {len(flat_like)} vs "
                         f"{len(manifest['leaves'])}")
    out = []
    for i, (meta, ref) in enumerate(zip(manifest["leaves"], flat_like)):
        # _load_leaf's arrays are fresh and writable (0-d arrays stay 0-d)
        t = _tensor(_load_leaf(path, i, meta), meta)
        if _is_dtensor(ref):
            from repro_torch.models.sharding import place
            out.append(place(t, ref.placements, ref.device_mesh,
                             device=ref.to_local().device))
        else:
            out.append(t.to(dev))
        del t
    return unflatten(like, out)


# --------------------------------------------------------------------------
# Flat state dicts + encoded radiance fields
# --------------------------------------------------------------------------


def save_state_dict(directory: str, step: int, state: dict, *,
                    keep: int = 3, extra_meta: Optional[dict] = None):
    """Save a flat {name: array} dict; names are recorded in the manifest so
    the restore needs no `like` template."""
    meta = dict(extra_meta or {})
    meta["state_keys"] = sorted(state)
    return save_checkpoint(directory, step, dict(state), keep=keep,
                           extra_meta=meta)


def restore_state_dict(directory: str, step: int):
    """-> ({name: np.ndarray}, extra_meta). Inverse of save_state_dict."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = read_manifest(directory, step)
    keys = manifest.get("extra", {}).get("state_keys")
    if keys is None:
        raise ValueError(f"checkpoint at {path} is not a state-dict "
                         f"checkpoint (no state_keys in manifest)")
    if len(keys) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint at {path}: {len(keys)} state keys "
                         f"for {len(manifest['leaves'])} leaves")
    # a dict flattens in sorted-key order, so leaf i <-> sorted key i
    arrays = {k: _load_leaf(path, i, meta)
              for i, (k, meta) in enumerate(zip(keys, manifest["leaves"]))}
    return arrays, manifest["extra"]


def save_field(directory: str, step: int, field, *, keep: int = 3,
               extra_meta: Optional[dict] = None):
    """Checkpoint a FieldBackend in its current representation: an encoded
    field's bitmap/COO streams are written as they are (no decompress)."""
    from repro_torch.core import field as field_lib

    spec, arrays = field_lib.field_state(field)
    meta = dict(extra_meta or {})
    meta["field_spec"] = spec
    return save_state_dict(directory, step, arrays, keep=keep,
                           extra_meta=meta)


def restore_field(directory: str, step: int, cfg, *,
                  device: DeviceLike = None):
    """-> (FieldBackend on `device`, extra_meta). Rebuilds the exact
    representation `save_field` wrote (formats, nnz, packed bytes)."""
    from repro_torch.core import field as field_lib

    arrays, extra = restore_state_dict(directory, step)
    spec = extra.get("field_spec")
    if spec is None:
        raise ValueError(f"checkpoint at {directory} step {step} has no "
                         f"field_spec: not a field checkpoint")
    return field_lib.field_from_state(spec, arrays, cfg,
                                      device=device), extra


SPILL_STEP = 0


def spill_field(directory: str, field, *, extra_meta: Optional[dict] = None):
    """Demote a resident field to disk (the serving SceneStore's eviction
    path): one `save_field` checkpoint at a fixed step with keep=1, so a
    scene's spill directory holds exactly its latest encoded streams."""
    return save_field(directory, SPILL_STEP, field, keep=1,
                      extra_meta=extra_meta)


def unspill_field(directory: str, cfg, *, device: DeviceLike = None):
    """-> (FieldBackend, extra_meta). Inverse of `spill_field`: the exact
    representation that was evicted, so a revived scene renders as
    before."""
    return restore_field(directory, SPILL_STEP, cfg, device=device)


class CheckpointManager:
    """Async save + restore-latest + retention. One writer at a time. On a
    mesh of several ranks (a tree of DTensors) every rank of the mesh
    calls each method at the same points: the leaves are made whole on
    the callers' threads, and only the mesh's rank 0 holds the host copy
    and writes (retention included). `timings` holds, per save, the
    seconds of the gather and host copy (`gather_s`, the caller's
    thread), of the write (`write_s`, rank 0's thread) and the bytes
    written, and per restore its seconds."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.timings: List[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any):
        """Copy every leaf to host numpy on the caller's thread (a placed
        leaf made whole first; so the caller may go on updating its
        tensors), then write on a thread (on the mesh's rank 0 only)."""
        self.wait()                             # one save in flight
        t0 = time.perf_counter()
        flat, _ = flatten(tree)
        writer = _writes(_mesh_of(flat))
        arrays = list(_host_leaves(flat, copy=True))
        rec = {"what": "save", "step": step,
               "gather_s": time.perf_counter() - t0}
        self.timings.append(rec)
        if not writer:
            return
        rec["bytes"] = sum(a.nbytes for a in arrays)
        host_tree = unflatten(tree, arrays)
        del arrays

        def work():
            t1 = time.perf_counter()
            try:
                save_checkpoint(self.directory, step, host_tree,
                                keep=self.keep)
                rec["write_s"] = time.perf_counter() - t1
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self, timeout: Optional[float] = None):
        """Join the save in flight and raise its error, if any. With a
        `timeout`, a save still running after it raises TimeoutError."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"checkpoint save still running after {timeout}s")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like: Any, *, device: DeviceLike = None):
        """(step, tree) of the latest published step restored into the
        structure of `like` (`restore_checkpoint`), or (None, None). On a
        mesh of several ranks the mesh's rank 0 picks the step once its
        writer has joined and tells the others (an all-reduce), so every
        rank restores the same step and none reads one before it is
        published."""
        self.wait()
        t0 = time.perf_counter()
        flat, _ = flatten(like)
        dm = _mesh_of(flat)
        step = latest_step(self.directory)
        if dm is not None:
            from repro_torch.models.sharding import local_part, sum_over
            dev = next(local_part(x).device for x in flat if _is_dtensor(x))
            pick = torch.tensor([-1 if step is None else step],
                                dtype=torch.int64, device=dev)
            if not _writes(dm):
                pick.zero_()
            step = int(sum_over(pick, dm, range(dm.ndim))[0])
            step = None if step < 0 else step
        if step is None:
            return None, None
        out = restore_checkpoint(self.directory, step, like, device=device)
        self.timings.append({"what": "restore", "step": step,
                             "seconds": time.perf_counter() - t0})
        return step, out
