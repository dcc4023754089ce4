"""Fleet tier, worker side: one process = one `SceneStore`-backed
`RenderEngine`, driven over a pipe by `serving.router.FleetRouter`. The
port of `repro/serving/fleet.py`.

Hot scenes only stay resident near the requests that need them when
scenes are sharded across worker processes with scene-affinity routing
(`router.HashRing`), so each worker's working set fits its budget. On one
card, several workers also give the card more work: a single serving
loop is host-bound, and workers run their host loops side by side.

This module owns everything that crosses the process boundary:

  * **Wire format** (`pack_msg`/`unpack_msg`): length-prefixed framing,
    byte for byte the reference's: a 4-byte big-endian JSON-header
    length, the UTF-8 JSON header, then for each array an 8-byte length
    prefix and its raw C-order bytes (dtype/shape in the header's
    ``_arrays`` table). No pickle: the protocol is explicit and versioned
    (``_v``), so a router and a worker from different builds fail loudly
    instead of silently mis-decoding. Messages travel over
    `multiprocessing.Pipe` connections via ``send_bytes``/``recv_bytes``.
    Only host arrays cross: cameras are copied off the card before they
    are packed, and a worker builds them on the CPU (the engine moves
    them, as for any submit).
  * **Scene export** (`export_scene`/`load_scene`): a scene's source of
    truth on shared storage, in the reference's on-disk format: the
    encoded field (`ckpt.spill_field`, bitmap/COO streams as they are)
    plus its cube set (`store.save_cubes`). A worker loads and registers
    it exactly, so replicated hot scenes serve the same frames from every
    replica and a re-registration after a crash is safe.
  * **Worker loop** (`worker_main`): drains all queued messages each
    cycle (so a burst micro-batches through one engine flush), answers
    control ops inline (register / evict / prefetch / pin / stats /
    inject / ping / shutdown), and resolves render ops through
    `RenderEngine.submit(...deadline_s=...)`: the engine's deadline
    semantics fail stale requests with a timed-out result.

The worker's device arrives as a string in `engine_kwargs["device"]`
(the router resolves it before it spawns: None means the card, and
raises without one). Workers are started with the "spawn" method: a
forked child of a process that holds a CUDA context cannot use CUDA.

Fault injection is part of the protocol: the ``inject`` op plants an
artificial pre-flush stall in the worker, which is how tests build slow
workers that still speak the protocol. A SIGKILLed worker's pipe EOFs and
the router re-hashes (`router.FleetRouter._on_worker_death`).
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Dict, Tuple

import numpy as np

WIRE_VERSION = 1

# wire-safety allowlist (docs/static_analysis.md): the only dtypes a frame
# header may name. `unpack_msg` rejects anything else before frombuffer, so
# a malformed or hostile header can never make numpy reinterpret raw bytes
# as object/void/structured records.
WIRE_DTYPES = ("bool", "uint8", "uint16", "uint32", "uint64",
               "int8", "int16", "int32", "int64",
               "float16", "float32", "float64")

# repro-lint lock-discipline declarations (docs/static_analysis.md)
GUARDED_BY = {
    "_Worker": {"lock": "_prefetch_lock", "attrs": ("_prefetches",)},
}

# header-length prefix (u32) / per-array length prefix (u64)
_HDR_LEN = struct.Struct(">I")
_ARR_LEN = struct.Struct(">Q")


class WireError(ValueError):
    """A frame that does not decode under this protocol version."""


def pack_msg(msg: Dict) -> bytes:
    """Encode one message: JSON-able fields go in the header, top-level
    numpy arrays are hoisted into length-prefixed raw buffers described by
    the header's ``_arrays`` table. `unpack_msg` is the exact inverse."""
    head, arrays = {}, []
    for k, v in msg.items():
        if isinstance(v, np.ndarray):
            arrays.append((k, np.ascontiguousarray(v)))
        else:
            head[k] = v
    head["_v"] = WIRE_VERSION
    head["_arrays"] = [{"key": k, "dtype": str(a.dtype),
                        "shape": list(a.shape)} for k, a in arrays]
    hb = json.dumps(head).encode("utf-8")
    parts = [_HDR_LEN.pack(len(hb)), hb]
    for _, a in arrays:
        b = a.tobytes()
        parts.append(_ARR_LEN.pack(len(b)))
        parts.append(b)
    return b"".join(parts)


def unpack_msg(buf: bytes) -> Dict:
    """Decode one `pack_msg` frame back into a dict (arrays as numpy)."""
    if len(buf) < _HDR_LEN.size:
        raise WireError(f"frame too short ({len(buf)} bytes)")
    (hlen,) = _HDR_LEN.unpack_from(buf, 0)
    off = _HDR_LEN.size
    if len(buf) < off + hlen:
        raise WireError("truncated header")
    head = json.loads(buf[off:off + hlen].decode("utf-8"))
    off += hlen
    if head.get("_v") != WIRE_VERSION:
        raise WireError(f"wire version {head.get('_v')!r}, "
                        f"expected {WIRE_VERSION}")
    msg = {k: v for k, v in head.items() if k not in ("_v", "_arrays")}
    for spec in head["_arrays"]:
        if spec.get("dtype") not in WIRE_DTYPES:
            raise WireError(
                f"array '{spec.get('key')}' has dtype "
                f"{spec.get('dtype')!r}, not in the WIRE_DTYPES allowlist")
        if len(buf) < off + _ARR_LEN.size:
            raise WireError(f"truncated array '{spec['key']}'")
        (alen,) = _ARR_LEN.unpack_from(buf, off)
        off += _ARR_LEN.size
        raw = buf[off:off + alen]
        if len(raw) != alen:
            raise WireError(f"truncated array '{spec['key']}'")
        off += alen
        msg[spec["key"]] = np.frombuffer(
            raw, dtype=np.dtype(spec["dtype"])).reshape(spec["shape"]).copy()
    return msg


def to_host(x, dtype=np.float32) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def cam_to_wire(cam) -> Dict:
    """Flatten a `rendering.Camera` into wire fields (prefix `cam_`); its
    tensors are copied to the host first."""
    return {"cam_c2w": to_host(cam.c2w),
            "cam_origin": to_host(cam.origin),
            "cam_focal": float(cam.focal),
            "cam_h": int(cam.h), "cam_w": int(cam.w)}


def cam_from_wire(msg: Dict):
    """The camera of a `cam_to_wire` message, its tensors on the CPU."""
    import torch

    from repro_torch.core.rendering import Camera

    return Camera(torch.from_numpy(np.array(msg["cam_c2w"], np.float32)),
                  torch.from_numpy(np.array(msg["cam_origin"], np.float32)),
                  float(msg["cam_focal"]), int(msg["cam_h"]),
                  int(msg["cam_w"]))


# -- scene export (shared-storage source of truth) -------------------------


def export_scene(path: str, field, cubes=None, *, cfg=None,
                 scene: str = "") -> str:
    """Write a scene's registration source: the encoded field streams
    (`ckpt.spill_field`, bit for bit) + its cube set. Workers register
    from this path (`load_scene`), so every replica, and every
    re-registration after a crash, serves the identical representation.
    Cubes are built here once when not supplied (needs `cfg`; on the
    card, through the gather kernels for an encoded field)."""
    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.core import field as field_lib
    from repro_torch.core import occupancy as occ_lib
    from repro_torch.serving import store as store_lib

    if cfg is not None:
        field = field_lib.as_backend(field, cfg).encode()
    if cubes is None:
        if cfg is None:
            raise ValueError("export_scene needs cubes or cfg to build them")
        occ = occ_lib.build_occupancy(field, cfg)
        cubes = occ_lib.extract_cubes(occ, cfg)
    os.makedirs(path, exist_ok=True)
    ckpt_lib.spill_field(path, field, extra_meta={"scene": scene})
    store_lib.save_cubes(path, cubes)
    return path


def load_scene(path: str, cfg, *, device=None) -> Tuple[object, object]:
    """-> (FieldBackend, CubeSet) on `device` (None: the card): the exact
    representation `export_scene` wrote (same formats, packed bytes, cube
    geometry)."""
    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.device import resolve_device
    from repro_torch.serving import store as store_lib

    dev = resolve_device(device)
    field, _ = ckpt_lib.unspill_field(path, cfg, device=dev)
    return field, store_lib.load_cubes(path, device=dev)


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count in this process."""
    from repro_torch.kernels import (bitmap_decode, coo_gather,
                                     flash_attention, fused_sample,
                                     volume_render)

    fns = (fused_sample.fused_sigma_app, bitmap_decode.bitmap_gather,
           coo_gather.coo_gather, bitmap_decode.bitmap_matmul,
           volume_render.volume_render, flash_attention.flash_attention,
           bitmap_decode.bitmap_gather_bwd, coo_gather.coo_gather_bwd)
    return {fn.__name__: int(fn.launches) for fn in fns}


# -- worker process --------------------------------------------------------


class _Worker:
    """One worker's serving state: engine + store + injected faults."""

    def __init__(self, name: str, cfg, engine_kwargs: Dict):
        from repro_torch.serving.engine import RenderEngine

        self.name = name
        self.cfg = cfg
        self.engine = RenderEngine(cfg, **engine_kwargs)
        self.stall_s = 0.0            # fault injection: pre-flush sleep
        self._prefetches = 0
        self._prefetch_lock = threading.Lock()
        self._prefetch_threads = []

    def register(self, scene: str, path: str, *, pin: bool = False,
                 priority: int = 0):
        field, cubes = load_scene(path, self.cfg, device=self.engine.device)
        self.engine.register_scene(scene, field, cubes)
        store = self.engine.store
        if pin:
            store.pin(scene, True)
        if priority:
            store.set_priority(scene, priority)

    def prefetch(self, scene: str):
        """Async revival of a predicted-next scene: the disk I/O runs on a
        background thread so the serving loop never waits behind it."""
        def work():
            try:
                self.engine.store.ensure_resident(scene)
            except Exception:
                pass                  # scene may have been dropped meanwhile
            with self._prefetch_lock:
                self._prefetches += 1
        t = threading.Thread(target=work, name=f"{self.name}-prefetch",
                             daemon=True)
        t.start()
        self._prefetch_threads = [x for x in self._prefetch_threads
                                  if x.is_alive()] + [t]

    def stats(self) -> Dict:
        """The reference's keys, plus the worker's `device`, each scene's
        `dispatch_path` ("evicted" while on disk) and the `launches` of
        every kernel wrapper in this process."""
        s = self.engine.stats()
        store = self.engine.store
        with self._prefetch_lock:
            prefetches = self._prefetches
        return {
            "worker": self.name,
            "views_served": s["views_served"],
            "fps": s["fps"],
            "latency_p50_s": s["latency_p50_s"],
            "latency_p95_s": s["latency_p95_s"],
            "timeouts": s["timeouts"],
            "queue_depth": self.engine.queue_depth(),
            "n_scenes": s["n_scenes"],
            "resident_scenes": s["resident_scenes"],
            "resident_bytes": s["resident_bytes"],
            "evictions": s["evictions"],
            "revivals": s["revivals"],
            "prefetches": prefetches,
            "scene_views": {n: sc["views_served"]
                            for n, sc in s["scenes"].items()},
            "device": str(self.engine.device),
            "scene_dispatch_path": {n: store.dispatch_path(n)
                                    for n in s["scenes"]},
            "launches": kernel_launches(),
        }


def worker_main(conn, name: str, cfg_fields: Dict, engine_kwargs: Dict):
    """Entry point of one fleet worker process (spawn-safe: module level,
    everything it needs arrives as plain dicts). Speaks the `pack_msg`
    protocol on `conn` until EOF or a ``shutdown`` op.

    Per cycle it drains every queued message in arrival order: control
    ops execute inline (pipe FIFO means a ``register`` sent ahead of the
    first ``render`` for a scene lands first), render ops queue into the
    engine and flush once as a micro-batch. A per-message failure answers
    that message with an ``err`` reply instead of killing the worker."""
    from repro_torch.configs.rtnerf import NeRFConfig

    cfg = NeRFConfig(**cfg_fields)
    w = _Worker(name, cfg, engine_kwargs)

    def send(msg: Dict):
        conn.send_bytes(pack_msg(msg))

    running = True
    while running:
        try:
            frames = [conn.recv_bytes()]
        except (EOFError, OSError):
            break
        while conn.poll(0):
            try:
                frames.append(conn.recv_bytes())
            except (EOFError, OSError):
                running = False
                break
        renders = []
        for raw in frames:
            try:
                m = unpack_msg(raw)
                op = m.get("op")
                if op == "render":
                    cam = cam_from_wire(m)
                    gt = m.get("gt")
                    fut = w.engine.submit(cam, gt, scene=m["scene"],
                                          deadline_s=m.get("deadline_s"))
                    renders.append((m["req"], m["scene"], fut,
                                    time.perf_counter()))
                elif op == "register":
                    w.register(m["scene"], m["path"],
                               pin=bool(m.get("pin", False)),
                               priority=int(m.get("priority", 0)))
                    send({"op": "ok", "req": m.get("req")})
                elif op == "evict":
                    w.engine.store.evict(m["scene"])
                    send({"op": "ok", "req": m.get("req")})
                elif op == "prefetch":
                    w.prefetch(m["scene"])
                    send({"op": "ok", "req": m.get("req")})
                elif op == "pin":
                    store = w.engine.store
                    store.pin(m["scene"], bool(m.get("pinned", True)))
                    if "priority" in m:
                        store.set_priority(m["scene"], int(m["priority"]))
                    send({"op": "ok", "req": m.get("req")})
                elif op == "inject":
                    w.stall_s = float(m.get("stall_s", 0.0))
                    send({"op": "ok", "req": m.get("req")})
                elif op == "stats":
                    send({"op": "stats", "req": m.get("req"),
                          "stats": w.stats()})
                elif op == "ping":
                    send({"op": "pong", "req": m.get("req")})
                elif op == "shutdown":
                    running = False
                else:
                    raise WireError(f"unknown op {op!r}")
            except (EOFError, OSError, BrokenPipeError):
                running = False
                break
            except Exception as e:       # answer THIS message, keep serving
                try:
                    req = unpack_msg(raw).get("req")
                except Exception:
                    req = None
                try:
                    send({"op": "err", "req": req,
                          "error": f"{type(e).__name__}: {e}"})
                except (OSError, BrokenPipeError):
                    running = False
                    break
        if w.stall_s > 0:                # injected fault: stalled worker
            time.sleep(w.stall_s)
        if renders:
            try:
                w.engine.flush()
            except Exception as e:
                for req, scene, fut, _ in renders:
                    try:
                        send({"op": "err", "req": req,
                              "error": f"{type(e).__name__}: {e}"})
                    except (OSError, BrokenPipeError):
                        running = False
                renders = []
            for req, scene, fut, t0 in renders:
                try:
                    r = fut.result(timeout=60.0)
                except Exception as e:
                    send({"op": "err", "req": req,
                          "error": f"{type(e).__name__}: {e}"})
                    continue
                out = {"op": "result", "req": req, "scene": r.scene,
                       "worker": name, "timed_out": bool(r.timed_out),
                       "psnr": (None if r.psnr is None else float(r.psnr)),
                       "worker_latency_s": time.perf_counter() - t0}
                if r.img is not None:
                    out["img"] = np.asarray(r.img, np.float32)
                try:
                    send(out)
                except (OSError, BrokenPipeError):
                    running = False
                    break
    try:
        w.engine.close()
    except Exception:
        pass
    try:
        conn.close()
    except Exception:
        pass


def cfg_to_fields(cfg) -> Dict:
    """NeRFConfig -> plain dict for the spawn boundary."""
    import dataclasses

    return dataclasses.asdict(cfg)


def spawn_worker(ctx, name: str, cfg, engine_kwargs: Dict,
                 *, daemon: bool = False):
    """-> (Process, parent Connection). The child runs `worker_main`."""
    parent, child = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=worker_main,
                       args=(child, name, cfg_to_fields(cfg),
                             dict(engine_kwargs)),
                       name=f"fleet-{name}", daemon=daemon)
    proc.start()
    child.close()
    return proc, parent


__all__ = ["WIRE_VERSION", "WIRE_DTYPES", "WireError", "pack_msg",
           "unpack_msg", "cam_to_wire", "cam_from_wire", "export_scene",
           "load_scene", "kernel_launches", "worker_main", "spawn_worker",
           "cfg_to_fields"]
