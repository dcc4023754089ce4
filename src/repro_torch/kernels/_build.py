"""Build and load the port's CUDA kernels.

Every source under `csrc/` is compiled by `nvcc` for `sm_90a` (Hopper),
one `nvcc` process per source, all started together; the objects link
into one shared library with a plain C interface, loaded with `ctypes`.
The library lands in `kernels/build/<hash>/` (git-ignored), keyed by a
hash of the sources and flags, so a checkout builds once at first use and
reuses the library after. Nothing is built when the module is imported:
the CPU tests import every module and have no `nvcc`.

Each C entry point takes device pointers and PyTorch's current stream as
`void*` and returns `cudaGetLastError()` after its launch; `check` turns
a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p          # device pointer or stream
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float

MAX_SMEM_BYTES = 232448   # a block's shared-memory limit on sm_90 (227 KB)


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build() -> Path:
    """Compile (or reuse) the kernel library; returns its path. Raises on
    any compiler failure, with the compiler's output in the message."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in srcs:
        obj = out / f"{src.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    (out / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out / f"tmp{os.getpid()}_{LIB_NAME}"
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *[str(o) for _s, o, _p in procs]],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{res.stdout}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """The compiler output of the current build (ptxas register and
    shared-memory use per kernel), or "" before the first build."""
    p = build_dir() / "build.log"
    return p.read_text() if p.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.repro_cuda_error_string.argtypes = [I32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def entry(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point `name`, typed: pointers and the stream as void*,
    or ctypes would pass them as 32-bit ints and cut them."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = I32
    return fn


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def require(cond: bool, msg: str, *args) -> None:
    """Input validation for the wrappers: raise ValueError unless `cond`.
    With `args`, the message is `msg.format(*args)`, formatted only when
    the check fails (the wrappers run these checks on every call)."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)


def all_on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (the wrapper then runs its
    plain version), False if none does; a mix raises."""
    on_cpu = [t.device.type == "cpu" for t in tensors]
    require(all(on_cpu) or not any(on_cpu),
            f"{name}: tensors on the CPU and on "
            f"{[str(t.device) for t in tensors]}")
    return all(on_cpu)


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple = None) -> None:
    """`t` is a contiguous CUDA tensor of `dtype` (and `shape`, if given).
    The messages are built only when a check fails."""
    if (t.device.type == "cuda" and t.dtype == dtype and t.is_contiguous()
            and (shape is None or tuple(t.shape) == tuple(shape))):
        return
    require(t.device.type == "cuda", f"{name}: expected a CUDA tensor, got "
            f"{t.device}")
    require(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    require(t.is_contiguous(), f"{name}: expected a contiguous tensor")
    if shape is not None:
        require(tuple(t.shape) == tuple(shape),
                f"{name}: expected shape {tuple(shape)}, got "
                f"{tuple(t.shape)}")
