"""Flash attention, forward, with an fp32 online softmax. The port of
`repro/kernels/flash_attention.py`.

q (B, H, Sq, D), k and v (B, H, Sk, D) -> (B, H, Sq, D) in q's dtype,
scale 1/sqrt(D). When causal, query i sees the keys j <= i: the mask is
aligned at the top left, as the Pallas kernel aligns it (the reference's
jnp oracle `ref.flash_attention_ref` aligns it at the bottom right, which
agrees only when Sq == Sk). k and v carry q's head count; a model with
grouped kv heads repeats them before the call.

`flash_attention` launches the CUDA kernels (`csrc/flash_attention.cu`)
on CUDA tensors, both on the tensor cores with wgmma: float32 as three
TF32 products (each operand split into a TF32 hi part and an fp32 lo
rest, hi*hi + hi*lo + lo*hi, about fp32's precision), bfloat16 with P
split into bfloat16 hi and lo parts for the P V product. It runs the
plain PyTorch version `flash_attention_ref` on CPU tensors; anything else
raises. `flash_attention.launches` counts kernel launches.

Limits of the CUDA kernels, narrower than the Pallas kernel's (which
takes any dtype and head dim): q, k and v must be float32 or bfloat16,
the head dim D at most 128 (`MAX_HEAD_DIM`; the kernels pad D to 64 or
128), and B * H at most 65,535. Anything else (float16, D 192, ...)
raises ValueError on CUDA tensors; the plain version on CPU tensors has
no such limit. Nothing in either package calls this outside the tests
and the kernel entry point, so the limits stay until a caller needs more.

`F32_TILES` and `f32_smem_bytes` mirror the float32 kernel's tile sizes
and shared memory (a CPU test holds them against the .cu constants and
the card's 227 KB limit).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128                 # csrc/flash_attention.cu pads D to 128
DTYPES = (torch.float32, torch.bfloat16)

# the float32 kernel: kF32BQ q rows a CTA (two warpgroups of 64), and per
# padded head dim DP its keys per kv tile, raw K/V stages and V^T work
# buffers (kF32BK64 / kF32Raw64 / kF32Vt64, and the same for 128)
F32_BQ = 128
F32_TILES = {64: (64, 2, 2), 128: (32, 1, 1)}
F32_BARRIER_BYTES = 64     # kF32Bars


def f32_smem_bytes(dp: int) -> int:
    """Dynamic shared memory of the float32 kernel at padded head dim
    `dp`: Q hi and lo, the K tile and each V^T buffer hi and lo, the raw
    K/V ring, the mbarriers, and 1024 bytes to align the swizzled tiles."""
    bk, stages, vt = F32_TILES[dp]
    return (2 * F32_BQ * dp * 4 + (2 + 2 * vt) * bk * dp * 4
            + stages * 2 * bk * dp * 4 + F32_BARRIER_BYTES + 1024)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain version of the Pallas kernel's function: scores in float32,
    masked from the top left, softmax, then P V; cast to q's dtype."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / (q.shape[-1] ** 0.5))
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v. On CUDA tensors: float32 or bfloat16
    only, head dim D <= 128, B * H <= 65,535 (ValueError otherwise)."""
    if _build.all_on_cpu("flash_attention", q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)
    _build.require(q.dim() == 4, "flash_attention: q must be (B, H, S, D)")
    B, H, Sq, D = q.shape
    _build.require(q.dtype in DTYPES, "flash_attention: expected float32 "
                   "or bfloat16, got {}", q.dtype)
    _build.require(0 < D <= MAX_HEAD_DIM,
                   "flash_attention: head dim {} outside [1, {}]", D,
                   MAX_HEAD_DIM)
    _build.require(k.dim() == 4 and k.shape[2] > 0,
                   "flash_attention: k must be (B, H, Sk, D), Sk > 0")
    Sk = k.shape[2]
    _build.require(B * H <= 65535, "flash_attention: B*H = {} > 65535",
                   B * H)
    _build.require_cuda("flash_attention q", q, q.dtype)
    _build.require_cuda("flash_attention k", k, q.dtype, (B, H, Sk, D))
    _build.require_cuda("flash_attention v", v, q.dtype, (B, H, Sk, D))
    _build.require(k.device == q.device and v.device == q.device,
                   "flash_attention: q, k, v on different devices")
    o = torch.empty_like(q)
    fn = _build.entry("flash_attention_launch",
                      (_build.P, _build.P, _build.P, _build.P, _build.I32,
                       _build.I32, _build.I32, _build.I32, _build.F32,
                       _build.I32, _build.I32, _build.P))
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H,
              Sq, Sk, D, 1.0 / (D ** 0.5), int(causal),
              int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
