"""Kernels over a bitmap-encoded (rows, cols) matrix. The port of
`repro/kernels/bitmap_decode.py`:

  * `bitmap_gather`: random access, the matrix's values at linear
    indices (0 at zeros), and `bitmap_gather_bwd`, its gradient with
    respect to the packed values;
  * `bitmap_matmul`: y = W @ x for a dense x (cols, n), W decoded on the
    fly and never expanded to dense.

Each launches its CUDA kernel (`csrc/bitmap_gather.cu`,
`csrc/bitmap_matmul.cu`) on CUDA tensors and runs its plain PyTorch
version (`bitmap_gather_ref`, `bitmap_gather_bwd_ref`,
`bitmap_matmul_ref`) on CPU tensors;
anything else raises. `<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.sparse import bitmap_rank, popcount32
from repro_torch.kernels import _build


def bitmap_slots(words: torch.Tensor, rowptr: torch.Tensor, nvalues: int,
                 queries: torch.Tensor, cols: int,
                 rank: Optional[torch.Tensor] = None) -> tuple:
    """(slot, set) of each query: the int64 address of its packed value,
    rank[r, wi] + popcount(word & below), clamped to [0, nvalues), and
    whether its bit is set. Without `rank` the table is derived from
    (words, rowptr) first: the same address as the reference's masked
    popcount over the row."""
    if rank is None:
        rank = bitmap_rank(words, rowptr)
    rows, nwords = words.shape
    q = queries.to(torch.int64)
    r = torch.div(q, cols, rounding_mode="floor")
    c = q - r * cols
    r = r.clamp(0, rows - 1)
    wi = torch.div(c, 32, rounding_mode="floor").clamp(0, nwords - 1)
    bi = c % 32
    w = words[r, wi].to(torch.int64) & 0xFFFFFFFF
    below = (torch.ones_like(bi) << bi) - 1
    addr = rank[r, wi].to(torch.int64) + popcount32(w & below)
    return addr.clamp(0, nvalues - 1), ((w >> bi) & 1) > 0


def bitmap_gather_ref(words: torch.Tensor, rowptr: torch.Tensor,
                      values: torch.Tensor, queries: torch.Tensor, cols: int,
                      rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version. queries are linear row-major indices; a query whose
    bit is set reads its slot (`bitmap_slots`), any other reads 0."""
    slot, bit = bitmap_slots(words, rowptr, values.shape[0], queries, cols,
                             rank)
    vals = values[slot]
    return torch.where(bit, vals, torch.zeros_like(vals))


def bitmap_gather_bwd_ref(words: torch.Tensor, rowptr: torch.Tensor,
                          queries: torch.Tensor, grad: torch.Tensor,
                          nvalues: int, cols: int,
                          rank: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of the backward: the gradient of `bitmap_gather`
    with respect to its `nvalues` packed values, given the gradient
    `grad` of its output. Each query whose bit is set adds its gradient
    to the slot it reads; pad slots and queries on zeros add nothing."""
    slot, bit = bitmap_slots(words, rowptr, nvalues, queries, cols, rank)
    out = torch.zeros(nvalues, dtype=grad.dtype, device=grad.device)
    # a query on a zero adds an exact 0 (no boolean mask: no host sync)
    return out.index_add_(0, slot, torch.where(bit, grad,
                                               torch.zeros_like(grad)))


def bitmap_gather(words: torch.Tensor, rowptr: torch.Tensor,
                  values: torch.Tensor, queries: torch.Tensor, *, cols: int,
                  rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """values of the encoded matrix at int32 linear `queries` (0 at zeros).
    `words` holds the uint32 bitmap as int32 bit patterns; `rank` is the
    optional (rows, words) int32 table of `core.sparse.bitmap_rank`."""
    if queries.device.type == "cpu":
        return bitmap_gather_ref(words, rowptr, values, queries, cols,
                                 rank=rank)
    _build.require(words.dim() == 2, "bitmap_gather: words must be 2-D")
    rows, nwords = words.shape
    _build.require(rows > 0 and nwords == (cols + 31) // 32,
                   f"bitmap_gather: words {tuple(words.shape)} do not fit "
                   f"{cols} columns")
    _build.require(values.dim() == 1 and values.shape[0] > 0,
                   "bitmap_gather: values must be a non-empty vector")
    _build.require_cuda("bitmap_gather words", words, torch.int32)
    _build.require_cuda("bitmap_gather rowptr", rowptr, torch.int32, (rows,))
    if rank is not None:
        _build.require_cuda("bitmap_gather rank", rank, torch.int32,
                            (rows, nwords))
    _build.require_cuda("bitmap_gather values", values, torch.float32)
    _build.require_cuda("bitmap_gather queries", queries, torch.int32)
    _build.require(queries.dim() == 1, "bitmap_gather: queries must be 1-D")
    out = torch.empty(queries.shape, dtype=torch.float32,
                      device=queries.device)
    fn = _build.entry("bitmap_gather_launch",
                      (_build.P, _build.P, _build.P, _build.P, _build.I32,
                       _build.I32, _build.I32, _build.I32, _build.P,
                       _build.P, _build.I64, _build.P))
    code = fn(words.data_ptr(), rowptr.data_ptr(),
              None if rank is None else rank.data_ptr(), values.data_ptr(),
              values.shape[0], rows, nwords, cols, queries.data_ptr(),
              out.data_ptr(), queries.shape[0],
              _build.stream_ptr(queries.device))
    _build.check("bitmap_gather", code)
    bitmap_gather.launches += 1
    return out


bitmap_gather.launches = 0


def bitmap_gather_bwd(words: torch.Tensor, rowptr: torch.Tensor,
                      queries: torch.Tensor, grad: torch.Tensor, *,
                      nvalues: int, cols: int,
                      rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gradient of `bitmap_gather` with respect to its values: a
    float32 vector of `nvalues` with grad[i] added at the slot query i
    reads, for each query whose bit is set (`csrc/bitmap_gather.cu`
    `bitmap_gather_bwd_kernel`: runs of equal queries summed in the warp,
    one fp32 atomic a run, so the sum's order changes from run to run).
    Plain version `bitmap_gather_bwd_ref` on CPU tensors."""
    tensors = (words, rowptr, queries, grad)
    if _build.all_on_cpu("bitmap_gather_bwd", *tensors):
        return bitmap_gather_bwd_ref(words, rowptr, queries, grad, nvalues,
                                     cols, rank=rank)
    _build.require(words.dim() == 2, "bitmap_gather_bwd: words must be 2-D")
    rows, nwords = words.shape
    _build.require(rows > 0 and nwords == (cols + 31) // 32,
                   f"bitmap_gather_bwd: words {tuple(words.shape)} do not "
                   f"fit {cols} columns")
    _build.require(nvalues > 0, "bitmap_gather_bwd: no values")
    _build.require_cuda("bitmap_gather_bwd words", words, torch.int32)
    _build.require_cuda("bitmap_gather_bwd rowptr", rowptr, torch.int32,
                        (rows,))
    if rank is not None:
        _build.require_cuda("bitmap_gather_bwd rank", rank, torch.int32,
                            (rows, nwords))
    _build.require(queries.dim() == 1,
                   "bitmap_gather_bwd: queries must be 1-D")
    _build.require_cuda("bitmap_gather_bwd queries", queries, torch.int32)
    _build.require_cuda("bitmap_gather_bwd grad", grad, torch.float32,
                        tuple(queries.shape))
    dev = queries.device
    _build.require(all(t.device == dev for t in tensors),
                   "bitmap_gather_bwd: tensors on different devices")
    out = torch.zeros(nvalues, dtype=torch.float32, device=dev)
    fn = _build.entry("bitmap_gather_bwd_launch",
                      (_build.P, _build.P, _build.P, _build.I32, _build.I32,
                       _build.I32, _build.I32, _build.P, _build.P, _build.P,
                       _build.I64, _build.I32, _build.P))
    code = fn(words.data_ptr(), rowptr.data_ptr(),
              None if rank is None else rank.data_ptr(), nvalues, rows,
              nwords, cols, queries.data_ptr(), grad.data_ptr(),
              out.data_ptr(), queries.shape[0],
              _build.aligned16(queries, grad), _build.stream_ptr(dev))
    _build.check("bitmap_gather_bwd", code)
    bitmap_gather_bwd.launches += 1
    return out


bitmap_gather_bwd.launches = 0


MATMUL_DTYPES = (torch.float32, torch.float16)
MATMUL_THREADS = 256          # csrc/bitmap_matmul.cu kThreads
MAX_SEGMENTS = 8              # CTAs a row: the portable cluster size
# the kernel's static shared memory, which the plan leaves room for: the
# set-bit list of kChunkWords (= MATMUL_THREADS) words as uint16 column
# offsets, plus scan and reduction scratch
MATMUL_STATIC_SMEM_BYTES = MATMUL_THREADS * 32 * 2 + 512


class MatmulPlan(NamedTuple):
    segments: int      # CTAs per row (one cluster), 1 to MAX_SEGMENTS
    seg_words: int     # bitmap words per segment; none is empty
    smem_bytes: int    # dynamic shared memory a CTA: its partial y row,
                       # and in rank 0 every CTA's (segments + 1 rows)


def matmul_plan(rows: int, nwords: int, n: int, sms: int) -> MatmulPlan:
    """Split each row's `nwords` words into S segments, one CTA each, so
    that rows * S CTAs fill the card's `sms` SMs about twice (S a power of
    two, at most MAX_SEGMENTS, no empty segment), and fewer where S + 1
    partial rows of n floats would not fit a CTA's shared memory. Raises
    ValueError when two do not fit (S = 1)."""
    _build.require(rows >= 0 and nwords >= 0 and n >= 0 and sms >= 1,
                   "bitmap_matmul: rows {}, words {}, n {}, sms {}", rows,
                   nwords, n, sms)
    want = -(-2 * sms // max(rows, 1))
    s = 1
    while s < min(want, MAX_SEGMENTS):
        s *= 2
    s = max(1, min(s, nwords))
    room = _build.MAX_SMEM_BYTES - MATMUL_STATIC_SMEM_BYTES
    while s > 1 and 4 * n * (s + 1) > room:
        s //= 2
    _build.require(8 * n <= room,
                   "bitmap_matmul: x has {} columns; two partial rows and "
                   "the set-bit list need {} bytes of shared memory, above "
                   "the limit of {} bytes a block may use", n,
                   8 * n + MATMUL_STATIC_SMEM_BYTES, _build.MAX_SMEM_BYTES)
    seg = -(-nwords // s)
    if seg:
        s = -(-nwords // seg)
    return MatmulPlan(s, seg, 4 * n * (s + 1))


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bitmap_matmul_ref(words: torch.Tensor, rowptr: torch.Tensor,
                      values: torch.Tensor, x: torch.Tensor,
                      cols: int) -> torch.Tensor:
    """Plain version of the reference's `ref.bitmap_decode_matmul_ref`:
    decode W (rows, cols) densely, cast it to x's dtype, multiply in
    float32 and return y (rows, n) in x's dtype."""
    rows = words.shape[0]
    q = torch.arange(rows * cols, dtype=torch.int32, device=words.device)
    w = bitmap_gather_ref(words, rowptr, values, q, cols)
    w = w.reshape(rows, cols).to(x.dtype).to(torch.float32)
    return (w @ x.to(torch.float32)).to(x.dtype)


def bitmap_matmul(words: torch.Tensor, rowptr: torch.Tensor,
                  values: torch.Tensor, x: torch.Tensor, *,
                  cols: int) -> torch.Tensor:
    """y = decode(words, rowptr, values) @ x, x (cols, n) float32 or
    float16, values float32 or float16; y in x's dtype. `words` holds the
    uint32 bitmap as int32 bit patterns. The kernel splits each row into
    segments (`matmul_plan`) and finds a segment's first value by a
    popcount of the words before it, so it needs no rank table."""
    tensors = (words, rowptr, values, x)
    if _build.all_on_cpu("bitmap_matmul", *tensors):
        return bitmap_matmul_ref(words, rowptr, values, x, cols)
    _build.require(words.dim() == 2, "bitmap_matmul: words must be 2-D")
    rows, nwords = words.shape
    _build.require(nwords == (cols + 31) // 32,
                   f"bitmap_matmul: words {tuple(words.shape)} do not fit "
                   f"{cols} columns")
    _build.require(values.dim() == 1 and values.shape[0] > 0,
                   "bitmap_matmul: values must be a non-empty vector")
    _build.require(x.dim() == 2 and x.shape[0] == cols,
                   f"bitmap_matmul: x must be ({cols}, n), got "
                   f"{tuple(x.shape)}")
    _build.require(values.dtype in MATMUL_DTYPES and x.dtype in MATMUL_DTYPES,
                   f"bitmap_matmul: values and x must be float32 or float16, "
                   f"got {values.dtype} and {x.dtype}")
    _build.require_cuda("bitmap_matmul words", words, torch.int32)
    _build.require_cuda("bitmap_matmul rowptr", rowptr, torch.int32, (rows,))
    _build.require_cuda("bitmap_matmul values", values, values.dtype)
    _build.require_cuda("bitmap_matmul x", x, x.dtype)
    dev = x.device
    _build.require(all(t.device == dev for t in tensors),
                   "bitmap_matmul: tensors on different devices")
    n = x.shape[1]
    plan = matmul_plan(rows, nwords, n, sm_count(dev))
    # 16-byte loads of x's 8-column tiles need whole tiles and an aligned
    # pointer; otherwise the kernel loads x one value at a time
    vec = int(n % 8 == 0 and x.data_ptr() % 16 == 0)
    y = torch.empty((rows, n), dtype=x.dtype, device=dev)
    fn = _build.entry("bitmap_matmul_launch",
                      (_build.P, _build.P, _build.P, _build.I32, _build.I32,
                       _build.I32, _build.I32, _build.I32, _build.I32,
                       _build.I32, _build.I32, _build.P, _build.I32,
                       _build.I32, _build.I32, _build.P, _build.P))
    code = fn(words.data_ptr(), rowptr.data_ptr(), values.data_ptr(),
              values.shape[0], int(values.dtype == torch.float16), rows,
              nwords, cols, plan.segments, plan.seg_words, plan.smem_bytes,
              x.data_ptr(),
              int(x.dtype == torch.float16), n, vec, y.data_ptr(),
              _build.stream_ptr(dev))
    _build.check("bitmap_matmul", code)
    bitmap_matmul.launches += 1
    return y


bitmap_matmul.launches = 0
