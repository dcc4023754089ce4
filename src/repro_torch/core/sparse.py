"""Hybrid sparse encoding (paper H1, Sec. 4.2.2): the codec of the
reference's `repro.core.sparse`, in PyTorch.

Formats:
  dense   raw (R, ncols) matrix.
  bitmap  1 bit per element + packed non-zeros + row pointers, with a
          per-word rank table so one lookup is one rank read plus the
          popcount of one masked word.
  coo     sorted linear coordinates (int32, padded with PAD_COORD) +
          values, looked up by binary search.

Streams are the reference's, stream for stream. One representation
choice differs: bitmap words are held as int32 tensors carrying the
uint32 bit patterns, because PyTorch on the CPU does not shift uint32
tensors. `field_state`/`field_from_state` convert at the boundary.

Encoding runs on the host in numpy (it is an offline step); decoding and
lookups are tensor code on the streams' device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PAD_COORD = int(np.iinfo(np.int32).max)
FACTOR_KEYS = ("sigma_planes", "sigma_lines", "app_planes", "app_lines")
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(eq=False)
class BitmapEncoded:
    shape: tuple
    words: torch.Tensor     # (rows, ceil(cols/32)) int32 bit patterns
    rowptr: torch.Tensor    # (rows,) int32: start of each row in `values`
    values: torch.Tensor    # (nnz_pad,) packed non-zeros
    nnz: int
    # rank[r, w] = packed index of word w's first non-zero in row r
    # (rowptr folded in); derived from words/rowptr, never serialized
    rank: Optional[torch.Tensor] = None

    def to(self, device: DeviceLike) -> "BitmapEncoded":
        return BitmapEncoded(
            self.shape, self.words.to(device), self.rowptr.to(device),
            self.values.to(device), self.nnz,
            rank=None if self.rank is None else self.rank.to(device))


@dataclasses.dataclass(eq=False)
class CooEncoded:
    shape: tuple
    coords: torch.Tensor    # (nnz_pad,) int32 sorted linear indices
    values: torch.Tensor    # (nnz_pad,)
    nnz: int

    def to(self, device: DeviceLike) -> "CooEncoded":
        return CooEncoded(self.shape, self.coords.to(device),
                          self.values.to(device), self.nnz)


def _host(w) -> np.ndarray:
    """An array or tensor (on any device) as a host numpy array."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def sparsity(w) -> float:
    return float((_host(w) == 0).mean())


def choose_format(s: float, threshold: float = 0.80) -> str:
    """The paper's rule: bitmap below the threshold, COO at/above it."""
    return "coo" if s >= threshold else "bitmap"


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit pattern of `x` (any integer dtype), as
    int32: a SWAR popcount in int64, since PyTorch has no popcount op."""
    v = x.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = (v * 0x01010101) & _MASK32
    return (v >> 24).to(torch.int32)


def bitmap_rank(words: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """Per-word rank table: rank[r, w] = rowptr[r] + popcount(words[r, :w])."""
    pc = popcount32(words)
    prefix = torch.cumsum(pc, dim=1, dtype=torch.int32) - pc
    return rowptr.to(torch.int32)[:, None] + prefix


def _pad_len(nnz: int, pad_to: Optional[int]) -> int:
    return pad_to if pad_to is not None else ((nnz + 127) // 128) * 128 or 128


def encode_bitmap(w, pad_to: Optional[int] = None, *,
                  device: DeviceLike = None) -> BitmapEncoded:
    """Bitmap-encode a (rows, cols) matrix (host numpy, then tensors on
    `device`; None: the card)."""
    device = resolve_device(device)
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"bitmap codec takes matrices, got shape {w.shape}")
    rows, cols = w.shape
    nz = w != 0
    wc = ((cols + 31) // 32) * 32
    bits = np.zeros((rows, wc), np.uint32)
    bits[:, :cols] = nz
    words = np.zeros((rows, wc // 32), np.uint32)
    for b in range(32):
        words |= bits[:, b::32] << np.uint32(b)
    counts = nz.sum(axis=1)
    rowptr = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    vals = w[nz].astype(w.dtype)
    nnz = int(vals.size)
    values = np.zeros((_pad_len(nnz, pad_to),), w.dtype)
    values[:nnz] = vals
    tw = torch.from_numpy(words.view(np.int32)).to(device)
    tr = torch.from_numpy(rowptr).to(device)
    return BitmapEncoded((rows, cols), tw, tr,
                         torch.from_numpy(values).to(device), nnz,
                         rank=bitmap_rank(tw, tr))


def encode_coo(w, pad_to: Optional[int] = None, *,
               device: DeviceLike = None) -> CooEncoded:
    """COO-encode an array: sorted int32 linear coordinates + values, on
    `device` (None: the card)."""
    device = resolve_device(device)
    w = np.asarray(w)
    flat = w.reshape(-1)
    idx = np.nonzero(flat)[0].astype(np.int32)
    nnz = int(idx.size)
    pad = _pad_len(nnz, pad_to)
    coords = np.full((pad,), PAD_COORD, np.int32)
    coords[:nnz] = idx
    values = np.zeros((pad,), w.dtype)
    values[:nnz] = flat[idx]
    return CooEncoded(w.shape, torch.from_numpy(coords).to(device),
                      torch.from_numpy(values).to(device), nnz)


def decode_bitmap(enc: BitmapEncoded) -> torch.Tensor:
    """Reconstruct the dense (rows, cols) matrix; differentiable in
    `enc.values` (`CompressedField.tv` decodes through it)."""
    rows, cols = enc.shape
    words = enc.words.to(torch.int64) & _MASK32
    bpos = torch.arange(cols, device=words.device)
    bits = ((words[:, bpos // 32] >> (bpos % 32)) & 1).to(torch.int32)
    pos = torch.cumsum(bits, dim=1, dtype=torch.int32) - bits
    addr = enc.rowptr.to(torch.int64)[:, None] + pos
    vals = enc.values[addr.clamp(0, enc.values.shape[0] - 1)]
    return torch.where(bits > 0, vals, torch.zeros_like(vals))


def decode_coo(enc: CooEncoded) -> torch.Tensor:
    """Reconstruct the dense array; differentiable in `enc.values`, pad
    entries getting a zero gradient."""
    n = int(np.prod(enc.shape))
    flat = torch.zeros((n,), dtype=enc.values.dtype, device=enc.values.device)
    ok = enc.coords != PAD_COORD
    safe = torch.where(ok, enc.coords, torch.zeros_like(enc.coords))
    flat.index_add_(0, safe.to(torch.int64),
                    torch.where(ok, enc.values, torch.zeros_like(enc.values)))
    return flat.reshape(enc.shape)


def storage_bytes(shape, nnz: int, fmt: str, elem_bytes: int = 4) -> int:
    """Size model behind the 80% threshold (paper Sec. 4.2.2)."""
    total = int(np.prod(shape))
    rows = shape[0] if len(shape) == 2 else 1
    if fmt == "dense":
        return total * elem_bytes
    if fmt == "bitmap":
        return total // 8 + rows * 4 + nnz * elem_bytes
    if fmt == "coo":
        return nnz * (4 + elem_bytes)
    raise ValueError(fmt)


def bitmap_lookup_linear(words: torch.Tensor, rowptr: torch.Tensor,
                         values: torch.Tensor, queries: torch.Tensor,
                         cols: int, rank: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Random access into a bitmap-encoded (rows, cols) matrix given as raw
    streams: the values at linear row-major `queries`, 0 where the bit is
    clear. One bit test plus the popcount of one masked word on top of the
    rank table, which is derived from (words, rowptr) when `rank` is None.
    The decode math is the plain gather's
    (`kernels.bitmap_decode.bitmap_gather_ref`), on any device."""
    from repro_torch.kernels import bitmap_decode   # it imports this module
    return bitmap_decode.bitmap_gather_ref(words, rowptr, values, queries,
                                           cols, rank=rank)


def bitmap_lookup(enc: BitmapEncoded, queries: torch.Tensor) -> torch.Tensor:
    """`bitmap_lookup_linear` over an encoded container."""
    return bitmap_lookup_linear(enc.words, enc.rowptr, enc.values, queries,
                                enc.shape[1], rank=enc.rank)


def coo_lookup(enc: CooEncoded, queries: torch.Tensor) -> torch.Tensor:
    """The values of a COO-encoded array at linear `queries` (0 where no
    coordinate matches): a lower-bound search over the sorted coordinates,
    the plain gather's (`kernels.coo_gather.coo_gather_ref`)."""
    from repro_torch.kernels import coo_gather
    return coo_gather.coo_gather_ref(enc.coords, enc.values, queries)


def encode_hybrid(w, threshold: float = 0.80, *, device: DeviceLike = None):
    """The full H1 codec: measure sparsity, pick the format by the 80%
    rule, encode. Returns (format, sparsity, encoded streams on `device`;
    None: the card)."""
    w = _host(w)
    s = sparsity(w)
    fmt = choose_format(s, threshold)
    enc = (encode_coo(w, device=device) if fmt == "coo"
           else encode_bitmap(np.atleast_2d(w), device=device))
    return fmt, s, enc


@dataclasses.dataclass(eq=False)
class EncodedFactor:
    """One VM factor slice (mode m of a plane/line tensor) in its chosen
    format. The matrix view is (R, ncols): ncols = G*G for planes, G for
    lines; `nd_shape` is the original (R, G[, G]) layout."""
    fmt: str                                   # "dense" | "bitmap" | "coo"
    nd_shape: tuple
    shape: tuple                               # (R, ncols)
    nnz: int
    sparsity: float
    dense: Optional[torch.Tensor] = None       # fmt == "dense"
    bitmap: Optional[BitmapEncoded] = None     # fmt == "bitmap"
    coo: Optional[CooEncoded] = None           # fmt == "coo"

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def value_array(self) -> torch.Tensor:
        """The float payload: packed non-zeros, or the dense matrix."""
        if self.fmt == "dense":
            return self.dense
        if self.fmt == "bitmap":
            return self.bitmap.values
        return self.coo.values

    def with_value_array(self, v: torch.Tensor) -> "EncodedFactor":
        """The same structure with a new float payload (an optimizer
        step). The streams, and the bitmap's rank table, are kept: the
        values change, the support does not."""
        if self.fmt == "dense":
            return dataclasses.replace(self, dense=v)
        if self.fmt == "bitmap":
            return dataclasses.replace(
                self, bitmap=dataclasses.replace(self.bitmap, values=v))
        return dataclasses.replace(
            self, coo=dataclasses.replace(self.coo, values=v))

    def storage(self) -> int:
        return storage_bytes(self.shape, self.nnz, self.fmt)

    def dense_storage(self) -> int:
        return storage_bytes(self.shape, self.nnz, "dense")

    def decode(self) -> torch.Tensor:
        """The dense (R, ncols) matrix."""
        if self.fmt == "dense":
            return self.dense
        if self.fmt == "bitmap":
            return decode_bitmap(self.bitmap)
        return decode_coo(self.coo)

    def to(self, device: DeviceLike) -> "EncodedFactor":
        return dataclasses.replace(
            self,
            dense=None if self.dense is None else self.dense.to(device),
            bitmap=None if self.bitmap is None else self.bitmap.to(device),
            coo=None if self.coo is None else self.coo.to(device))


def encode_factor(wm, threshold: float = 0.80, *,
                  device: DeviceLike = None) -> EncodedFactor:
    """Encode one (R, ncols) factor matrix per the 80% rule. A factor whose
    encoded form would not beat its dense bytes stays dense; otherwise
    bitmap below the sparsity threshold, COO at/above it. The streams
    go to `device` (None: the card)."""
    device = resolve_device(device)
    wm = _host(wm)
    s = sparsity(wm)
    nnz = int((wm != 0).sum())
    fmt = choose_format(s, threshold)
    if storage_bytes(wm.shape, nnz, fmt) >= \
            storage_bytes(wm.shape, nnz, "dense"):
        fmt = "dense"
    ef = EncodedFactor(fmt=fmt, nd_shape=wm.shape, shape=wm.shape,
                       nnz=nnz, sparsity=s)
    if fmt == "dense":
        ef.dense = torch.from_numpy(np.ascontiguousarray(wm)).to(device)
    elif fmt == "bitmap":
        ef.bitmap = encode_bitmap(wm, device=device)
    else:
        ef.coo = encode_coo(wm, device=device)
    return ef


def factor_report(params) -> dict:
    """Per-factor encoding decision and storage of a TensoRF field's
    parameters (tensors on any device, or arrays): for each `"{key}[{m}]"`
    slice, its sparsity, the format the 80% rule picks, and its bytes
    dense, as bitmap, as COO and in the chosen format."""
    out = {}
    for k in FACTOR_KEYS:
        w = _host(params[k])
        for m in range(3):
            wm = w[m].reshape(w.shape[1], -1)
            s = sparsity(wm)
            fmt = choose_format(s)
            nnz = int((wm != 0).sum())
            out[f"{k}[{m}]"] = {
                "sparsity": s,
                "format": fmt,
                "dense_bytes": storage_bytes(wm.shape, nnz, "dense"),
                "bitmap_bytes": storage_bytes(wm.shape, nnz, "bitmap"),
                "coo_bytes": storage_bytes(wm.shape, nnz, "coo"),
                "chosen_bytes": storage_bytes(wm.shape, nnz, fmt),
            }
    return out
