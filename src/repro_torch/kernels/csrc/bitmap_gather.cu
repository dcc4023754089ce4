// Bitmap gather: values of a bitmap-encoded (rows, cols) matrix at linear
// query indices, 0 where the bit is clear.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_decode.py
// `bitmap_gather` (Pallas body `_gather_kernel`): split each query into
// row and column, test the bit, and address the packed value as
// rowptr[row] + a masked popcount over the row's words.
//
// Bound on Hopper: memory. Each query reads 4 bytes and writes 4; the
// encoded stream of one factor slice (words, rank, values: under 2 MB at
// full width) stays in L2. The reference's masked popcount over the whole
// row would cost a row's worth of words per query (800 at grid 160, for
// each of 4.2M queries per occupancy chunk), making it compute- and
// L2-bound instead.
//
// Design: one thread per query. With the per-word rank table the address
// is rank[r, wi] + popc(word & below): one rank read and one popcount.
// Without it the thread popcounts the row's words below wi, the
// reference's form. Both give the same address, so the result is
// bit-exact against the plain version either way. Row and word indices
// are clamped as the reference's gathers clamp them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bitmap_gather_kernel(const uint32_t* __restrict__ words,
                                     const int* __restrict__ rowptr,
                                     const int* __restrict__ rank,
                                     const float* __restrict__ values,
                                     int nvalues, int rows, int nwords,
                                     int cols, const int* __restrict__ queries,
                                     float* __restrict__ out, long long nq) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int q = queries[i];
  const int r = min(max(q / cols, 0), rows - 1);
  const int c = q - (q / cols) * cols;
  const int wi = min(max(c >> 5, 0), nwords - 1);
  const unsigned bi = static_cast<unsigned>(c) & 31u;
  const long long row_off = static_cast<long long>(r) * nwords;
  const uint32_t w = __ldg(words + row_off + wi);
  const uint32_t below = (1u << bi) - 1u;
  int addr;
  if (rank != nullptr) {
    addr = __ldg(rank + row_off + wi) + __popc(w & below);
  } else {
    int prefix = 0;
    for (int k = 0; k < wi; ++k) prefix += __popc(__ldg(words + row_off + k));
    addr = __ldg(rowptr + r) + prefix + __popc(w & below);
  }
  addr = min(max(addr, 0), nvalues - 1);
  out[i] = ((w >> bi) & 1u) ? __ldg(values + addr) : 0.0f;
}

}  // namespace

extern "C" int bitmap_gather_launch(const void* words, const void* rowptr,
                                    const void* rank, const void* values,
                                    int nvalues, int rows, int nwords,
                                    int cols, const void* queries, void* out,
                                    long long nq, void* stream) {
  if (nq > 0) {
    const int threads = 256;
    const long long blocks = (nq + threads - 1) / threads;
    bitmap_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int*>(rowptr),
        static_cast<const int*>(rank), static_cast<const float*>(values),
        nvalues, rows, nwords, cols, static_cast<const int*>(queries),
        static_cast<float*>(out), nq);
  }
  return static_cast<int>(cudaGetLastError());
}
