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
//
// The backward (`bitmap_gather_bwd_kernel`) is the gradient of the same
// function with respect to the values: the reference takes it by
// differentiating its jnp oracle (src/repro/kernels/ref.py
// `bitmap_gather_ref`), a scatter-add into the value slots. Bound by
// memory: the incoming gradient (4 bytes a query), the queries of nonzero
// gradient (4 bytes each) and the values' read-modify-write in L2. One
// thread a query with one atomic each ran at 2.5x that bound, and timing
// its parts showed the slot computations and the scalar reads of the
// gradient, not the atomics, holding it. So a CTA takes a tile of
// consecutive queries, reads the gradient as 16-byte vectors and the
// queries only where a gradient is not 0, merges runs of equal queries in
// the warp, and computes the slot once a run, with one atomic a run
// (gather_bwd.cuh).
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_bwd.cuh"

namespace {

constexpr int kBwdPer = 8;                   // backward queries a thread
constexpr int kBwdTile = kBwdThreads * kBwdPer;
// a warp's list of runs: one row's most, flushed a run a lane a step
// (a list of both rows, or two runs a lane, took more shared memory or
// registers, and the shuffled call's slot reads were slower)
constexpr int kBwdList = kBwdDirect;

// The value slot query q reads: sets *addr and returns whether q's bit is
// set. Row and word indices are clamped as the reference's gathers clamp
// them, and so is the address.
__device__ __forceinline__ bool bitmap_slot(const uint32_t* __restrict__ words,
                                            const int* __restrict__ rowptr,
                                            const int* __restrict__ rank,
                                            int nvalues, int rows, int nwords,
                                            int cols, int q, int* addr) {
  const int r = min(max(q / cols, 0), rows - 1);
  const int c = q - (q / cols) * cols;
  const int wi = min(max(c >> 5, 0), nwords - 1);
  const unsigned bi = static_cast<unsigned>(c) & 31u;
  const long long row_off = static_cast<long long>(r) * nwords;
  const uint32_t w = __ldg(words + row_off + wi);
  const uint32_t below = (1u << bi) - 1u;
  int a;
  if (rank != nullptr) {
    a = __ldg(rank + row_off + wi) + __popc(w & below);
  } else {
    int prefix = 0;
    for (int k = 0; k < wi; ++k) prefix += __popc(__ldg(words + row_off + k));
    a = __ldg(rowptr + r) + prefix + __popc(w & below);
  }
  *addr = min(max(a, 0), nvalues - 1);
  return (w >> bi) & 1u;
}

__global__ void bitmap_gather_kernel(const uint32_t* __restrict__ words,
                                     const int* __restrict__ rowptr,
                                     const int* __restrict__ rank,
                                     const float* __restrict__ values,
                                     int nvalues, int rows, int nwords,
                                     int cols, const int* __restrict__ queries,
                                     float* __restrict__ out, long long nq) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  int addr;
  const bool set = bitmap_slot(words, rowptr, rank, nvalues, rows, nwords,
                               cols, queries[i], &addr);
  out[i] = set ? __ldg(values + addr) : 0.0f;
}

// The gradient of the gather with respect to the packed values:
// dvalues[slot(q_i)] += grad[i] for each query whose bit is set, slot
// being the address the forward reads (`bitmap_slot`, clamps included).
// A tile of kBwdTile queries a CTA; each run of equal queries in a warp's
// row is summed first, then its slot computed once and its sum added by
// one fp32 atomic (gather_bwd.cuh). A zero gradient adds nothing and its
// query is not read, a slot no query reads stays 0, and a run on a clear
// bit adds nothing. The sum's order, and its last bits, change from run
// to run.
__global__ void __launch_bounds__(kBwdThreads)
bitmap_gather_bwd_kernel(const uint32_t* __restrict__ words,
                         const int* __restrict__ rowptr,
                         const int* __restrict__ rank, int nvalues, int rows,
                         int nwords, int cols,
                         const int* __restrict__ queries,
                         const float* __restrict__ grad,
                         float* __restrict__ dvalues, long long nq,
                         int vec) {
  __shared__ BwdRuns<kBwdList> runs;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kBwdTile;
  int q[kBwdPer];
  float g[kBwdPer];
  const bool vector = vec && tile0 + kBwdTile <= nq;
  bwd_load_grad(grad, tile0, nq, vector, g);
  bwd_load_queries(queries, tile0, vector, g, q);
  bwd_merge_flush<1>(q, g, runs, [&](const int (&key)[1],
                                     const float (&sum)[1], unsigned) {
    int addr;
    if (bitmap_slot(words, rowptr, rank, nvalues, rows, nwords, cols,
                    key[0], &addr))
      atomicAdd(dvalues + addr, sum[0]);
  });
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

// dvalues: nvalues floats, zeroed by the caller; the kernel adds into it.
// vec: 1 where queries and grad are 16-byte aligned.
extern "C" int bitmap_gather_bwd_launch(const void* words, const void* rowptr,
                                        const void* rank, int nvalues,
                                        int rows, int nwords, int cols,
                                        const void* queries, const void* grad,
                                        void* dvalues, long long nq, int vec,
                                        void* stream) {
  const long long blocks = (nq + kBwdTile - 1) / kBwdTile;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0)
    bitmap_gather_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int*>(rowptr),
        static_cast<const int*>(rank), nvalues, rows, nwords, cols,
        static_cast<const int*>(queries), static_cast<const float*>(grad),
        static_cast<float*>(dvalues), nq, vec);
  return static_cast<int>(cudaGetLastError());
}
