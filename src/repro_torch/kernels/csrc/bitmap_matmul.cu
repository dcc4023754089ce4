// Bitmap-encoded sparse matmul: y = decode(words, rowptr, values) @ x for a
// (rows, cols) matrix W held as one bit per element plus its packed
// non-zeros, and a dense x (cols, n). The decoded weight is cast to x's
// type, the product is summed in fp32 and y is written in x's type.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_decode.py
// `bitmap_matmul` (Pallas body `_kernel`): per 8-row block it expands the
// bits to a dense (8, cols) block with a prefix count over every bit
// position, gathers the values and feeds the dense block to the MXU.
//
// Bound on Hopper: memory. The work is 2 * nnz * n flops against the
// encoded stream (cols / 8 bytes of bits a row, one value per non-zero)
// and x; at n = 8 that is under 1 flop per byte. Expanding W to dense
// would move rows * cols values, so the kernel never does.
//
// Design: one CTA per row; its threads take the row's bitmap words in
// passes of blockDim words, in order. A word's first value sits at
// rowptr + the set bits of the words before it: a block-wide exclusive
// scan of the word popcounts (warp __shfl_up_sync scans plus one value
// per warp in shared memory), carried from pass to pass, as the Pallas
// body's prefix count is. Each thread walks its word's set bits with
// __ffs and accumulates value * x[c, j] for a tile of kTileN columns of
// x in fp32 registers; a warp-shuffle and shared-memory reduction, in a
// fixed order, writes y[row, tile]. Only the non-zeros are touched.
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 8;                    // x columns per register tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// the decoded weight, cast to x's type, as the fp32 the product uses
template <typename TX>
__device__ __forceinline__ float as_x_type(float v);
template <>
__device__ __forceinline__ float as_x_type<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_x_type<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

template <typename TV, typename TX>
__global__ void __launch_bounds__(kThreads)
bitmap_matmul_kernel(const uint32_t* __restrict__ words,
                     const int* __restrict__ rowptr,
                     const TV* __restrict__ values, int nvalues, int nwords,
                     int cols, const TX* __restrict__ x, int n,
                     TX* __restrict__ y) {
  __shared__ int warp_total[kWarps];
  __shared__ float partial[kWarps][kTileN];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row_off = static_cast<long long>(r) * nwords;
  const uint32_t last_mask =
      (cols & 31) ? (1u << (cols & 31)) - 1u : 0xffffffffu;
  for (int j0 = 0; j0 < n; j0 += kTileN) {
    float acc[kTileN];
#pragma unroll
    for (int j = 0; j < kTileN; ++j) acc[j] = 0.0f;
    int base = __ldg(rowptr + r);            // first value of this pass
    for (int w0 = 0; w0 < nwords; w0 += kThreads) {
      const int wi = w0 + threadIdx.x;
      uint32_t word = 0;
      if (wi < nwords) {
        word = __ldg(words + row_off + wi);
        if (wi == nwords - 1) word &= last_mask;   // bits past `cols`
      }
      const int cnt = __popc(word);
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      if (lane == 31) warp_total[warp] = incl;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int t = warp_total[k];
        before += k < warp ? t : 0;
        total += t;
      }
      __syncthreads();                       // warp_total is reused
      int addr = base + before + incl - cnt;
      base += total;
      while (word != 0u) {
        const int b = __ffs(word) - 1;
        word &= word - 1u;
        const int c = wi * 32 + b;
        const float v = as_x_type<TX>(
            to_f32(values[min(max(addr, 0), nvalues - 1)]));
        ++addr;
        const TX* xr = x + static_cast<long long>(c) * n + j0;
#pragma unroll
        for (int j = 0; j < kTileN; ++j)
          if (j0 + j < n) acc[j] += v * to_f32(xr[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTileN; ++j) {
      float v = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) partial[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < kTileN && j0 + threadIdx.x < n) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += partial[k][threadIdx.x];
      store(y + static_cast<long long>(r) * n + j0 + threadIdx.x, sum);
    }
    __syncthreads();                         // partial is reused
  }
}

template <typename TV, typename TX>
void launch(const void* words, const void* rowptr, const void* values,
            int nvalues, int rows, int nwords, int cols, const void* x, int n,
            void* y, cudaStream_t stream) {
  bitmap_matmul_kernel<TV, TX><<<rows, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(rowptr),
      static_cast<const TV*>(values), nvalues, nwords, cols,
      static_cast<const TX*>(x), n, static_cast<TX*>(y));
}

}  // namespace

// value_half / x_half: 0 for float32, 1 for float16.
extern "C" int bitmap_matmul_launch(const void* words, const void* rowptr,
                                    const void* values, int nvalues,
                                    int value_half, int rows, int nwords,
                                    int cols, const void* x, int x_half,
                                    int n, void* y, void* stream) {
  if (rows > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (value_half && x_half)
      launch<__half, __half>(words, rowptr, values, nvalues, rows, nwords,
                             cols, x, n, y, s);
    else if (value_half)
      launch<__half, float>(words, rowptr, values, nvalues, rows, nwords,
                            cols, x, n, y, s);
    else if (x_half)
      launch<float, __half>(words, rowptr, values, nvalues, rows, nwords,
                            cols, x, n, y, s);
    else
      launch<float, float>(words, rowptr, values, nvalues, rows, nwords,
                           cols, x, n, y, s);
  }
  return static_cast<int>(cudaGetLastError());
}
