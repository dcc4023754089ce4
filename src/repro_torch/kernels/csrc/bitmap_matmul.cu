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
// Bound on Hopper: latency. The work is 2 * nnz * n flops (9.8 MFLOP for
// the 48 x 25,600 operand at n = 8, a fraction of a microsecond of the
// CUDA cores) against the encoded stream and x (a few MB, in L2), so
// neither the tensor cores nor the bytes set the time: the chain of
// dependent L2 round trips of one CTA does, and the number of CTAs that
// share the rows. Expanding W to dense would move rows * cols values, so
// the kernel never does, and it uses no tensor cores.
//
// Design: grid (rows, S); the S CTAs of a row split its words into S
// segments and form one thread block cluster. A CTA
//   1. finds its segment's first value, rowptr[r] plus the popcount of
//      the row's words before the segment (one coalesced pass and a block
//      reduction, overlapped with the load of its own words);
//   2. compacts its words' set bits in shared memory: each thread masks
//      its word past `cols`, a block exclusive scan of the popcounts
//      places its bits, and the column offset of each set bit goes into a
//      list (the k-th entry's value is values[first + k], since a
//      segment's non-zeros are contiguous);
//   3. sweeps the list with all threads: coalesced value loads, x rows as
//      16-byte vectors where the wrapper allows it (else scalar loads),
//      kUnroll entries in flight a thread, fp32 sums over a tile of 8
//      columns of x; each tile is reduced across the block (warp shuffles,
//      then shared memory in warp order) into the CTA's partial row;
//   4. each CTA writes its partial row into the rank-0 CTA's shared
//      memory (distributed shared memory) and arrives on the cluster
//      barrier; rank 0 waits, sums the S partial rows in rank order and
//      writes y once: no scratch in device memory, no atomics, no second
//      launch, and the result does not depend on scheduling. The other
//      CTAs exit without waiting for the sum.
// Segments longer than kChunkWords words are compacted and swept in
// chunks of that many.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 8;                    // x columns per register tile
constexpr int kChunkWords = kThreads;        // words compacted per pass
constexpr int kUnroll = 8;                   // list entries in flight
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

// x[c, j0 .. j0 + 8) as fp32. kVec: n % 8 == 0 and x 16-byte aligned, so
// the 8 values are two float4 (fp32) or one 16-byte vector of halves.
template <bool kVec>
__device__ __forceinline__ void load_x8(const float* __restrict__ x, int c,
                                        int n, int j0, float* o) {
  const float* p = x + static_cast<long long>(c) * n + j0;
  if (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kTileN; ++j) o[j] = j0 + j < n ? __ldg(p + j) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load_x8(const __half* __restrict__ x, int c,
                                        int n, int j0, float* o) {
  const __half* p = x + static_cast<long long>(c) * n + j0;
  if (kVec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
      o[j] = j0 + j < n ? __half2float(p[j]) : 0.0f;
  }
}

// Exclusive scan of `cnt` over the block in thread order; `*total` gets the
// block's sum of `cnt` and `*extra_sum` that of `extra`. Ends with a
// barrier, so the scratch can be reused.
__device__ __forceinline__ int block_scan(int cnt, int extra, int* total,
                                          int* extra_sum, int* s_cnt,
                                          int* s_extra) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += u;
  }
  const int ex = __reduce_add_sync(kFull, extra);
  if (lane == 31) s_cnt[warp] = incl;
  if (lane == 0) s_extra[warp] = ex;
  __syncthreads();
  int before = 0, t = 0, e = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int v = s_cnt[k];
    before += k < warp ? v : 0;
    t += v;
    e += s_extra[k];
  }
  __syncthreads();
  *total = t;
  *extra_sum = e;
  return before + incl - cnt;
}

template <typename TV, typename TX, bool kVec>
__global__ void __launch_bounds__(kThreads)
bitmap_matmul_kernel(const uint32_t* __restrict__ words,
                     const int* __restrict__ rowptr,
                     const TV* __restrict__ values, int nvalues, int nwords,
                     int cols, int seg_words, const TX* __restrict__ x, int n,
                     TX* __restrict__ y) {
  // this CTA's partial y row (n), then rank 0's copies of every CTA's
  // partial row (S x n)
  extern __shared__ float cta_row[];
  __shared__ unsigned short list[kChunkWords * 32];
  __shared__ int s_cnt[kWarps], s_extra[kWarps];
  __shared__ float s_part[kWarps][kTileN];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = blockIdx.x;
  const int seg = blockIdx.y;                // == cluster.block_rank()
  const int w_begin = min(seg * seg_words, nwords);
  const int w_end = min(w_begin + seg_words, nwords);
  const uint32_t* wrow = words + static_cast<long long>(r) * nwords;
  const uint32_t last_mask =
      (cols & 31) ? (1u << (cols & 31)) - 1u : 0xffffffffu;
  for (int j = tid; j < n; j += kThreads) cta_row[j] = 0.0f;
  // first phase of the cluster barrier: passed once every CTA of the
  // cluster has started, before any of them writes to rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this thread's word of the first chunk, loaded before the prefix pass
  // so that both are in flight together
  auto load_word = [&](int wi) -> uint32_t {
    if (wi >= w_end) return 0u;
    const uint32_t w = __ldg(wrow + wi);
    return wi == nwords - 1 ? w & last_mask : w;   // bits past `cols`
  };
  uint32_t word = load_word(w_begin + tid);

  // set bits of the row before this segment
  int pre = 0;
#pragma unroll 4
  for (int i = tid; i < w_begin; i += kThreads) pre += __popc(__ldg(wrow + i));

  int base = __ldg(rowptr + r);              // value of the chunk's first bit
  bool first_chunk = true;
  for (int c0 = w_begin; c0 < w_end; c0 += kChunkWords) {
    if (!first_chunk) word = load_word(c0 + tid);
    int m, pre_sum;
    int k = block_scan(__popc(word), first_chunk ? pre : 0, &m, &pre_sum,
                       s_cnt, s_extra);
    if (first_chunk) base += pre_sum;
    first_chunk = false;
    while (word != 0u) {                     // this word's set bits, in order
      list[k++] = static_cast<unsigned short>(tid * 32 + __ffs(word) - 1);
      word &= word - 1u;
    }
    __syncthreads();

    const int col0 = c0 * 32;
    for (int j0 = 0; j0 < n; j0 += kTileN) {
      float acc[kTileN];
#pragma unroll
      for (int j = 0; j < kTileN; ++j) acc[j] = 0.0f;
      for (int k0 = tid; k0 < m; k0 += kThreads * kUnroll) {
        // every load of the kUnroll entries is issued before the first
        // product; entries past m repeat entry k0 with weight 0
        int e[kUnroll];
        TV vr[kUnroll];
        float xv[kUnroll][kTileN];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          e[u] = k0 + u * kThreads < m ? k0 + u * kThreads : k0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          vr[u] = __ldg(values + min(max(base + e[u], 0), nvalues - 1));
          load_x8<kVec>(x, col0 + list[e[u]], n, j0, xv[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float v = k0 + u * kThreads < m
                              ? as_x_type<TX>(to_f32(vr[u])) : 0.0f;
#pragma unroll
          for (int j = 0; j < kTileN; ++j) acc[j] += v * xv[u][j];
        }
      }
#pragma unroll
      for (int j = 0; j < kTileN; ++j) {
        float s = acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(kFull, s, off);
        if (lane == 0) s_part[warp][j] = s;
      }
      __syncthreads();
      if (tid < kTileN && j0 + tid < n) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_part[w][tid];
        cta_row[j0 + tid] += s;
      }
      __syncthreads();                       // s_part is reused
    }
    base += m;
  }

  // the cluster's partial rows, summed by rank 0 in rank order
  float* rows_s = cta_row + n;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* dst = cluster.map_shared_rank(rows_s, 0) + seg * n;
  for (int j = tid; j < n; j += kThreads) dst[j] = cta_row[j];
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (seg != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int nseg = static_cast<int>(cluster.num_blocks());
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.0f;
    for (int k = 0; k < nseg; ++k) s += rows_s[k * n + j];
    store(y + static_cast<long long>(r) * n + j, s);
  }
}

template <typename TV, typename TX, bool kVec>
cudaError_t launch(const void* words, const void* rowptr, const void* values,
                   int nvalues, int rows, int nwords, int cols, int segments,
                   int seg_words, int smem, const void* x, int n, void* y,
                   cudaStream_t stream) {
  auto kernel = bitmap_matmul_kernel<TV, TX, kVec>;
  if (smem > 16 * 1024) {                    // 48 KB with the static, or near
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(rows, segments, 1);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = smem;
  lc.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = segments;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return cudaLaunchKernelEx(
      &lc, kernel, static_cast<const uint32_t*>(words),
      static_cast<const int*>(rowptr), static_cast<const TV*>(values),
      nvalues, nwords, cols, seg_words, static_cast<const TX*>(x), n,
      static_cast<TX*>(y));
}

template <typename TV, typename TX>
cudaError_t launch_vec(int vec, const void* words, const void* rowptr,
                       const void* values, int nvalues, int rows, int nwords,
                       int cols, int segments, int seg_words, int smem,
                       const void* x, int n, void* y, cudaStream_t s) {
  return vec ? launch<TV, TX, true>(words, rowptr, values, nvalues, rows,
                                    nwords, cols, segments, seg_words, smem,
                                    x, n, y, s)
             : launch<TV, TX, false>(words, rowptr, values, nvalues, rows,
                                     nwords, cols, segments, seg_words, smem,
                                     x, n, y, s);
}

}  // namespace

// value_half / x_half: 0 for float32, 1 for float16. segments (1 to 8):
// CTAs per row, one cluster; seg_words: words per segment, none empty;
// smem: dynamic shared memory a CTA, at least (segments + 1) * n floats
// (the wrapper's `matmul_plan` sets all three). vec: 1 where n % 8 == 0
// and x is 16-byte aligned.
extern "C" int bitmap_matmul_launch(const void* words, const void* rowptr,
                                    const void* values, int nvalues,
                                    int value_half, int rows, int nwords,
                                    int cols, int segments, int seg_words,
                                    int smem, const void* x, int x_half,
                                    int n, int vec, void* y, void* stream) {
  if (segments < 1 || segments > 8
      || static_cast<long long>(smem)
             < static_cast<long long>(n) * (segments + 1) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (value_half && x_half)
      err = launch_vec<__half, __half>(vec, words, rowptr, values, nvalues,
                                       rows, nwords, cols, segments,
                                       seg_words, smem, x, n, y, s);
    else if (value_half)
      err = launch_vec<__half, float>(vec, words, rowptr, values, nvalues,
                                      rows, nwords, cols, segments, seg_words,
                                      smem, x, n, y, s);
    else if (x_half)
      err = launch_vec<float, __half>(vec, words, rowptr, values, nvalues,
                                      rows, nwords, cols, segments, seg_words,
                                      smem, x, n, y, s);
    else
      err = launch_vec<float, float>(vec, words, rowptr, values, nvalues,
                                     rows, nwords, cols, segments, seg_words,
                                     smem, x, n, y, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
