// COO gather: values of a sorted COO stream at linear query coordinates,
// 0 where a coordinate is absent.
//
// Replaces the TPU kernel src/repro/kernels/coo_gather.py `coo_gather`
// (Pallas body `_kernel`): a branchless binary search of ceil(log2 n)+1
// steps per query over the sorted coordinates, padded with INT32_MAX.
//
// Bound on Hopper: memory. Each query reads 4 bytes and writes 4; the
// stream (at most 16 x 25,600 entries at full width, 1.6 MB) stays in the
// 50 MB L2, so device-memory traffic is the query and output arrays. A
// search from the top of the stream costs 17 dependent L2 round trips per
// query, and the latency of those, not the bytes, held the first design
// at 4x its bound.
//
// Design: a CTA takes a tile of kTile consecutive queries (8 a thread,
// loaded and stored as 16-byte vectors where the pointer allows). The
// serving path's queries come from the occupancy build in meshgrid order
// (row * ncols + stencil column), so a tile spans a narrow band of
// coordinates. A block reduction gives the tile's least and largest
// query; two warps find the window [lo, hi) of stream entries between
// them with 32 pivots a step (about 4 coalesced steps instead of 17
// dependent ones). When the window holds at most kCapacity entries, the
// CTA copies its coordinates and values into shared memory (cp.async) and
// each query searches there in ceil(log2(hi - lo + 1)) steps, the
// searches of a thread's queries in lockstep. A wider window (any query
// order is allowed) is searched per query in device memory, within
// [lo, hi), as the first design did. The capacity is kept small (1,024
// entries, 8 KB) so that resident CTAs leave most of the SM's L1 to the
// stream, which the wide searches read; the serving path's windows hold
// a few hundred entries. Every path computes
// the exact lower bound of the query, so the result is bit-exact with the
// reference: coordinates below lo are smaller than every query of the
// tile and those from hi on larger, and pad entries (INT32_MAX) sort last.
//
// The backward (`coo_gather_bwd_kernel`) is the gradient with respect to
// the values, which the reference takes by differentiating its jnp oracle
// (src/repro/kernels/ref.py `coo_gather_ref`): a scatter-add of each
// query's gradient into the slot it read. Bound by memory: the incoming
// gradient (4 bytes a query), the queries of nonzero gradient and the
// values' read-modify-write. One thread a query, each searching the whole
// stream (17 dependent loads through L1 and L2), ran at 3x that bound,
// held by the searches (its atomics cost nothing measurable). So it takes
// the shared loads and run merge (gather_bwd.cuh) and the forward's
// window: a CTA of kBwdSpan tiles bounds its first tile's window with
// `warp_bound`, stages a range of the stream's coordinates around it in
// shared memory (at most kBwdCapacity, about one row's entries at the
// training shape; the CTA's following tiles of the row fall in it), and
// each warp searches each run of equal queries once, in that range in
// ceil(log2(range)) steps, two runs a lane in lockstep. Only the first
// tile waits on barriers: a window of its own for each tile (the
// forward's shape) put the bound's chain of loads between every tile and
// the next, and the warps' tiles, 16 queries a thread, keep more bytes in
// flight through each warp's chain of loads. Queries outside the range
// are searched in device memory (a window wider than the capacity within
// [lo, hi), as the forward's wide path).
#include <climits>
#include <cuda_runtime.h>

#include "gather_bwd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                      // queries per thread
constexpr int kTile = kThreads * kPer;       // queries per CTA
constexpr int kCapacity = 1024;              // window entries staged
constexpr int kRow = kThreads * 4;           // a row of 16-byte vectors
constexpr int kBwdPer = 16;                  // backward queries a thread
constexpr int kBwdTile = kBwdThreads * kBwdPer;
constexpr int kBwdSpan = 16;                 // backward tiles a CTA
constexpr int kBwdCapacity = 3072;           // backward staged entries
constexpr int kBwdList = kBwdDirect * (kBwdPer / 4);  // a warp's runs
constexpr unsigned kFull = 0xffffffffu;

// Number of entries of coords[0, n) below `key` (kUpper: at most `key`),
// i.e. the lower (upper) bound, found by one warp: each step reads 32
// pivots strictly inside the open range and keeps the gap where the
// predicate turns, so the range shrinks 33-fold per step. The whole warp
// must call it; every lane returns the bound.
template <bool kUpper>
__device__ int warp_bound(const int* __restrict__ coords, int n, int key,
                          int lane) {
  int a = 0, b = n;                          // the bound lies in [a, b]
  while (b - a > 32) {
    const int span = b - a;
    const int p = a + static_cast<int>(
        static_cast<long long>(lane + 1) * span / 33);
    const int c = __ldg(coords + p);
    const bool below = kUpper ? c <= key : c < key;
    const int k = __popc(__ballot_sync(kFull, below));
    const int pa = __shfl_sync(kFull, p, (k + 31) & 31);
    const int pb = __shfl_sync(kFull, p, k & 31);
    a = k > 0 ? pa + 1 : a;
    b = k < 32 ? pb : b;
  }
  const int p = a + lane;
  bool below = false;
  if (p < b) {
    const int c = __ldg(coords + p);
    below = kUpper ? c <= key : c < key;
  }
  return a + __popc(__ballot_sync(kFull, below));
}

// Lower bounds of the kN queries q in a sorted array of m >= 1 entries,
// branchless: the same ceil(log2 m) halvings for every query, so each step
// issues kN independent loads. `at(i)` reads entry i.
template <int kN, typename At>
__device__ __forceinline__ void lower_bounds(At at, int m, const int* q,
                                             int* idx) {
#pragma unroll
  for (int e = 0; e < kN; ++e) idx[e] = 0;
  while (m > 1) {
    const int half = m >> 1;
#pragma unroll
    for (int e = 0; e < kN; ++e)
      idx[e] = at(idx[e] + half - 1) < q[e] ? idx[e] + half : idx[e];
    m -= half;
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) idx[e] += at(idx[e]) < q[e] ? 1 : 0;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Element e of a thread's kPer queries sits at tile offset
// (e / 4) * kRow + threadIdx.x * 4 + e % 4: kPer / 4 16-byte vectors a
// thread, neighbouring threads on neighbouring vectors.
__device__ __forceinline__ int tile_offset(int e) {
  return (e >> 2) * kRow + threadIdx.x * 4 + (e & 3);
}

__global__ void __launch_bounds__(kThreads)
coo_gather_kernel(const int* __restrict__ coords,
                  const float* __restrict__ values, int n,
                  const int* __restrict__ queries, float* __restrict__ out,
                  long long nq, int vec, int* __restrict__ staged) {
  __shared__ int s_coords[kCapacity];
  __shared__ float s_values[kCapacity];
  __shared__ int s_min[kWarps], s_max[kWarps], s_win[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const bool vector = vec && tile0 + kTile <= nq;
  const int* qt = queries + tile0;

  int q[kPer];
  if (vector) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(qt + v * kRow)
                           + threadIdx.x);
      q[4 * v] = a.x;
      q[4 * v + 1] = a.y;
      q[4 * v + 2] = a.z;
      q[4 * v + 3] = a.w;
    }
  } else {
    // past nq, repeat the tile's first query: it moves neither bound
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int off = tile_offset(e);
      q[e] = __ldg(qt + (tile0 + off < nq ? off : 0));
    }
  }

  // the tile's least and largest query
  int qmin = q[0], qmax = q[0];
#pragma unroll
  for (int e = 1; e < kPer; ++e) {
    qmin = min(qmin, q[e]);
    qmax = max(qmax, q[e]);
  }
  qmin = __reduce_min_sync(kFull, qmin);
  qmax = __reduce_max_sync(kFull, qmax);
  if (lane == 0) {
    s_min[warp] = qmin;
    s_max[warp] = qmax;
  }
  __syncthreads();
  if (warp < 2) {
    int v = warp == 0 ? INT_MAX : INT_MIN;
    if (lane < kWarps) v = warp == 0 ? s_min[lane] : s_max[lane];
    if (warp == 0) {
      const int key = __reduce_min_sync(kFull, v);
      const int lo = warp_bound<false>(coords, n, key, lane);
      if (lane == 0) s_win[0] = lo;
    } else {
      const int key = __reduce_max_sync(kFull, v);
      const int hi = warp_bound<true>(coords, n, key, lane);
      if (lane == 0) s_win[1] = hi;
    }
  }
  __syncthreads();
  const int lo = s_win[0];
  const int m = s_win[1] - lo;               // window entries, >= 0

  float r[kPer];
  int idx[kPer];
  if (m <= kCapacity) {
    // staged: the window in shared memory
    if (staged != nullptr && threadIdx.x == 0) atomicAdd(staged, 1);
    for (int i = threadIdx.x; i < m; i += kThreads) {
      cp_async4(s_coords + i, coords + lo + i);
      cp_async4(s_values + i, values + lo + i);
    }
    cp_async_wait_all();
    if (m > 0) {
      lower_bounds<kPer>([&](int i) { return s_coords[i]; }, m, q, idx);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        r[e] = idx[e] < m && s_coords[idx[e]] == q[e] ? s_values[idx[e]]
                                                      : 0.0f;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) r[e] = 0.0f;
    }
  } else {
    // wide: search [lo, lo + m) in device memory, through L1
    const int* wc = coords + lo;
    lower_bounds<kPer>([&](int i) { return __ldg(wc + i); }, m, q, idx);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      r[e] = idx[e] < m && __ldg(wc + idx[e]) == q[e]
                 ? __ldg(values + lo + idx[e]) : 0.0f;
  }

  float* ot = out + tile0;
  if (vector) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v)
      reinterpret_cast<float4*>(ot + v * kRow)[threadIdx.x] = make_float4(
          r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int off = tile_offset(e);
      if (tile0 + off < nq) ot[off] = r[e];
    }
  }
}

// The gradient of the gather with respect to the values:
// dvalues[slot(q_i)] += grad[i] for each query whose coordinate is in the
// stream, slot being the entry the forward reads (the query's lower
// bound). A CTA takes kBwdSpan consecutive tiles of kBwdTile queries. Its
// first tile's window [lo, hi) (the entries between its least and largest
// query of nonzero gradient, `warp_bound`) sets the CTA's range: when the
// window holds at most kBwdCapacity entries, kBwdCapacity coordinates
// centred on it, staged in shared memory; otherwise the window itself, in
// device memory. Then each warp, tile after tile and with no barrier,
// merges its runs of equal queries (gather_bwd.cuh) and searches each run
// once in the range when its queries of nonzero gradient lie strictly
// between the entries just outside the range (in ceil(log2(entries))
// steps), or else in the whole stream, and adds it by one fp32 atomic. A
// zero gradient adds nothing, an entry no query reads stays 0, pad entries
// (INT32_MAX) sort last and queries above the last coordinate are absent.
// `staged`: nullptr, or an int the kernel adds the number of (tile, warp)
// pairs with a query of nonzero gradient that it searched in shared memory
// to. The sum's order, and its last bits, change from run to run.
__global__ void __launch_bounds__(kBwdThreads)
coo_gather_bwd_kernel(const int* __restrict__ coords, int n,
                      const int* __restrict__ queries,
                      const float* __restrict__ grad,
                      float* __restrict__ dvalues, long long nq, int vec,
                      int* __restrict__ staged) {
  __shared__ int s_coords[kBwdCapacity];
  __shared__ BwdRuns<kBwdList> runs;
  __shared__ int s_min[kBwdWarps], s_max[kBwdWarps], s_win[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0 = static_cast<long long>(blockIdx.x) * kBwdSpan;
  const long long t1 = min((nq + kBwdTile - 1) / kBwdTile, t0 + kBwdSpan);
  int q[kBwdPer];
  float g[kBwdPer];
  const bool vector0 = vec && (t0 + 1) * kBwdTile <= nq;
  bwd_load_grad(grad, t0 * kBwdTile, nq, vector0, g);
  bwd_load_queries(queries, t0 * kBwdTile, vector0, g, q);

  // the CTA's range [start, start + m), and the entries just outside it
  // (INT_MIN / INT_MAX past the stream's ends); none without a query
  int qmin = INT_MAX, qmax = INT_MIN;
  bool any = false;
#pragma unroll
  for (int e = 0; e < kBwdPer; ++e) {
    if (g[e] != 0.0f) {
      qmin = min(qmin, q[e]);
      qmax = max(qmax, q[e]);
      any = true;
    }
  }
  int start = 0, m = 0, below = INT_MAX, above = INT_MIN;
  bool in_smem = false;
  if (__syncthreads_or(any)) {
    qmin = __reduce_min_sync(kFull, qmin);
    qmax = __reduce_max_sync(kFull, qmax);
    if (lane == 0) {
      s_min[warp] = qmin;
      s_max[warp] = qmax;
    }
    __syncthreads();
    if (warp < 2) {
      int v = warp == 0 ? INT_MAX : INT_MIN;
      if (lane < kBwdWarps) v = warp == 0 ? s_min[lane] : s_max[lane];
      const int b = warp == 0
          ? warp_bound<false>(coords, n, __reduce_min_sync(kFull, v), lane)
          : warp_bound<true>(coords, n, __reduce_max_sync(kFull, v), lane);
      if (lane == 0) s_win[warp] = b;
    }
    __syncthreads();
    const int lo = s_win[0];
    const int hi = max(s_win[1], lo);
    in_smem = hi - lo <= kBwdCapacity;
    if (in_smem) {
      start = max(0, lo - (kBwdCapacity - (hi - lo)) / 2);
      const int end = min(n, start + kBwdCapacity);
      start = max(0, end - kBwdCapacity);
      m = end - start;
      for (int i = threadIdx.x; i < m; i += kBwdThreads)
        cp_async4(s_coords + i, coords + start + i);
      cp_async_wait_all();
    } else {
      start = lo;
      m = hi - lo;
    }
    below = start > 0 ? __ldg(coords + start - 1) : INT_MIN;
    above = start + m < n ? __ldg(coords + start + m) : INT_MAX;
  }

  int warp_staged = 0;
  for (long long t = t0; t < t1; ++t) {
    if (t > t0) {
      const bool vector = vec && (t + 1) * kBwdTile <= nq;
      bwd_load_grad(grad, t * kBwdTile, nq, vector, g);
      bwd_load_queries(queries, t * kBwdTile, vector, g, q);
    }
    int wmin = INT_MAX, wmax = INT_MIN;
    bool mine = false;                       // a nonzero gradient here
#pragma unroll
    for (int e = 0; e < kBwdPer; ++e) {
      if (g[e] != 0.0f) {
        wmin = min(wmin, q[e]);
        wmax = max(wmax, q[e]);
        mine = true;
      }
    }
    if (!__any_sync(kFull, mine)) continue;
    wmin = __reduce_min_sync(kFull, wmin);
    wmax = __reduce_max_sync(kFull, wmax);
    const bool inside = below < wmin && wmax < above;
    if (inside && in_smem) {
      ++warp_staged;
      bwd_merge_flush<2>(q, g, runs, [&](const int (&key)[2],
                                      const float (&sum)[2], unsigned live) {
        int idx[2];
        lower_bounds<2>([&](int i) { return s_coords[i]; }, m, key, idx);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (((live >> e) & 1u) && idx[e] < m && s_coords[idx[e]] == key[e])
            atomicAdd(dvalues + start + idx[e], sum[e]);
      });
    } else {
      // device memory: the CTA's wide window, or the whole stream
      const int* wc = inside ? coords + start : coords;
      const int wm = inside ? m : n;
      bwd_merge_flush<2>(q, g, runs, [&](const int (&key)[2],
                                      const float (&sum)[2], unsigned live) {
        int idx[2];
        lower_bounds<2>([&](int i) { return __ldg(wc + i); }, wm, key, idx);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (((live >> e) & 1u) && idx[e] < wm
              && __ldg(wc + idx[e]) == key[e])
            atomicAdd(dvalues + (wc - coords) + idx[e], sum[e]);
      });
    }
  }
  if (staged != nullptr && lane == 0 && warp_staged > 0)
    atomicAdd(staged, warp_staged);
}

}  // namespace

// tile, capacity, blocks: the wrapper's plan (`coo_plan`), which must
// agree with kTile and kCapacity and cover nq; vec: 1 where queries and
// out are 16-byte aligned; staged: nullptr, or an int the kernel adds 1 to
// for each tile it stages.
extern "C" int coo_gather_launch(const void* coords, const void* values,
                                 int n, int tile, int capacity,
                                 long long blocks, int vec,
                                 const void* queries, void* out, long long nq,
                                 void* staged, void* stream) {
  if (tile != kTile || capacity != kCapacity || blocks * kTile < nq
      || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0)
    coo_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(coords), static_cast<const float*>(values), n,
        static_cast<const int*>(queries), static_cast<float*>(out), nq, vec,
        static_cast<int*>(staged));
  return static_cast<int>(cudaGetLastError());
}

// dvalues: n floats, zeroed by the caller; the kernel adds into it. tile,
// capacity, span, blocks: the wrapper's plan (`coo_bwd_plan`), which must
// agree with kBwdTile, kBwdCapacity and kBwdSpan and cover nq; vec: 1
// where queries and grad are 16-byte aligned; staged: nullptr, or an int
// the kernel adds the (tile, warp) pairs it searched in shared memory to.
extern "C" int coo_gather_bwd_launch(const void* coords, int n, int tile,
                                     int capacity, int span,
                                     long long blocks, int vec,
                                     const void* queries, const void* grad,
                                     void* dvalues, long long nq,
                                     void* staged, void* stream) {
  if (n < 1 || tile != kBwdTile || capacity != kBwdCapacity
      || span != kBwdSpan || blocks * kBwdSpan * kBwdTile < nq
      || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0)
    coo_gather_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(coords), n, static_cast<const int*>(queries),
        static_cast<const float*>(grad), static_cast<float*>(dvalues), nq,
        vec, static_cast<int*>(staged));
  return static_cast<int>(cudaGetLastError());
}
