// The tile loads and the run merge that the gathers' backward kernels
// share (bitmap_gather.cu `bitmap_gather_bwd_kernel`, coo_gather.cu
// `coo_gather_bwd_kernel`).
//
// Both compute dvalues[slot(q_i)] += grad[i] over a row-major query
// stream (`core/tensorf.gather_factor`: q = row * ncols + col, the
// columns in sample order), so neighbouring queries are neighbouring
// samples of one ray at one stencil corner and often repeat. A CTA works
// on tiles of kBwdThreads * kPer consecutive queries (each kernel sets
// its kPer), kPer a thread as kPer / 4 rows of 16-byte vectors (element
// e at tile offset (e / 4) * kBwdRow + threadIdx.x * 4 + e % 4: in each
// row a warp holds 128 consecutive queries, lanes in order, 4 a lane).
// The gradient is read first; a vector of queries only where one of its
// 4 gradients is not 0. In each row of a warp:
//
//   * a lane sums its runs of equal queries in registers, skipping zero
//     gradients (they add nothing and their queries are not read);
//   * where the warp's row holds at most kBwdDirect runs, the lanes write
//     them to the warp's list in shared memory in query order (lanes
//     without a gradient write none), so that runs that continue across
//     lanes meet there as neighbours with equal queries; the warp reads
//     the list 32 or 64 entries a step, and the entry that starts a run
//     of equal queries sums that run and flushes it while the others
//     skip. So the slot or the search runs once a run, with the warp's
//     lanes busy, and each run issues one fp32 atomicAdd (RED). A kernel
//     lists a row at a time, or all its rows of a tile and flushes them
//     together, two runs a lane side by side (the COO kernel: two
//     searches in lockstep);
//   * a row of more runs (no repeats to merge, as in a shuffled stream)
//     flushes each lane's runs from registers, without the list.
//
// Timing the parts at the training call's shape (PERF.md) showed the
// merge across lanes as a segmented sum over the warp (head flags from __shfl_up_sync, 5 shuffle
// steps a row) costing more than the atomics it saved; the list merges
// the same runs with a few shared-memory reads a run.
//
// Equal queries have equal slots, so merging on the query is exact;
// different queries that clamp onto one slot meet at the atomics, which
// stays right. Only the order of the sums changes: two orders of the same
// k terms differ by at most about 2 k 2^-24 sum|g|.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRow = kBwdThreads * 4;           // a row of vectors
constexpr int kBwdDirect = 64;                     // runs a row in a list
constexpr unsigned kBwdFull = 0xffffffffu;

// Each warp's list of runs, kList entries: a row's (kBwdDirect) or a
// tile's (see bwd_merge_flush).
template <int kList>
struct BwdRuns {
  static_assert(kList >= kBwdDirect, "a list holds a row's runs");
  int key[kBwdWarps][kList];
  float sum[kBwdWarps][kList];
};

__device__ __forceinline__ int bwd_offset(int e) {
  return (e >> 2) * kBwdRow + threadIdx.x * 4 + (e & 3);
}

// The thread's kPer gradients of the tile at tile0. `vector`: the tile
// is whole and the pointer 16-byte aligned; otherwise one element at a
// time, past nq read as 0.
template <int kPer>
__device__ __forceinline__ void bwd_load_grad(const float* __restrict__ grad,
                                              long long tile0, long long nq,
                                              bool vector,
                                              float (&g)[kPer]) {
  const float* gt = grad + tile0;
  if (vector) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(gt + v * kBwdRow)
                             + threadIdx.x);
      g[4 * v] = a.x;
      g[4 * v + 1] = a.y;
      g[4 * v + 2] = a.z;
      g[4 * v + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int off = bwd_offset(e);
      g[e] = tile0 + off < nq ? __ldg(gt + off) : 0.0f;
    }
  }
}

// The thread's queries of the tile at tile0 where its gradient is not 0
// (0 elsewhere, never read): a 16-byte vector where one of its 4
// gradients is not 0 (`vector`: as for the gradient, and the queries'
// pointer 16-byte aligned too).
template <int kPer>
__device__ __forceinline__ void bwd_load_queries(
    const int* __restrict__ queries, long long tile0, bool vector,
    const float (&g)[kPer], int (&q)[kPer]) {
  const int* qt = queries + tile0;
  if (vector) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      int4 b = make_int4(0, 0, 0, 0);
      if (g[4 * v] != 0.0f || g[4 * v + 1] != 0.0f || g[4 * v + 2] != 0.0f
          || g[4 * v + 3] != 0.0f)
        b = __ldg(reinterpret_cast<const int4*>(qt + v * kBwdRow)
                  + threadIdx.x);
      q[4 * v] = b.x;
      q[4 * v + 1] = b.y;
      q[4 * v + 2] = b.z;
      q[4 * v + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      q[e] = g[e] != 0.0f ? __ldg(qt + bwd_offset(e)) : 0;
  }
}

// A lane's runs among its 4 elements of a row, zero gradients skipped:
// bit j of the result marks element j as a run's last element, and
// sum[j] is then the run's sum (its query is q[j]).
__device__ __forceinline__ unsigned bwd_lane_runs(const int* q,
                                                  const float* g,
                                                  float (&sum)[4]) {
  bool valid[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) valid[j] = g[j] != 0.0f;
  float acc = 0.0f;
  bool seen = false;
  int prev = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (valid[j]) {
      acc = seen && prev == q[j] ? acc + g[j] : g[j];
      seen = true;
      prev = q[j];
    }
    sum[j] = acc;
  }
  unsigned mask = 0u;
  bool after = false;
  int next = 0;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    if (valid[j] && !(after && next == q[j])) mask |= 1u << j;
    if (valid[j]) {
      after = true;
      next = q[j];
    }
  }
  return mask;
}

// Flushes the first `total` runs of a warp's list: the entry that starts
// a run of equal queries (its neighbour before it differs) sums that run;
// kPair entries a lane a step (see bwd_merge_flush).
template <int kPair, typename Flush>
__device__ __forceinline__ void bwd_flush_list(const int* key,
                                               const float* val, int total,
                                               int lane, Flush flush) {
  __syncwarp();
  for (int i = lane; i < total; i += 32 * kPair) {
    int k[kPair];
    float s[kPair];
    unsigned live = 0u;
#pragma unroll
    for (int e = 0; e < kPair; ++e) {
      const int at = i + 32 * e;
      k[e] = at < total ? key[at] : 0;
      s[e] = 0.0f;
      if (at < total && !(at > 0 && key[at - 1] == k[e])) {
        s[e] = val[at];
        for (int j = at + 1; j < total && key[j] == k[e]; ++j) s[e] += val[j];
        live |= 1u << e;
      }
    }
    if (live) flush(k, s, live);
  }
  __syncwarp();
}

// Merges the thread's kPer / 4 rows and flushes each run of a warp's
// rows once: flush(key, sum, live) takes kPair (1 or 2) runs a lane,
// key[e] and sum[e] where bit e of `live` is set, so that two slots or
// searches can run side by side (the queries of the others are
// arbitrary). A list of kBwdDirect * kPer / 4 entries takes all the rows
// of a tile and is flushed once; a list of kBwdDirect entries is flushed
// after each row. The whole warp calls it; `runs` is the CTA's lists.
template <int kPair, int kPer, int kList, typename Flush>
__device__ __forceinline__ void bwd_merge_flush(const int (&q)[kPer],
                                                const float (&g)[kPer],
                                                BwdRuns<kList>& runs,
                                                Flush flush) {
  static_assert(kPair == 1 || kPair == 2, "one or two runs a lane a step");
  constexpr bool kShared = kList >= kBwdDirect * (kPer / 4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* key = runs.key[warp];
  float* val = runs.sum[warp];
  const unsigned before = (1u << lane) - 1u;
  int total = 0;                                   // the list's runs
#pragma unroll
  for (int v = 0; v < kPer / 4; ++v) {
    const int* qv = q + 4 * v;
    const float* gv = g + 4 * v;
    float sum[4];
    const unsigned mask = bwd_lane_runs(qv, gv, sum);
    const int c = __popc(mask);
    const int row = __reduce_add_sync(kBwdFull, c);
    if (row == 0) continue;
    if (row > kBwdDirect) {
      // no list: the lane's own runs, kPair at a time
#pragma unroll
      for (int j = 0; j < 4; j += kPair) {
        int k[kPair];
        float s[kPair];
#pragma unroll
        for (int e = 0; e < kPair; ++e) {
          k[e] = qv[j + e];
          s[e] = sum[j + e];
        }
        const unsigned live = (mask >> j) & ((1u << kPair) - 1u);
        if (live) flush(k, s, live);
      }
      continue;
    }
    // this lane's place in the list: the runs of the lanes before it
    int at = total + __popc(__ballot_sync(kBwdFull, c > 0) & before)
             + __popc(__ballot_sync(kBwdFull, c > 1) & before)
             + __popc(__ballot_sync(kBwdFull, c > 2) & before)
             + __popc(__ballot_sync(kBwdFull, c > 3) & before);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((mask >> j) & 1u) {
        key[at] = qv[j];
        val[at] = sum[j];
        ++at;
      }
    }
    total += row;
    if constexpr (!kShared) {
      bwd_flush_list<kPair>(key, val, total, lane, flush);
      total = 0;
    }
  }
  if constexpr (kShared) {
    if (total > 0) bwd_flush_list<kPair>(key, val, total, lane, flush);
  }
}

}  // namespace
