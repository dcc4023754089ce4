// COO gather: values of a sorted COO stream at linear query coordinates,
// 0 where a coordinate is absent.
//
// Replaces the TPU kernel src/repro/kernels/coo_gather.py `coo_gather`
// (Pallas body `_kernel`): a branchless binary search of ceil(log2 n)+1
// steps per query over the sorted coordinates, padded with INT32_MAX.
//
// Bound on Hopper: memory. Each query reads 4 bytes and writes 4; the
// search touches log2(n) coordinates, but the whole stream (at most
// 16 x 25,600 entries at full width, 1.6 MB) stays in the 50 MB L2, so
// device-memory traffic is the query and output arrays.
//
// Design: one thread per query, the same step count and clamps as the
// reference, so the result is bit-exact. Neighbouring threads read
// neighbouring queries and write neighbouring outputs (coalesced); the
// search reads go through the read-only cache.
#include <cuda_runtime.h>

namespace {

__global__ void coo_gather_kernel(const int* __restrict__ coords,
                                  const float* __restrict__ values, int n,
                                  int steps, const int* __restrict__ queries,
                                  float* __restrict__ out, long long nq) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int q = queries[i];
  int lo = 0, hi = n;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool right = __ldg(coords + min(mid, n - 1)) < q;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  const int safe = min(lo, n - 1);
  const bool found = lo < n && __ldg(coords + safe) == q;
  out[i] = found ? __ldg(values + safe) : 0.0f;
}

}  // namespace

extern "C" int coo_gather_launch(const void* coords, const void* values,
                                 int n, int steps, const void* queries,
                                 void* out, long long nq, void* stream) {
  if (nq > 0) {
    const int threads = 256;
    const long long blocks = (nq + threads - 1) / threads;
    coo_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(coords), static_cast<const float*>(values), n,
        steps, static_cast<const int*>(queries), static_cast<float*>(out), nq);
  }
  return static_cast<int>(cudaGetLastError());
}
