// Fused decode-sample-accumulate over the hybrid-encoded TensoRF field:
// (sigma_raw (N,), feat (N, app_dim)) for points grouped by occupancy cube,
// read straight from the encoded bitmap/COO/dense streams of the twelve VM
// factor slices.
//
// Replaces the TPU kernel src/repro/kernels/fused_sample.py
// `fused_sigma_app` (Pallas body `_kernel` -> `_eval` -> `_decode_cols`):
// per cube, decode the W x W plane windows and W-long line windows of all
// twelve slices (bitmap: rank read + one masked-word popcount; COO:
// branchless binary search; dense: plain read), interpolate (bilinear on
// planes, linear on lines), and fold the Eq. 2 products into the density
// sum and, through the basis, the appearance features.
//
// Bound on Hopper: fp32 operations. At full width (R = 16 + 48, app_dim
// 27) each point costs about 10k flops, three quarters of them the basis
// product, against about 130 bytes of point input and output.
//
// Design, simple and correct first:
//  (a) fused_decode_kernel writes every cube's decoded windows to a
//      scratch buffer the wrapper allocates: (C, 3, W*W, R) plane cells
//      and (C, 3, W, R) line cells, R = Rs + Rc channels per cell, so a
//      stencil corner is one contiguous R-float row. One thread per
//      window element; C * 3 * (W*W + W) * R elements (675 KB at C = 8).
//  (b) fused_sample_kernel takes one thread per point: it interpolates
//      from the scratch rows, sums the Rs density channels and
//      accumulates feat += comp_app @ basis[m] from the basis staged in
//      shared memory (3 * Rc * app_dim floats, 15.5 KB at full width).
//      The basis product stays inside the kernel, as in the reference.
// The reference's summation order differs (one matmul per mode), so the
// result agrees with the plain version to a tolerance, not bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFactors = 12;
constexpr int kMaxAppDim = 32;   // feat accumulators held in registers
enum { kDense = 0, kBitmap = 1, kCoo = 2 };

struct FactorDesc {
  int fmt;
  int rows;
  int ncols;
  int nwords;       // bitmap: words per row
  int n;            // bitmap: values length; coo: coords length
  int steps;        // coo: binary-search steps
  const void* a;    // dense matrix | bitmap words | coo coords
  const void* b;    //              | bitmap rank  | coo values
  const void* c;    //              | bitmap values
};

struct FieldDesc {
  FactorDesc f[kFactors];   // sigma_planes[0..2], sigma_lines[0..2],
                            // app_planes[0..2], app_lines[0..2]
};

__device__ __forceinline__ int plane_axis_a(int m) { return m == 0 ? 1 : 0; }
__device__ __forceinline__ int plane_axis_b(int m) { return m == 2 ? 1 : 2; }

__device__ float decode_elem(const FactorDesc& d, int row, int col) {
  col = min(max(col, 0), d.ncols - 1);   // window origins come from callers
  if (d.fmt == kDense) {
    return __ldg(static_cast<const float*>(d.a) +
                 static_cast<long long>(row) * d.ncols + col);
  }
  if (d.fmt == kBitmap) {
    const long long off = static_cast<long long>(row) * d.nwords + (col >> 5);
    const unsigned bi = static_cast<unsigned>(col) & 31u;
    const uint32_t w = __ldg(static_cast<const uint32_t*>(d.a) + off);
    if (!((w >> bi) & 1u)) return 0.0f;
    int addr = __ldg(static_cast<const int*>(d.b) + off) +
               __popc(w & ((1u << bi) - 1u));
    addr = min(max(addr, 0), d.n - 1);
    return __ldg(static_cast<const float*>(d.c) + addr);
  }
  const int* coords = static_cast<const int*>(d.a);
  const int q = row * d.ncols + col;
  int lo = 0, hi = d.n;
  for (int s = 0; s < d.steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const bool right = __ldg(coords + min(mid, d.n - 1)) < q;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  const int safe = min(lo, d.n - 1);
  if (lo < d.n && __ldg(coords + safe) == q)
    return __ldg(static_cast<const float*>(d.b) + safe);
  return 0.0f;
}

__global__ void fused_decode_kernel(FieldDesc fd, const int* __restrict__ base,
                                    int C, int G, int W, int Rs, int Rc,
                                    float* __restrict__ pwin,
                                    float* __restrict__ lwin) {
  const int R = Rs + Rc;
  const long long nplane = static_cast<long long>(C) * 3 * W * W * R;
  const long long nline = static_cast<long long>(C) * 3 * W * R;
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < nplane) {
    const int r = static_cast<int>(e % R);
    long long t = e / R;
    const int cell = static_cast<int>(t % (W * W));
    t /= W * W;
    const int m = static_cast<int>(t % 3);
    const int c = static_cast<int>(t / 3);
    const int i = cell / W, j = cell % W;
    const int col = (base[c * 3 + plane_axis_a(m)] + i) * G +
                    base[c * 3 + plane_axis_b(m)] + j;
    pwin[e] = r < Rs ? decode_elem(fd.f[m], r, col)
                     : decode_elem(fd.f[6 + m], r - Rs, col);
  } else if (e < nplane + nline) {
    e -= nplane;
    const int r = static_cast<int>(e % R);
    long long t = e / R;
    const int i = static_cast<int>(t % W);
    t /= W;
    const int m = static_cast<int>(t % 3);
    const int c = static_cast<int>(t / 3);
    const int col = base[c * 3 + m] + i;
    lwin[e] = r < Rs ? decode_elem(fd.f[3 + m], r, col)
                     : decode_elem(fd.f[9 + m], r - Rs, col);
  }
}

__global__ void fused_sample_kernel(
    const float* __restrict__ pts, const int* __restrict__ cid,
    const int* __restrict__ base, int N, int C, int G, int W, int Rs, int Rc,
    int app_dim, float scene_bound, const float* __restrict__ basis,
    const float* __restrict__ pwin, const float* __restrict__ lwin,
    float* __restrict__ out_sig, float* __restrict__ out_feat) {
  extern __shared__ float s_basis[];   // (3 * Rc, app_dim)
  for (int k = threadIdx.x; k < 3 * Rc * app_dim; k += blockDim.x)
    s_basis[k] = basis[k];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  const int R = Rs + Rc;
  const int c = min(max(cid[n], 0), C - 1);
  float fr[3];
  int loc[3];
  for (int d = 0; d < 3; ++d) {
    float g = (pts[n * 3 + d] / scene_bound * 0.5f + 0.5f) *
              static_cast<float>(G - 1);
    g = fminf(fmaxf(g, 0.0f), static_cast<float>(G - 1));
    const int g0 = min(max(static_cast<int>(floorf(g)), 0), G - 2);
    fr[d] = g - static_cast<float>(g0);
    loc[d] = min(max(g0 - base[c * 3 + d], 0), W - 2);
  }

  float sig = 0.0f;
  float acc[kMaxAppDim];
#pragma unroll
  for (int k = 0; k < kMaxAppDim; ++k) acc[k] = 0.0f;

  for (int m = 0; m < 3; ++m) {
    const int a = plane_axis_a(m), b = plane_axis_b(m);
    const float fu = fr[a], fv = fr[b], fx = fr[m];
    const float w00 = (1.0f - fu) * (1.0f - fv), w01 = (1.0f - fu) * fv;
    const float w10 = fu * (1.0f - fv), w11 = fu * fv;
    const float* p00 = pwin +
        ((static_cast<long long>(c) * 3 + m) * W * W + loc[a] * W + loc[b]) * R;
    const float* p01 = p00 + R;
    const float* p10 = p00 + W * R;
    const float* p11 = p10 + R;
    const float* l0 = lwin + ((static_cast<long long>(c) * 3 + m) * W + loc[m]) * R;
    const float* l1 = l0 + R;
    for (int r = 0; r < R; ++r) {
      const float pm = p00[r] * w00 + p01[r] * w01 + p10[r] * w10 + p11[r] * w11;
      const float lm = l0[r] * (1.0f - fx) + l1[r] * fx;
      const float comp = pm * lm;
      if (r < Rs) {
        sig += comp;
      } else {
        const float* brow = s_basis + (m * Rc + (r - Rs)) * app_dim;
#pragma unroll
        for (int k = 0; k < kMaxAppDim; ++k)
          if (k < app_dim) acc[k] += comp * brow[k];
      }
    }
  }
  out_sig[n] = sig;
#pragma unroll
  for (int k = 0; k < kMaxAppDim; ++k)
    if (k < app_dim) out_feat[static_cast<long long>(n) * app_dim + k] = acc[k];
}

}  // namespace

// desc: 12 x 9 int64 per factor slice, in FieldDesc order:
// fmt, rows, ncols, nwords, n, steps, ptr a, ptr b, ptr c.
extern "C" int fused_sigma_app_launch(
    const long long* desc, const void* pts, const void* cid, const void* base,
    const void* basis, int N, int C, int G, int W, int Rs, int Rc,
    int app_dim, float scene_bound, void* pwin, void* lwin, void* out_sig,
    void* out_feat, void* stream) {
  if (app_dim > kMaxAppDim) return static_cast<int>(cudaErrorInvalidValue);
  FieldDesc fd;
  for (int f = 0; f < kFactors; ++f) {
    const long long* d = desc + f * 9;
    fd.f[f].fmt = static_cast<int>(d[0]);
    fd.f[f].rows = static_cast<int>(d[1]);
    fd.f[f].ncols = static_cast<int>(d[2]);
    fd.f[f].nwords = static_cast<int>(d[3]);
    fd.f[f].n = static_cast<int>(d[4]);
    fd.f[f].steps = static_cast<int>(d[5]);
    fd.f[f].a = reinterpret_cast<const void*>(d[6]);
    fd.f[f].b = reinterpret_cast<const void*>(d[7]);
    fd.f[f].c = reinterpret_cast<const void*>(d[8]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = Rs + Rc;
  const long long nwin = static_cast<long long>(C) * 3 * (W * W + W) * R;
  const int threads = 256;
  if (nwin > 0) {
    fused_decode_kernel<<<static_cast<unsigned>((nwin + threads - 1) / threads),
                          threads, 0, s>>>(
        fd, static_cast<const int*>(base), C, G, W, Rs, Rc,
        static_cast<float*>(pwin), static_cast<float*>(lwin));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    const size_t smem = static_cast<size_t>(3) * Rc * app_dim * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    fused_sample_kernel<<<(N + threads - 1) / threads, threads, smem, s>>>(
        static_cast<const float*>(pts), static_cast<const int*>(cid),
        static_cast<const int*>(base), N, C, G, W, Rs, Rc, app_dim,
        scene_bound, static_cast<const float*>(basis),
        static_cast<const float*>(pwin), static_cast<const float*>(lwin),
        static_cast<float*>(out_sig), static_cast<float*>(out_feat));
  }
  return static_cast<int>(cudaGetLastError());
}
