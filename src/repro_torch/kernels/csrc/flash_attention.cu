// Flash attention, forward: o = softmax(q k^T / sqrt(D), masked) v for
// q (B, H, Sq, D), k and v (B, H, Sk, D), in float32 or bfloat16, with
// an fp32 online softmax. When causal, query i sees the keys j <= i (the
// mask is aligned at the top left); masked scores are -1e30, and the
// output is acc / max(l, 1e-30).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (Pallas body `_kernel`): grid (B*H, q blocks, kv
// blocks) of 128 x 128 tiles, the running (m, l, acc) of a q block in
// VMEM scratch across the sequential kv axis, kv blocks above the
// diagonal skipped.
//
// Bound on Hopper: operations. 4 * Sq * Sk * D flops per head (half of
// that when causal) against 4 * S * D values read or written; at S = 4096,
// D = 64 that is about 500 flops per byte.
//
// Design, simple and correct first (tensor cores and TMA come later):
// one CTA of 256 threads per (64-row q block, b*h); the kv axis is a loop
// inside the CTA, so (m, l, acc) live in registers for the whole row
// block. Q, K and V tiles are staged in shared memory as fp32 (Q and K
// transposed, d-major, so a thread reads four rows or four keys as one
// float4); D is padded with zeros to DP = 64 or 128, which puts the
// tiles above 48 KB (each launch raises the dynamic shared-memory limit).
// Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 block of scores (rows
// 4ty.., keys 4tx..) and, for P V, rows 4ty.. by columns 64h + 4tx..; the
// row max and sum of the online softmax are shuffles across the 16 tx
// lanes, and P goes through shared memory to the P V product. Products
// are fp32 FMAs on the CUDA cores. Causal kv tiles above the diagonal are
// skipped, and the q blocks with the most tiles start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;                      // q rows per CTA
constexpr int kBK = 64;                      // keys per kv tile
constexpr int kThreads = 256;
constexpr int kStride = kBQ + 4;             // padded row of Qt, Kt and P
constexpr float kNegInf = -1e30f;            // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * kStride + kBK * DP + kBQ * kStride);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int D, float scale, int causal) {
  constexpr int kCols = DP / 16;             // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // (DP, kStride) d-major
  float* Kt = Qt + DP * kStride;                 // (DP, kStride) d-major
  float* Vs = Kt + DP * kStride;                 // (kBK, DP)
  float* Ps = Vs + kBK * DP;                     // (kBQ, kStride)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long bh = blockIdx.y;
  const T* qh = q + bh * Sq * D;
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int row = e / DP, d = e % DP;
    Qt[d * kStride + row] = (q0 + row < Sq && d < D)
        ? to_f32(qh[static_cast<long long>(q0 + row) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                         // the last tile's readers
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int row = e / DP, d = e % DP;
      const bool ok = k0 + row < Sk && d < D;
      const long long off = static_cast<long long>(k0 + row) * D + d;
      Kt[d * kStride + row] = ok ? to_f32(kh[off]) : 0.0f;
      Vs[row * DP + d] = ok ? to_f32(vh[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kStride + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * kStride + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar = component(a, r);
        s[r][0] += ar * b.x;
        s[r][1] += ar * b.y;
        s[r][2] += ar * b.z;
        s[r][3] += ar * b.w;
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 4 * tx + c;
        float x = s[r][c] * scale;
        if (kj >= Sk) x = -CUDART_INF_F;     // past the keys: weight 0
        else if (causal && kj > qi) x = kNegInf;
        s[r][c] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[r], group16_max(tile_max));
      const float corr = expf(m[r] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        row_sum += s[r][c];
      }
      l[r] = l[r] * corr + group16_sum(row_sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      *reinterpret_cast<float4*>(Ps + (4 * ty + r) * kStride + 4 * tx) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[r] = *reinterpret_cast<const float4*>(Ps + (4 * ty + r) * kStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * DP;
#pragma unroll
        for (int h = 0; h < DP / 64; ++h) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + 64 * h + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pr = component(p[r], jj);
            acc[r][4 * h] += pr * w.x;
            acc[r][4 * h + 1] += pr * w.y;
            acc[r][4 * h + 2] += pr * w.z;
            acc[r][4 * h + 3] += pr * w.w;
          }
        }
      }
    }
  }

  T* oh = o + bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * h + 4 * tx + c;
        if (col < D)
          store(oh + static_cast<long long>(qi) * D + col,
                acc[r][4 * h + c] / denom);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  // the limit holds per device: raise it on every launch, whichever
  // device is current
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 0 for float32, 1 for bfloat16. D <= 128; BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Sk, int D, float scale, int causal,
                                      int bf16, void* stream) {
  if (BH > 0 && Sq > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
      return D <= 64
          ? launch<__nv_bfloat16, 64>(q, k, v, o, BH, Sq, Sk, D, scale,
                                      causal, s)
          : launch<__nv_bfloat16, 128>(q, k, v, o, BH, Sq, Sk, D, scale,
                                       causal, s);
    return D <= 64
        ? launch<float, 64>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s)
        : launch<float, 128>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(cudaGetLastError());
}
