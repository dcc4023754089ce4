// Flash attention, forward: o = softmax(q k^T / sqrt(D), masked) v for
// q (B, H, Sq, D), k and v (B, H, Sk, D), in float32 or bfloat16, with
// an fp32 online softmax. When causal, query i sees the keys j <= i (the
// mask is aligned at the top left); masked scores are -1e30, keys past Sk
// weigh 0, and the output is acc / max(l, 1e-30).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (Pallas body `_kernel`): grid (B*H, q blocks, kv
// blocks) of 128 x 128 tiles, the running (m, l, acc) of a q block in
// VMEM scratch across the sequential kv axis, kv blocks above the
// diagonal skipped.
//
// Bound on Hopper: operations. 4 * Sq * Sk * D flops per head (half of
// that when causal) against 4 * S * D values read or written; at S = 4096,
// D = 64 that is about 500 flops per byte: 1.03 ms at the fp32 peak, 0.069
// ms at the bf16 tensor-core peak (B 1, H 32, causal).
//
// Both kernels: the kv axis is a loop inside the CTA, so (m, l, acc) live
// in registers for the whole row block; D is padded with zeros to DP = 64
// or 128 in shared memory; causal kv tiles above the diagonal are skipped,
// and the q blocks with the most tiles start first.
//
// float32 (flash_attention_kernel): fp32 FMAs on the CUDA cores (TF32
// would not hold the fp32 tolerance). One CTA of 256 threads per (64-row
// q block, b*h); Q, K and V tiles in shared memory as fp32 (Q and K
// transposed, d-major, so a thread reads four rows or four keys as one
// float4). Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 block of scores
// and, for P V, rows 4ty.. by columns 64h + 4tx..; the row max and sum are
// shuffles across the 16 tx lanes, and P goes through shared memory.
//
// bfloat16 (flash_bf16_kernel): both products on the tensor cores with
// wgmma (m64nNk16, fp32 accumulate). Two warpgroups per CTA, 64 q rows
// each (128 per CTA). S = Q K^T reads Q and a K tile from shared memory
// (both K-major); the online softmax runs in fp32 on the accumulator
// fragment; P stays in registers as the A operand of O += P V, whose B is
// the V tile read MN-major (no transposed copy). P goes in as bf16 hi and
// lo parts, two wgmmas, to hold the fp32 P V of the reference within the
// bf16 limit (one bf16 P is off by up to 2^-9 of |v| where a row sees few
// keys). K and V tiles (128 keys at DP 64, 64 at DP 128) arrive by TMA
// from a 3-D tensor map (D, S, B*H), which zero-fills past D and past Sk
// within each head, into a ring of three stages with an mbarrier each;
// the warpgroups do not wait for each other: the second one done with a
// stage refills it, so one warpgroup's softmax runs under the other's
// wgmmas and the loads run two tiles ahead. Rows TMA cannot take (D * 2
// bytes not a multiple of 16, or a pointer off 16 bytes) are staged by the
// threads instead, cp.async with zero fill, in the same swizzled layout.
#include <cstdint>
#include <cstring>
#include <cuda.h>
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// wgmma with every accumulator register named (generated: m64nNk16,
// bf16 in, fp32 accumulate; ss = both operands from shared memory, rs =
// A from registers, B MN-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// ---------------------------------------------------------------- bf16 ---
// wgmma on the tensor cores; tiles staged by TMA (or cp.async) in shared
// memory with the 128-byte swizzle that wgmma's descriptors name.

constexpr int kWgBQ = 128;                   // q rows per CTA: 64 per warpgroup
constexpr int kWgThreads = 256;              // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// rows x DP bf16 tile in shared memory: DP / 64 panels of rows x 128 bytes,
// each 16-byte chunk of a row at chunk ^ (row % 8) (TMA's SWIZZLE_128B)
__host__ __device__ constexpr int tile_bytes(int rows, int dp) {
  return rows * dp * 2;
}

__device__ __forceinline__ uint32_t swizzled(int row, int col, int rows) {
  return static_cast<uint32_t>((col >> 6) * rows * 128 + row * 128 +
                               ((((col & 63) >> 3) ^ (row & 7)) << 4) +
                               (col & 7) * 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// a copy that never lands traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long polls = 0; !done; ++polls) {
    if (polls == (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box of 64 columns x box rows of head bh, zero-filled past D and S
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh) : "memory");
}

template <int DP>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh,
                                         int rows) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
    tma_load(smem_u32(dst + p * rows * 128), map, bar, 64 * p, row, bh);
}

// The same tile by threads, for rows that TMA cannot take (D * 2 bytes not
// a multiple of 16, or a pointer off 16 bytes): 4-byte cp.async with zero
// fill where every pair of elements is 4-byte aligned, plain loads where
// not (odd D, or a pointer off 4 bytes).
template <int DP>
__device__ __forceinline__ void thread_tile(uint8_t* dst,
                                            const __nv_bfloat16* src, int row0,
                                            int S, int D, int rows, int tid) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const bool pairs = (D & 1) == 0 && reinterpret_cast<uintptr_t>(src) % 4 == 0;
  for (int e = tid; e < rows * (DP / 2); e += kWgThreads) {
    const int row = e / (DP / 2), col = 2 * (e % (DP / 2));
    const bool ok = row0 + row < S && col < D;
    const long long off = static_cast<long long>(row0 + row) * D + col;
    const uint32_t at = smem_u32(dst + swizzled(row, col, rows));
    if (pairs) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(at),
                   "l"(ok ? s + off : s), "r"(ok ? 4 : 0) : "memory");
    } else {
      const uint32_t lo = ok ? s[off] : 0u;
      const uint32_t hi = ok && col + 1 < D ? s[off + 1] : 0u;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(lo | (hi << 16))
                   : "memory");
    }
  }
}

// 2^x by the SFU (MUFU.EX2, about 2 ulp; subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(s, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

struct WgArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int Sq, Sk, D, causal;
  float scale_log2;                          // scale * log2(e)
};

// keys per kv tile: 128 at DP = 64, 64 at DP = 128 (the same registers)
template <int DP>
__host__ __device__ constexpr int wg_bk() { return DP == 64 ? 128 : 64; }
constexpr int kStages = 3;                   // K/V ring depth

template <int DP>
__host__ __device__ constexpr int wg_smem_bytes() {
  // Q, the K/V ring, mbarriers and counters, and room to align to 1024
  return tile_bytes(kWgBQ, DP) + 2 * kStages * tile_bytes(wg_bk<DP>(), DP) +
         128 + 1024;
}

// Thread t of warpgroup wg holds, of each 64-row wgmma accumulator, rows
// r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8 and columns
// 8 j + 2 (t % 4) + {0, 1}: register 4 j + {0, 1} on row r0, 4 j + {2, 3}
// on row r0 + 8. For 16-bit inputs that is also the register A layout of
// a k16 step, so P goes from the S accumulator to the P V wgmma in
// registers. P is split into bf16 hi + lo parts (two wgmmas), so the
// product keeps about 16 bits of each weight: one bf16 P drifts up to 2^-9
// of |v| from the fp32 P V of the reference, above the bf16 limit on rows
// that see few keys.
template <int DP, bool kTma>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, WgArgs a) {
  constexpr int BK = wg_bk<DP>();
  constexpr int NS = BK / 2;                 // S registers per thread
  constexpr int NO = DP / 2;                 // O registers per thread
  constexpr int kTile = tile_bytes(BK, DP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const ring = Qs + tile_bytes(kWgBQ, DP);   // stage: K, then V
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(ring + 2 * kStages * kTile);
  int* const done = reinterpret_cast<int*>(bars + 1 + kStages);
  const uint32_t q_bar = smem_u32(bars), full0 = smem_u32(bars + 1);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  const int lane = t & 31;
  // heads run along x, q blocks along y from the last (most causal
  // tiles) to the first: the block scheduler takes every head's heaviest
  // blocks first, and the light ones fill the tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  const int bh = blockIdx.x;
  const long long qoff = static_cast<long long>(bh) * a.Sq * a.D;
  const long long koff = static_cast<long long>(bh) * a.Sk * a.D;
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + kWgBQ - 1) / BK + 1);

  // K and V of tile kt into its stage: TMA by one thread on the stage's
  // mbarrier, or by all threads with cp.async
  auto load_kv = [&](int kt) {
    uint8_t* Ks = ring + (kt % kStages) * 2 * kTile;
    if constexpr (kTma) {
      const uint32_t bar = full0 + 8 * (kt % kStages);
      mbar_expect_tx(bar, 2 * kTile);
      tma_tile<DP>(Ks, &tk, bar, kt * BK, bh, BK);
      tma_tile<DP>(Ks + kTile, &tv, bar, kt * BK, bh, BK);
    } else {
      thread_tile<DP>(Ks, a.k + koff, kt * BK, a.Sk, a.D, BK, tid);
      thread_tile<DP>(Ks + kTile, a.v + koff, kt * BK, a.Sk, a.D, BK, tid);
    }
  };

  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(bars + i), 1);
      for (int i = 0; i < kStages; ++i) done[i] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(q_bar, tile_bytes(kWgBQ, DP));
      tma_tile<DP>(Qs, &tq, q_bar, q0, bh, kWgBQ);
      for (int kt = 0; kt < kStages && kt < n_tiles; ++kt) load_kv(kt);
    }
    __syncthreads();                         // the barriers are set up
    mbar_wait(q_bar, 0);
  } else {
    thread_tile<DP>(Qs, a.q + qoff, q0, a.Sq, a.D, kWgBQ, tid);
    for (int kt = 0; kt < kStages; ++kt) {
      if (kt < n_tiles) load_kv(kt);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  const int r0 = q0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  const uint32_t q_at = smem_u32(Qs) + wg * 64 * 128;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages, k0 = kt * BK;
    if constexpr (kTma) {
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    const uint32_t k_at = smem_u32(ring + s * 2 * kTile);
    const uint32_t v_at = k_at + kTile;

    // S = Q K^T: A = Q rows of this warpgroup, B = the K tile, both
    // K-major (d contiguous); 16 d per step, 32 bytes along a swizzled row
    float sc[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t panel = (kk >> 2), step = (kk & 3) * 32;
      wgmma_qk<BK>(sc,
                   make_desc(q_at + panel * kWgBQ * 128 + step, 16, 1024),
                   make_desc(k_at + panel * BK * 128 + step, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in the log2 domain, on the accumulator fragment. A
    // tile that crosses the diagonal or the last key is scaled and masked
    // first; any other tile is scaled inside the exponent (mul), as the
    // row max of raw scores times a positive scale is the scaled max.
    const bool edge = k0 + BK > a.Sk ||
                      (a.causal && k0 + BK - 1 > q0 + 64 * wg);
    const float mul = edge ? 1.0f : a.scale_log2;
    if (edge) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int row = r0 + ((i & 2) ? 8 : 0);
        float x = sc[i] * a.scale_log2;
        if (col >= a.Sk) x = -CUDART_INF_F;  // past the keys: weight 0
        else if (a.causal && col > row) x = kNegInf;
        sc[i] = x;
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * mul);
      corr[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = fast_exp2(fmaf(sc[i], mul, -m[h]));
      l[h] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: A = P in registers (hi and lo bf16 parts), B = the V
    // tile, MN-major (d contiguous): 16 keys per step (2048 bytes), DP / 64
    // panels apart
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
        hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[kk][r] = pack_bf16(x - __low2float(h2), y - __high2float(h2));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = make_desc(v_at + kk * 16 * 128, BK * 128, 1024);
      wgmma_pv<DP>(o, hi[kk], vd);
      wgmma_pv<DP>(o, lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    if constexpr (kTma) {
      // the second warpgroup done with stage s refills it
      if (t == 0 && atomicAdd(done + s, 1) == 1) {
        done[s] = 0;
        if (kt + kStages < n_tiles) load_kv(kt + kStages);
      }
    } else {
      __syncthreads();                       // both warpgroups done with s
      if (kt + kStages < n_tiles) load_kv(kt + kStages);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    inv[h] = 1.0f / fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* oh = a.o + qoff;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = r0 + 8 * h, col = 8 * (i >> 2) + c0;
    if (row >= a.Sq || col >= a.D) continue;
    __nv_bfloat16* dst = oh + static_cast<long long>(row) * a.D + col;
    const float x = o[i] * inv[h], y = o[i + 1] * inv[h];
    if ((a.D & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
    } else {
      dst[0] = __float2bfloat16(x);
      if (col + 1 < a.D) dst[1] = __float2bfloat16(y);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (D, S, BH) bf16, boxes of 64 columns x rows, 128-byte swizzle, zero fill
bool encode_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
                int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tma_ok(const void* p, int D) {
  return D % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int DP, bool kTma>
int launch_bf16_as(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const WgArgs& a, int BH,
                   cudaStream_t stream) {
  constexpr int smem = wg_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP, kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.Sq + kWgBQ - 1) / kWgBQ);
  flash_bf16_kernel<DP, kTma><<<grid, kWgThreads, smem, stream>>>(tq, tk, tv,
                                                                  a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int Sq, int Sk, int D, float scale, int causal,
                cudaStream_t stream) {
  const WgArgs a{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o), Sq, Sk, D, causal,
                 scale * kLog2e};
  CUtensorMap tq, tk, tv;
  if (tma_ok(q, D) && tma_ok(k, D) && tma_ok(v, D)) {
    if (!encode_map(&tq, q, BH, Sq, D, kWgBQ) ||
        !encode_map(&tk, k, BH, Sk, D, wg_bk<DP>()) ||
        !encode_map(&tv, v, BH, Sk, D, wg_bk<DP>()))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16_as<DP, true>(tq, tk, tv, a, BH, stream);
  }
  memset(&tq, 0, sizeof(tq));
  return launch_bf16_as<DP, false>(tq, tq, tq, a, BH, stream);
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
      return D <= 64 ? launch_bf16<64>(q, k, v, o, BH, Sq, Sk, D, scale,
                                       causal, s)
                     : launch_bf16<128>(q, k, v, o, BH, Sq, Sk, D, scale,
                                        causal, s);
    return D <= 64
        ? launch<float, 64>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s)
        : launch<float, 128>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(cudaGetLastError());
}
