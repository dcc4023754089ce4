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
// D = 64 that is about 500 flops per byte (B 1, H 32, causal: 68.7 GFLOP).
// fp32 at fp32's precision: 1.03 ms on the CUDA cores (67 TFLOP/s), or
// 0.417 ms as three TF32 products on the tensor cores (3 x 68.7 GFLOP at
// 495 TFLOP/s), the route this kernel takes; bf16: 0.069 ms at 989 TFLOP/s.
//
// Both kernels: the kv axis is a loop inside the CTA, so (m, l, acc) live
// in registers for the whole row block; D is padded with zeros to DP = 64
// or 128 in shared memory; causal kv tiles above the diagonal are skipped,
// and the q blocks with the most tiles start first.
//
// float32 (flash_f32_kernel): both products on the tensor cores as 3xTF32
// wgmma (m64nNk8, fp32 accumulate): each operand is split into a TF32 hi
// part (cut by truncation) and lo = x - hi, and hi*hi + hi*lo + lo*hi
// keeps about fp32's precision (one TF32 product is off by up to 2^-11 of
// each term, far above the 1e-4 tolerance). Two warpgroups per CTA, 64 q
// rows each; Q is split once into hi and lo tiles in shared memory. K and
// V tiles (64 keys at DP 64, 32 at DP 128) arrive raw by TMA into a ring
// (two stages at DP 64, one at DP 128; cp.async where D * 4 bytes is not
// a multiple of 16 or a pointer is off 16 bytes). Since tf32 wgmma reads
// only K-major operands, the threads split K into hi and lo tiles and
// transpose V into hi and lo tiles of V^T; at DP 64 they do so for tile
// kt + 1, into the second of two V^T buffers, while tile kt's P V wgmmas
// run. P stays in registers as the A operand of O += P V: its k8 fragment
// takes the accumulator's columns (2c, 2c + 1) as positions (c, c + 4),
// and V^T is written with its keys permuted to match.
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

constexpr float kNegInf = -1e30f;            // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------- fp32 ---
// 3xTF32 wgmma on the tensor cores: each operand x is split into hi (x cut
// to TF32's 10 mantissa bits) and lo = x - hi, and a product is hi*hi +
// hi*lo + lo*hi in fp32 accumulation, about fp32's precision (the dropped
// lo*lo and lo's own truncation leave an error near 2^-21 of each term).
// TF32 wgmma takes only K-major operands from shared memory, so the V tile
// is transposed there by the threads.

constexpr int kF32BQ = 128;                  // q rows per CTA: 64 per warpgroup
constexpr int kF32Threads = 256;             // two consumer warpgroups
constexpr int kF32BK64 = 64;                 // keys per kv tile at DP = 64
constexpr int kF32BK128 = 32;                // keys per kv tile at DP = 128
constexpr int kF32Raw64 = 2;                 // raw K/V stages at DP = 64
constexpr int kF32Raw128 = 1;                // raw K/V stages at DP = 128
constexpr int kF32Vt64 = 2;                  // V^T work buffers at DP = 64
constexpr int kF32Vt128 = 1;                 // V^T work buffers at DP = 128
constexpr int kF32Bars = 64;                 // bytes for the stages' mbarriers

template <int DP>
__host__ __device__ constexpr int f32_bk() {
  return DP == 64 ? kF32BK64 : kF32BK128;
}
template <int DP>
__host__ __device__ constexpr int f32_raw() {
  return DP == 64 ? kF32Raw64 : kF32Raw128;
}
template <int DP>
__host__ __device__ constexpr int f32_vt() {
  return DP == 64 ? kF32Vt64 : kF32Vt128;
}
template <int DP>
__host__ __device__ constexpr int f32_smem_bytes() {
  // Q hi + lo, the work tiles (K hi + lo, each V^T buffer hi + lo), the
  // raw K/V ring, the mbarriers, and room to align to 1024
  return 2 * kF32BQ * DP * 4 + (2 + 2 * f32_vt<DP>()) * f32_bk<DP>() * DP * 4 +
         f32_raw<DP>() * 2 * f32_bk<DP>() * DP * 4 + kF32Bars + 1024;
}

// rows x DP fp32 tile in shared memory: DP / 32 panels of rows x 128 bytes,
// each 16-byte chunk of a row at chunk ^ (row % 8) (TMA's SWIZZLE_128B, the
// layout wgmma's 128-byte-swizzle descriptors read)
__device__ __forceinline__ uint32_t swizzled32(int row, int col, int rows) {
  return static_cast<uint32_t>((col >> 5) * rows * 128 + row * 128 +
                               ((((col & 31) >> 2) ^ (row & 7)) << 4) +
                               (col & 3) * 4);
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// keeps A fragments in their registers up to this point (an async wgmma
// reads them until its wait)
template <int J>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[j][r])::"memory");
}

// wgmma with every accumulator register named (generated: m64nNk8, tf32
// in, fp32 accumulate; ss = both operands from shared memory, rs = A from
// registers; both K-major, the only layout tf32 takes)
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void f32_qk(float (&s)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void f32_qk<64>(float (&s)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  wgmma_tf32_ss_n64(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void f32_qk<32>(float (&s)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  wgmma_tf32_ss_n32(s, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void f32_pv(float (&o)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void f32_pv<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  wgmma_tf32_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void f32_pv<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_tf32_rs_n128(o, a, db);
}

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int Sq, Sk, D, causal;
  float scale_log2;                          // scale * log2(e)
};

// The raw K or V tile of keys row0.. by threads, for rows TMA cannot take
// (D * 4 bytes not a multiple of 16, or a pointer off 16 bytes): 4-byte
// cp.async with zero fill past Sk, into TMA's swizzled layout. Columns at
// or past D are left as they are: the split never reads them.
template <int DP>
__device__ __forceinline__ void f32_thread_tile(uint8_t* dst, const float* src,
                                                int row0, int S, int D,
                                                int rows, int tid) {
  for (int e = tid; e < rows * DP; e += kF32Threads) {
    const int row = e / DP, col = e % DP;
    if (col >= D) continue;
    const bool ok = row0 + row < S;
    const float* at = ok ? src + static_cast<long long>(row0 + row) * D + col
                         : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst + swizzled32(row, col, rows))),
                 "l"(at), "r"(ok ? 4 : 0) : "memory");
  }
}

// Thread t of warpgroup wg holds, of each 64-row accumulator, rows
// r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8, columns 8 j + 2 (t % 4) +
// {0, 1} (register 4 j + {0, 1} on row r0, 4 j + {2, 3} on row r0 + 8).
// The tf32 A fragment of a k8 step holds (r0, c), (r0 + 8, c), (r0, c + 4),
// (r0 + 8, c + 4) for c = t % 4: the same rows, other columns. So P stays
// in registers, its keys permuted within each group of 8 (position c holds
// key 2 c, position c + 4 key 2 c + 1), and V^T is written with the same
// permutation when it is transposed, which leaves the sum over keys as it
// was.
template <int DP, bool kTma>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, F32Args a) {
  constexpr int BK = f32_bk<DP>();
  constexpr int NR = f32_raw<DP>();
  constexpr int NV = f32_vt<DP>();
  constexpr int NS = BK / 2;                 // S registers per thread
  constexpr int NO = DP / 2;                 // O registers per thread
  constexpr int kTile = BK * DP * 4;         // one K or V tile, bytes
  constexpr int kQTile = kF32BQ * DP * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qhi = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const Qlo = Qhi + kQTile;
  uint8_t* const Khi = Qlo + kQTile;         // (BK, DP) K-major
  uint8_t* const Klo = Khi + kTile;
  uint8_t* const Vt = Klo + kTile;           // NV x (hi, lo) (DP, BK) V^T
  uint8_t* const ring = Vt + NV * 2 * kTile; // raw stage: K, then V
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ring + NR * 2 * kTile);
  const uint32_t full0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  const int lane = t & 31;
  // heads along x, q blocks along y from the last (most causal tiles) to
  // the first: every head's heaviest blocks start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BQ;
  const int bh = blockIdx.x;
  const long long qoff = static_cast<long long>(bh) * a.Sq * a.D;
  const long long koff = static_cast<long long>(bh) * a.Sk * a.D;
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + kF32BQ - 1) / BK + 1);
  const int panels = (a.D + 31) >> 5;        // 32-column panels holding D

  // raw K and V of tile kt into its stage: TMA by one thread on the
  // stage's mbarrier (only the panels that hold columns of D), or by all
  // threads with cp.async (one commit group a tile, empty past the last)
  auto load_raw = [&](int kt) {
    uint8_t* Kr = ring + (kt % NR) * 2 * kTile;
    if constexpr (kTma) {
      if (tid == 0 && kt < n_tiles) {
        const uint32_t bar = full0 + 8 * (kt % NR);
        mbar_expect_tx(bar, 2 * panels * BK * 128);
        for (int p = 0; p < panels; ++p) {
          tma_load(smem_u32(Kr + p * BK * 128), &tk, bar, 32 * p, kt * BK,
                   bh);
          tma_load(smem_u32(Kr + kTile + p * BK * 128), &tv, bar, 32 * p,
                   kt * BK, bh);
        }
      }
    } else {
      if (kt < n_tiles) {
        f32_thread_tile<DP>(Kr, a.k + koff, kt * BK, a.Sk, a.D, BK, tid);
        f32_thread_tile<DP>(Kr + kTile, a.v + koff, kt * BK, a.Sk, a.D, BK,
                            tid);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  auto wait_raw = [&](int kt) {
    if constexpr (kTma) {
      mbar_wait(full0 + 8 * (kt % NR), (kt / NR) & 1);
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NR - 1) : "memory");
    }
  };

  // the raw tile kt into the work tiles: K split in place of layout (the
  // raw and work tiles share it), V transposed into V^T buffer kt % NV;
  // both zero at and past D. The caller makes the raw tile visible first.
  // Straight-line code (fixed trip counts, selects): it runs while P V
  // wgmmas are in flight, which ptxas keeps asynchronous only outside
  // divergent paths.
  static_assert(kTile / 16 % kF32Threads == 0, "whole K chunks a thread");
  static_assert(DP * BK / 4 % kF32Threads == 0, "whole V^T tasks a thread");
  auto split = [&](int kt) {
    const uint8_t* Kr = ring + (kt % NR) * 2 * kTile;
    const uint8_t* Vr = Kr + kTile;
#pragma unroll 1   // ptxas (CUDA 12.8) crashes on the unrolled loops
    for (int i = 0; i < kTile / 16 / kF32Threads; ++i) {
      const int c = tid + i * kF32Threads;
      const int row = (c >> 3) % BK;
      const int col = ((c / (BK * 8)) << 5) + (((c & 7) ^ (row & 7)) << 2);
      float4 x = *reinterpret_cast<const float4*>(Kr + 16 * c);
      x.x = col < a.D ? x.x : 0.0f;
      x.y = col + 1 < a.D ? x.y : 0.0f;
      x.z = col + 2 < a.D ? x.z : 0.0f;
      x.w = col + 3 < a.D ? x.w : 0.0f;
      const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                   tf32_hi(x.w));
      *reinterpret_cast<float4*>(Khi + 16 * c) = h;
      *reinterpret_cast<float4*>(Klo + 16 * c) =
          make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
    }
    // V^T: position 8 j + 4 half + i holds key 8 j + 2 i + half; a lane
    // per column d (a warp reads one 128-byte row of the raw tile, and its
    // 16-byte stores fall on 8 distinct chunks of each 8-row group). Task
    // n of a thread is column d = tid % DP of position block pb = tid / DP
    // + n * kF32Threads / DP, so d, half = pb % 2 and the swizzled chunk
    // of each of its 4 keys (row % 8 = half + 2 i) stay fixed: only the
    // key group j moves.
    static_assert(kF32Threads % DP == 0 && kF32Threads / DP % 2 == 0,
                  "a thread keeps its column and half");
    uint8_t* const Vhi = Vt + (kt % NV) * 2 * kTile;
    uint8_t* const Vlo = Vhi + kTile;
    const int d = tid % DP, half = (tid / DP) & 1;
    const bool d_in = d < a.D;
    const uint8_t* const vsrc = Vr + (d >> 5) * BK * 128 + (d & 3) * 4 +
                                half * 128;
    uint32_t chunk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      chunk[i] = 2 * i * 128 + ((((d & 31) >> 2) ^ (half + 2 * i)) << 4);
#pragma unroll 1
    for (int n = 0; n < DP * BK / 4 / kF32Threads; ++n) {
      const int pb = tid / DP + n * (kF32Threads / DP);
      const uint8_t* const src = vsrc + (pb >> 1) * 8 * 128;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const float*>(src + chunk[i]);
        x[i] = d_in ? x[i] : 0.0f;
      }
      const float4 h = make_float4(tf32_hi(x[0]), tf32_hi(x[1]),
                                   tf32_hi(x[2]), tf32_hi(x[3]));
      const uint32_t at = (pb >> 3) * DP * 128 + d * 128 +
                          (((pb & 7) ^ (d & 7)) << 4);
      *reinterpret_cast<float4*>(Vhi + at) = h;
      *reinterpret_cast<float4*>(Vlo + at) = make_float4(
          x[0] - h.x, x[1] - h.y, x[2] - h.z, x[3] - h.w);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i < NR; ++i) mbar_init(smem_u32(bars + i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();                         // the barriers are set up
  }
  for (int kt = 0; kt < NR; ++kt) load_raw(kt);
  // Q by the threads, split into hi and lo, zero past Sq and D
  for (int e = tid; e < kF32BQ * DP; e += kF32Threads) {
    const int row = e / DP, col = e % DP;
    const float x = (q0 + row < a.Sq && col < a.D)
        ? __ldg(a.q + qoff + static_cast<long long>(q0 + row) * a.D + col)
        : 0.0f;
    const float hi = tf32_hi(x);
    const uint32_t at = swizzled32(row, col, kF32BQ);
    *reinterpret_cast<float*>(Qhi + at) = hi;
    *reinterpret_cast<float*>(Qlo + at) = x - hi;
  }
  wait_raw(0);
  __syncthreads();                           // raw tile 0 in, Q written
  split(0);
  __syncthreads();                           // work tiles of tile 0 written
  load_raw(NR);

  const int r0 = q0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  const uint32_t qhi_at = smem_u32(Qhi) + wg * 64 * 128;
  const uint32_t qlo_at = smem_u32(Qlo) + wg * 64 * 128;
  const uint32_t khi_at = smem_u32(Khi), klo_at = smem_u32(Klo);

  // Tile kt's products run while the threads split tile kt + 1: with two
  // V^T buffers (NV 2) the split runs under tile kt's P V wgmmas; with one
  // it waits for them. A warpgroup also runs a tile wholly above its
  // diagonal (its weights are 0), so that no wgmma sits on a divergent
  // path.
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const uint32_t vhi_at = smem_u32(Vt + (kt % NV) * 2 * kTile);
    const uint32_t vlo_at = vhi_at + kTile;
    if constexpr (NV == 2) {
      if (kt + 1 < n_tiles) wait_raw(kt + 1);
    }
    uint32_t hi[BK / 8][4], lo[BK / 8][4];   // P, the A of the P V wgmmas
    // S = Q K^T, 3xTF32: A = Q rows of this warpgroup, B = the K tile,
    // both K-major; 8 d per step, 32 bytes along a swizzled row
    float sc[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t qs = (kk >> 2) * kF32BQ * 128 + (kk & 3) * 32;
      const uint32_t ks = (kk >> 2) * BK * 128 + (kk & 3) * 32;
      const uint64_t kh = make_desc(khi_at + ks, 16, 1024);
      const uint64_t kl = make_desc(klo_at + ks, 16, 1024);
      f32_qk<BK>(sc, make_desc(qhi_at + qs, 16, 1024), kh, kk > 0);
      f32_qk<BK>(sc, make_desc(qhi_at + qs, 16, 1024), kl, 1);
      f32_qk<BK>(sc, make_desc(qlo_at + qs, 16, 1024), kh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in the log2 domain, on the accumulator fragment; a
    // tile that crosses the diagonal or the last key is scaled and
    // masked first, any other is scaled inside the exponent
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

    // O += P V, 3xTF32: A = P in registers (hi and lo), its k8 step j
    // from registers 4 j + {0, 2, 1, 3}; B = the permuted V^T tile
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[4 * j + ((r & 1) << 1) + (r >> 1)];
        const float h = tf32_hi(x);
        hi[j][r] = __float_as_uint(h);
        lo[j][r] = __float_as_uint(x - h);
      }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t vs = (j >> 2) * DP * 128 + (j & 3) * 32;
      const uint64_t vh = make_desc(vhi_at + vs, 16, 1024);
      f32_pv<DP>(o, hi[j], vh);
      f32_pv<DP>(o, hi[j], make_desc(vlo_at + vs, 16, 1024));
      f32_pv<DP>(o, lo[j], vh);
    }
    wgmma_commit();
    if constexpr (NV == 1) {
      wgmma_wait_all();
      fence_regs(o);
      if (kt + 1 < n_tiles) wait_raw(kt + 1);
    }
    __syncthreads();             // S of tile kt done (K free), P V of kt - 1
                                 // done (its V^T free), raw tile kt + 1 in
    split(kt + 1);               // past the last tile: into free buffers
    if constexpr (NV == 2) {
      wgmma_wait_all();
      fence_regs(o);
      fence_frags(hi);                       // A stays put until here
      fence_frags(lo);
    }
    __syncthreads();             // tile kt + 1's work tiles written, its
                                 // raw stage read
    load_raw(kt + 1 + NR);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    inv[h] = 1.0f / fmaxf(l[h], 1e-30f);
  }
  float* oh = a.o + qoff;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = r0 + 8 * h, col = 8 * (i >> 2) + c0;
    if (row >= a.Sq || col >= a.D) continue;
    float* dst = oh + static_cast<long long>(row) * a.D + col;
    const float x = o[i] * inv[h], y = o[i + 1] * inv[h];
    if ((a.D & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(x, y);
    } else {
      dst[0] = x;
      if (col + 1 < a.D) dst[1] = y;
    }
  }
}

// (D, S, BH) fp32, boxes of 32 columns x rows, 128-byte swizzle, zero fill
bool encode_map_f32(CUtensorMap* map, const void* ptr, int BH, int S, int D,
                    int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(S) * D * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool kTma>
int launch_f32_as(const CUtensorMap& tk, const CUtensorMap& tv,
                  const F32Args& a, int BH, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.Sq + kF32BQ - 1) / kF32BQ);
  flash_f32_kernel<DP, kTma><<<grid, kF32Threads, smem, stream>>>(tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int Sq, int Sk, int D, float scale, int causal,
               cudaStream_t stream) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), Sq,
                  Sk, D, causal, scale * kLog2e};
  CUtensorMap tk, tv;
  const auto aligned = [D](const void* p) {
    return D % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (aligned(k) && aligned(v)) {
    if (!encode_map_f32(&tk, k, BH, Sk, D, f32_bk<DP>()) ||
        !encode_map_f32(&tv, v, BH, Sk, D, f32_bk<DP>()))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32_as<DP, true>(tk, tv, a, BH, stream);
  }
  memset(&tk, 0, sizeof(tk));
  return launch_f32_as<DP, false>(tk, tk, a, BH, stream);
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
        ? launch_f32<64>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s)
        : launch_f32<128>(q, k, v, o, BH, Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(cudaGetLastError());
}
