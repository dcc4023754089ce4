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
// product, against about 130 bytes of point input and output: 0.018 ms
// for the serve step's 122,880 points.
//
// Design:
//  (a) fused_decode_kernel decodes every cube's windows once per call into
//      a scratch the wrapper allocates, one contiguous block per (cube,
//      mode): (W*W, R) plane cells and (W, R) line cells, R = Rs + Rc
//      channels per cell, so a stencil corner is one run of R floats.
//      Decoding inside each CTA instead would repeat a cube's decode (COO:
//      a binary search per element) in every CTA that holds its points.
//  (b) fused_sample_kernel gives a CTA 256 consecutive points, 32 a warp.
//      For each cube its points use and each mode, one thread brings that
//      (cube, mode) window (28 KB at full width) into shared memory with a
//      bulk copy on an mbarrier; each half-warp walks 16 consecutive points
//      (samples along a ray), 16 lanes on 4-channel runs of each stencil
//      row, and keeps the rows while the next point's cells stay the same;
//      it stages the appearance channels and the density channels' partial
//      sums; then each warp runs the basis product for its own 32 points
//      on the tensor cores, mma m16n8k8 in TF32 with each operand split
//      into hi + lo parts (3xTF32, about fp32's precision: TF32 alone would
//      not hold 1e-4), from the basis staged once per CTA. The next
//      window's copy runs under that product, and the sample kernel is a
//      programmatic dependent launch: its prologue runs under the decode
//      kernel's tail. Shared-memory reads of window rows (up to 1.5 KB per
//      point and mode) and the product's three mmas per tile take most of
//      the time.
//  Any order of cube_id is right (cubes are visited by least id); a tile
//  spanning k cubes stages k x 3 windows, and the serve step's order (two
//  ascending runs) gives one or two per tile. Shared memory grows with
//  W^2 R; the wrapper raises when one window does not fit.
// The reference's summation order differs (one matmul per mode), so the
// result agrees with the plain version to a tolerance, not bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFactors = 12;
constexpr int kMaxAppDim = 32;   // feat columns of the basis product
constexpr size_t kMaxSmemBytes = 232448;  // a block's opt-in limit, sm_90
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

// Decoded windows, one contiguous block per (cube, mode) so that one bulk
// copy moves it: plane cells (W*W, R) padded to kPlaneStride floats, line
// cells (W, R) padded to kLineStride (multiples of 4 floats, 16 bytes).
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__global__ void fused_decode_kernel(FieldDesc fd, const int* __restrict__ base,
                                    int C, int G, int W, int Rs, int Rc,
                                    float* __restrict__ pwin,
                                    float* __restrict__ lwin) {
  // the sample kernel may start its prologue now (it waits for this grid
  // before it reads the windows)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int R = Rs + Rc;
  const int PB = round4(W * W * R), LB = round4(W * R);
  const long long nplane = static_cast<long long>(C) * 3 * W * W * R;
  const long long nline = static_cast<long long>(C) * 3 * W * R;
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < nplane) {
    const int r = static_cast<int>(e % R);
    long long t = e / R;
    const int cell = static_cast<int>(t % (W * W));
    const long long cm = t / (W * W);        // c * 3 + m
    const int m = static_cast<int>(cm % 3);
    const int c = static_cast<int>(cm / 3);
    const int i = cell / W, j = cell % W;
    const int col = (base[c * 3 + plane_axis_a(m)] + i) * G +
                    base[c * 3 + plane_axis_b(m)] + j;
    pwin[cm * PB + cell * R + r] = r < Rs
        ? decode_elem(fd.f[m], r, col) : decode_elem(fd.f[6 + m], r - Rs, col);
  } else if (e < nplane + nline) {
    e -= nplane;
    const int r = static_cast<int>(e % R);
    long long t = e / R;
    const int i = static_cast<int>(t % W);
    const long long cm = t / W;
    const int m = static_cast<int>(cm % 3);
    const int c = static_cast<int>(cm / 3);
    const int col = base[c * 3 + m] + i;
    lwin[cm * LB + i * R + r] = r < Rs
        ? decode_elem(fd.f[3 + m], r, col)
        : decode_elem(fd.f[9 + m], r - Rs, col);
  }
}

constexpr int kTile = 256;         // points per CTA: 32 per warp
constexpr int kThreads = 256;
constexpr int kBasisStride = 40;   // basis row: 32 columns + 8 (banks)
constexpr int kNone = 0x7fffffff;  // cube id of no point

// comp row of a point: Rc rounded up to 8 (the mma depth), then to 4 mod
// 8, so that the 32 lanes of an mma A-fragment load (8 points x 4
// channels) and the 8 lanes of a 16-byte interpolation store each hit
// distinct banks
__host__ __device__ inline int comp_stride(int Rc) {
  const int k8 = (Rc + 7) & ~7;
  return k8 + 4;
}

// Shared memory of fused_sample_kernel, in floats; the wrapper
// (kernels/fused_sample.py `fused_smem_bytes`) computes the same sum.
struct SmemPlan {
  int win, comp, basis, points;
  __host__ __device__ SmemPlan(int W, int Rs, int Rc) {
    const int R = Rs + Rc;
    win = round4(W * W * R) + round4(W * R);
    const int rows = kTile * comp_stride(Rc);
    comp = rows > kTile * kMaxAppDim ? rows : kTile * kMaxAppDim;
    basis = 3 * ((Rc + 7) & ~7) * kBasisStride;
    points = 5 * kTile + 8;                // fr x3, loc, cube id; 8 mins
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (win + comp + basis + points) + 8;  // + mbarrier
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one thread: bring the (cube c, mode m) windows into shared memory
__device__ __forceinline__ void stage_window(float* win, const float* pwin,
                                             const float* lwin, int c, int m,
                                             int PB, int LB, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"((PB + LB) * 4) : "memory");
  const float* src[2] = {pwin + static_cast<long long>(c * 3 + m) * PB,
                         lwin + static_cast<long long>(c * 3 + m) * LB};
  const uint32_t dst[2] = {smem_u32(win), smem_u32(win + PB)};
  const int len[2] = {PB * 4, LB * 4};
#pragma unroll
  for (int k = 0; k < 2; ++k)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst[k]), "l"(src[k]), "r"(len[k]),
        "r"(bar) : "memory");
}

// the block's least value of v; every thread gets it (two barriers)
__device__ __forceinline__ int block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

// x = hi + lo for the 3xTF32 split (hi*hi + hi*lo + lo*hi keeps about
// fp32's precision on the tensor cores): hi is x cut to TF32's 10
// mantissa bits, lo = x - hi exactly; the mma reads lo's top 10 bits,
// which leaves an error near 2^-21 of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA per kTile consecutive points, warp w owning points 32 w.. For
// each cube its points use (least cube id first, so any order of cube_id
// is right) and each mode, the (cube, mode) windows arrive in shared
// memory by one bulk copy on an mbarrier. Each warp interpolates its
// points two at a time, 16 lanes on the channels of each (a stencil row is
// a contiguous run of R floats), and writes the appearance channels to its
// rows of `comp` (point-major) with the density channels' partial sums
// beside them (or sums those over the lanes where more than 4 lanes hold
// them); after one barrier (the window is free, and the next copy starts)
// the warp folds the partial sums into sig and runs feat += comp basis[m]
// on the tensor cores: mma m16n8k8 in TF32, each operand split into hi +
// lo parts (3xTF32), for its 32 points x 32 columns. The warp reads back
// only its own rows of comp, so no second barrier.
__global__ void __launch_bounds__(kThreads, 2)
fused_sample_kernel(const float* __restrict__ pts, const int* __restrict__ cid,
                    const int* __restrict__ base, int N, int C, int G, int W,
                    int Rs, int Rc, int app_dim, float scene_bound,
                    const float* __restrict__ basis,
                    const float* __restrict__ pwin,
                    const float* __restrict__ lwin,
                    float* __restrict__ out_sig, float* __restrict__ out_feat) {
  extern __shared__ float4 smem4[];
  const int R = Rs + Rc;
  const int PB = round4(W * W * R), LB = round4(W * R);
  const int K8 = (Rc + 7) & ~7;               // mma depth, padded
  const int CS = comp_stride(Rc);
  // rows 16-byte aligned, and one 4-channel run per lane
  const bool cached = R % 4 == 0 && Rs % 4 == 0 && R <= 64;
  // lanes of a half-warp holding density channels, rounded up to a power
  // of two: Rs / 4 runs in the cached path, all 16 lanes otherwise
  int sig_lanes = 1;
  while (sig_lanes < (cached ? Rs / 4 : 16)) sig_lanes <<= 1;
  // up to 4 of them leave their partial sums in the 4 floats past a comp
  // row's K8 channels, which the warp folds into sig after the barrier;
  // more take a shuffle reduction per point
  const bool pad_sig = cached && sig_lanes <= 4;
  const SmemPlan plan(W, Rs, Rc);
  float* win = reinterpret_cast<float*>(smem4);
  float* comp = win + plan.win;               // (kTile, CS)
  float* bas = comp + plan.comp;              // (3, K8, kBasisStride)
  float* frs = bas + plan.basis;              // (3, kTile)
  int* locs = reinterpret_cast<int*>(frs + 3 * kTile);
  int* cids = locs + kTile;
  int* red = cids + kTile;
  uint64_t* bar_p = reinterpret_cast<uint64_t*>(red + 8);
  const uint32_t bar = smem_u32(bar_p);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTile;

  {
    const int n = n0 + tid;
    int c = kNone, packed = 0;
    float fr[3] = {0.0f, 0.0f, 0.0f};
    if (n < N) {
      c = min(max(cid[n], 0), C - 1);
      for (int d = 0; d < 3; ++d) {
        float g = (pts[n * 3 + d] / scene_bound * 0.5f + 0.5f) *
                  static_cast<float>(G - 1);
        g = fminf(fmaxf(g, 0.0f), static_cast<float>(G - 1));
        const int g0 = min(max(static_cast<int>(floorf(g)), 0), G - 2);
        fr[d] = g - static_cast<float>(g0);
        packed |= min(max(g0 - base[c * 3 + d], 0), W - 2) << (10 * d);
      }
    }
    for (int d = 0; d < 3; ++d) frs[d * kTile + tid] = fr[d];
    locs[tid] = packed;
    cids[tid] = c;
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int cur = block_min(cids[tid], red);
  // the basis, padded to K8 rows and kBasisStride columns, while the
  // decode kernel finishes (four loads in flight a thread)
  const int nb = 3 * K8 * kBasisStride;
  for (int k0 = tid; k0 < nb; k0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads;
      const int col = k % kBasisStride, rk = k / kBasisStride;
      const int mm = rk >= 2 * K8 ? 2 : (rk >= K8 ? 1 : 0), rc = rk - mm * K8;
      v[u] = k < nb && col < app_dim && rc < Rc
          ? __ldg(basis + (mm * Rc + rc) * app_dim + col) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u * kThreads < nb) bas[k0 + u * kThreads] = v[u];
  }
  for (int k = Rc + lane; k < K8; k += 32)    // comp's padding channels
    for (int p = 32 * warp; p < 32 * warp + 32; ++p) comp[p * CS + k] = 0.0f;
  if (tid == 0 && cur != kNone) {
    // the windows are the decode kernel's output: wait for that grid
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    stage_window(win, pwin, lwin, cur, 0, PB, LB, bar);
  }

  const int hw = lane >> 4, j = lane & 15;    // interpolation: half, lane
  const int g = lane >> 2, t = lane & 3;      // mma fragments
  const int pw = 32 * warp;
  const int n_tiles = (app_dim + 7) / 8;
  float acc[2][4][4];                          // (m16 tile, n8 tile, frag)
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[a][b][k] = 0.0f;
  float sig = 0.0f;                            // of point pw + lane
  uint32_t phase = 0;

  while (cur != kNone) {
    const int next = block_min(cids[tid] > cur ? cids[tid] : kNone, red);
    for (int m = 0; m < 3; ++m) {
      mbar_wait(bar, phase);
      phase ^= 1;
      const int a = plane_axis_a(m), b = plane_axis_b(m);
      // Two points at a time, 16 lanes each; half-warp hw walks its 16
      // consecutive points (consecutive samples of a ray) in order. Lane
      // j takes channels 4 j..4 j + 3 of each stencil row (one 256-byte
      // segment per point and load) and keeps the rows it loaded: the
      // next point reuses them while its cells stay the same, as samples
      // along a ray often do (and points clamped to the window's edge
      // always do). Fields with R > 64, or R or Rs not a multiple of 4,
      // take channels j, j + 16, ... one by one.
      int key = -1;                            // cells of the cached rows
      float4 c00, c01, c10, c11, d0, d1;
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int p = pw + 16 * hw + i;
        float* crow = comp + p * CS - Rs;      // crow[r], r >= Rs
        float s = 0.0f;
        if (cids[p] != cur) {
          for (int r = Rs + j; r < R; r += 16) crow[r] = 0.0f;
          if (pad_sig && j < 4) comp[p * CS + K8 + j] = 0.0f;
        } else {
          const float fu = frs[a * kTile + p], fv = frs[b * kTile + p];
          const float fx = frs[m * kTile + p], gx = 1.0f - fx;
          const int packed = locs[p];
          const int la = (packed >> (10 * a)) & 1023;
          const int lb = (packed >> (10 * b)) & 1023;
          const int lx = (packed >> (10 * m)) & 1023;
          const float w00 = (1.0f - fu) * (1.0f - fv), w01 = (1.0f - fu) * fv;
          const float w10 = fu * (1.0f - fv), w11 = fu * fv;
          const float* p00 = win + (la * W + lb) * R;
          const float* l0 = win + PB + lx * R;
          if (cached) {
            const int c = 4 * j;
            if (c < R) {
              if (packed != key) {
                c00 = *reinterpret_cast<const float4*>(p00 + c);
                c01 = *reinterpret_cast<const float4*>(p00 + R + c);
                c10 = *reinterpret_cast<const float4*>(p00 + W * R + c);
                c11 = *reinterpret_cast<const float4*>(p00 + W * R + R + c);
                d0 = *reinterpret_cast<const float4*>(l0 + c);
                d1 = *reinterpret_cast<const float4*>(l0 + R + c);
                key = packed;
              }
              const float4 v = make_float4(
                  (c00.x * w00 + c01.x * w01 + c10.x * w10 + c11.x * w11) *
                      (d0.x * gx + d1.x * fx),
                  (c00.y * w00 + c01.y * w01 + c10.y * w10 + c11.y * w11) *
                      (d0.y * gx + d1.y * fx),
                  (c00.z * w00 + c01.z * w01 + c10.z * w10 + c11.z * w11) *
                      (d0.z * gx + d1.z * fx),
                  (c00.w * w00 + c01.w * w01 + c10.w * w10 + c11.w * w11) *
                      (d0.w * gx + d1.w * fx));
              if (c < Rs) s = (v.x + v.y) + (v.z + v.w);
              else *reinterpret_cast<float4*>(crow + c) = v;
            }
            if (pad_sig && j < 4) comp[p * CS + K8 + j] = s;
          } else {
            const float* p01 = p00 + R;
            const float* p10 = p00 + W * R;
            const float* p11 = p10 + R;
            const float* l1 = l0 + R;
            for (int r = j; r < R; r += 16) {
              const float v = (p00[r] * w00 + p01[r] * w01 + p10[r] * w10 +
                               p11[r] * w11) * (l0[r] * gx + l1[r] * fx);
              if (r < Rs) s += v;
              else crow[r] = v;
            }
          }
        }
        if (!pad_sig) {
          // the density channels sit on the half's first sig_lanes lanes
          if (sig_lanes > 8) s += __shfl_xor_sync(0xffffffffu, s, 8);
          if (sig_lanes > 4) s += __shfl_xor_sync(0xffffffffu, s, 4);
          if (sig_lanes > 2) s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (sig_lanes > 1) s += __shfl_xor_sync(0xffffffffu, s, 1);
          s = __shfl_sync(0xffffffffu, s, lane & 16);
          // lane 16 hw + i keeps point pw + 16 hw + i's density
          if (j == i) sig += s;
        }
      }
      __syncthreads();                         // window read, comp written
      if (pad_sig) {
        const float4 ps = *reinterpret_cast<const float4*>(
            comp + (pw + lane) * CS + K8);
        sig += (ps.x + ps.y) + (ps.z + ps.w);
      }
      if (tid == 0) {
        if (m < 2) stage_window(win, pwin, lwin, cur, m + 1, PB, LB, bar);
        else if (next != kNone)
          stage_window(win, pwin, lwin, next, 0, PB, LB, bar);
      }

      // feat += comp basis[m] over this warp's 32 points, 8 channels a step
      const float* bm = bas + m * K8 * kBasisStride;
#pragma unroll 2
      for (int k0 = 0; k0 < K8; k0 += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* c0 = comp + (pw + 16 * mt + g) * CS + k0 + t;
          split_tf32(c0[0], ah[mt][0], al[mt][0]);
          split_tf32(c0[8 * CS], ah[mt][1], al[mt][1]);
          split_tf32(c0[4], ah[mt][2], al[mt][2]);
          split_tf32(c0[8 * CS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= n_tiles) break;
          const float* b0 = bm + (k0 + t) * kBasisStride + 8 * nt + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0[0], bh0, bl0);
          split_tf32(b0[4 * kBasisStride], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
            mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
    }
    cur = next;
  }

  // the tile's (kTile, app_dim) rows leave as one contiguous, coalesced
  // block, staged over comp once every warp is done with it
  __syncthreads();
  float* part = comp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = pw + 16 * mt + g + 8 * (k >> 1);
        const int col = 8 * nt + 2 * t + (k & 1);
        if (col < app_dim) part[p * app_dim + col] = acc[mt][nt][k];
      }
  __syncthreads();
  const int n_here = min(kTile, N - n0);
  if (pw + lane < n_here) out_sig[n0 + pw + lane] = sig;
  float* dst = out_feat + static_cast<long long>(n0) * app_dim;
  for (int e = tid; e < n_here * app_dim; e += kThreads) dst[e] = part[e];
}

}  // namespace

// desc: 12 x 9 int64 per factor slice, in FieldDesc order:
// fmt, rows, ncols, nwords, n, steps, ptr a, ptr b, ptr c.
// pwin: C * 3 blocks of round4(W*W*R) floats; lwin: C * 3 of round4(W*R).
extern "C" int fused_sigma_app_launch(
    const long long* desc, const void* pts, const void* cid, const void* base,
    const void* basis, int N, int C, int G, int W, int Rs, int Rc,
    int app_dim, float scene_bound, void* pwin, void* lwin, void* out_sig,
    void* out_feat, void* stream) {
  const SmemPlan plan(W, Rs, Rc);
  if (app_dim > kMaxAppDim || W > 1024 || plan.bytes() > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (nwin > 0) {
    fused_decode_kernel<<<static_cast<unsigned>((nwin + 255) / 256), 256, 0,
                          s>>>(fd, static_cast<const int*>(base), C, G, W, Rs,
                               Rc, static_cast<float*>(pwin),
                               static_cast<float*>(lwin));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    const size_t smem = plan.bytes();
    // the limit holds per device: raise it on every launch
    const cudaError_t err = cudaFuncSetAttribute(
        fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // programmatic dependent launch: the sample kernel's prologue runs
    // under the decode kernel's tail
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3((N + kTile - 1) / kTile);
    lc.blockDim = dim3(kThreads);
    lc.dynamicSmemBytes = smem;
    lc.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    lc.attrs = attr;
    lc.numAttrs = 1;
    const cudaError_t e2 = cudaLaunchKernelEx(
        &lc, fused_sample_kernel, static_cast<const float*>(pts),
        static_cast<const int*>(cid), static_cast<const int*>(base), N, C, G,
        W, Rs, Rc, app_dim, scene_bound, static_cast<const float*>(basis),
        static_cast<const float*>(pwin), static_cast<const float*>(lwin),
        static_cast<float*>(out_sig), static_cast<float*>(out_feat));
    if (e2 != cudaSuccess) return static_cast<int>(e2);
  }
  return static_cast<int>(cudaGetLastError());
}
