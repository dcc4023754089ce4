// Volume rendering (paper Eq. 1) front to back with early ray termination:
// per ray, color = sum_k T_k (1 - exp(-tau_k)) rgb_k with tau_k =
// sigma_k * delta, where a sample is alive while the transmittance before
// it exceeds term_eps and dead samples get tau = 0; t_final = T after the
// last sample; nproc counts the alive samples over all rays.
//
// Replaces the TPU kernel src/repro/kernels/volume_render.py
// `volume_render` (Pallas body `_kernel`): the TPU walks 64-sample chunks
// of a 128-ray block in grid order, carrying log T per ray in VMEM, and
// skips a chunk only when every ray of the block is opaque.
//
// Bound on Hopper: memory. A processed sample reads 16 bytes (sigma and
// rgb) for about 20 flops; a ray writes 16 bytes. Samples behind the
// termination point need not be read at all.
//
// Design: one warp per ray, walking segments of kSegment samples (256),
// each lane a run of kRun (8) consecutive samples. The warp copies the
// segment's sigma into a stage in shared memory (cp.async, coalesced);
// each lane takes its run from there, and a serial scan over the run in
// registers and one warp scan over the 32 run totals give the raw
// cumulative tau before each sample, from the log T carried across
// segments. That decides `alive` exactly as the Pallas kernel does (in the
// log domain: log T before the sample above log(term_eps)). Only then
// does the warp copy rgb, and only the segment's (N, 3) row up to its last
// alive sample, so a ray that terminates reads no rgb behind that point
// and no sigma past its segment; if the ray is still alive at the
// segment's end, the next segment's sigma copy goes out with this rgb
// copy, so a ray of n segments costs n + 1 memory round trips, and the
// weights are computed while the copies fly. The warp stops once its log
// T is at or below log(term_eps). The copies are 16 bytes a lane, 512
// contiguous bytes an instruction (`kVec`); where N is not a multiple of 4
// or a pointer is off 16 bytes, the same stages are filled by 4-byte
// copies and the rest is unchanged. nproc is counted in integers, one
// 64-bit atomic per block of kRaysPerBlock rays, and written as a float by
// the last block to finish. The counters belong to the call: a one-block
// kernel zeroes them first, and the main kernel, launched as its
// programmatic dependent, runs under it and waits for it only before its
// last atomics. With `kCount` the kernel also adds up the bytes its copies
// ask of device memory (for checks; the timed calls leave it out).
// The scans sum in another order than the plain version's cumsum, so color
// and t_final agree to a tolerance, not bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRaysPerBlock = 4;             // 4 warps of 32 lanes
constexpr int kRun = 8;                      // consecutive samples a lane
constexpr int kSegment = 32 * kRun;          // samples a warp takes at once
// 8 blocks an SM (4.3 KB of stages a warp, at most 64 registers a
// thread): 4,224 rays in flight on 132 SMs
constexpr int kBlocksPerSm = 8;
// a warp's stages, in 16-byte slots: the segment's sigma, and its rgb (3
// floats a sample), each with one pad slot after every 8 or 24
constexpr int kSigmaSlots = kSegment / 4 + kSegment / 4 / 8;
constexpr int kRgbSlots = 3 * kSegment / 4 + 3 * kSegment / 4 / 24;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Stage slot of the segment's g-th 16-byte vector (floats 4 g to 4 g + 3).
// A lane reads its run's vectors (2 of sigma at 2 lane + q, 6 of rgb at
// 6 lane + i), so without padding 2 lanes of each 8 would share banks; one
// pad slot after every 8 (sigma) or 24 (rgb) vectors gives the 8 lanes of
// a quarter-warp 8 distinct groups of 4 banks.
template <bool kRgb>
__device__ __forceinline__ int slot(int g) {
  return kRgb ? g + g / 24 : g + (g >> 3);
}

// 2^x by the SFU (MUFU.EX2, about 2 ulp; subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async of the warp landed
__device__ __forceinline__ void landed() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// The first `floats` floats of src into the stage, float e at component
// e % 4 of vector e / 4's slot: 16-byte copies bypassing L1 with kVec
// (floats rounded up to whole vectors; a stage is read once), else 4-byte
// ones. Returns the bytes this lane's copies asked for.
template <int kMaxFloats, bool kRgb, bool kVec>
__device__ __forceinline__ int copy_floats(float4* stage, const float* src,
                                           int floats, int lane) {
  int bytes = 0;
  if constexpr (kVec) {
    const int vecs = (floats + 3) >> 2;
#pragma unroll
    for (int i = 0; i < kMaxFloats / 128; ++i) {
      const int g = 32 * i + lane;
      if (g < vecs) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem(stage + slot<kRgb>(g))),
                     "l"(src + 4 * g) : "memory");
        bytes += 16;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxFloats / 32; ++i) {
      const int e = 32 * i + lane;
      if (e < floats) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         smem(reinterpret_cast<float*>(
                                  stage + slot<kRgb>(e >> 2)) + (e & 3))),
                     "l"(src + e) : "memory");
        bytes += 4;
      }
    }
  }
  return bytes;
}

// The segment's transmittance, from tau (this lane's run, 0 past N) and
// log T before the segment: lt[j] = log T before sample j (a serial scan
// over the run, then a warp scan of the run totals), the alive bits
// (log T before above log(term_eps)), and, returned, the warp's sum of the
// alive samples' tau (the same on every lane).
__device__ __forceinline__ float segment_scan(const float (&tau)[kRun],
                                              float (&lt)[kRun],
                                              unsigned int& alive,
                                              float log_t, float log_eps,
                                              int k0, int N, int lane) {
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    lt[j] = run;
    run += tau[j];
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += u;
  }
  float lane_before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) lane_before = 0.0f;
  alive = 0;
  float kept = 0.0f;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    lt[j] = log_t - (lane_before + lt[j]);
    const bool on = k0 + j < N && lt[j] > log_eps;
    alive |= static_cast<unsigned int>(on) << j;
    kept += on ? tau[j] : 0.0f;
  }
  // the butterfly leaves the same sum on every lane: the loop tests stay
  // uniform across the warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    kept += __shfl_xor_sync(kFull, kept, off);
  return kept;
}

// each sample's weight T (1 - exp(-tau)), in place of its tau: T by the
// SFU's exp2 (a relative error near 2^-22 of w), 1 - exp(-tau) as the
// plain version computes it
__device__ __forceinline__ void weights(float (&tau)[kRun],
                                        const float (&lt)[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    tau[j] = fast_exp2(lt[j] * kLog2e) * (1.0f - expf(-tau[j]));
}

// color += the alive samples' w rgb, this lane's run of a staged segment
__device__ __forceinline__ void accumulate(const float4* stage,
                                           const float (&w)[kRun],
                                           unsigned int alive, int lane,
                                           float& cr, float& cg, float& cb) {
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) {       // 4 samples: 3 vectors
    if (((alive >> (4 * q)) & 15u) == 0) continue;
    const int g = 3 * kRun / 4 * lane + 3 * q;
    const float4 a = stage[slot<true>(g)], b = stage[slot<true>(g + 1)],
                 c = stage[slot<true>(g + 2)];
    const float f[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if ((alive >> (4 * q + m)) & 1u) {
        cr += w[4 * q + m] * f[3 * m];
        cg += w[4 * q + m] * f[3 * m + 1];
        cb += w[4 * q + m] * f[3 * m + 2];
      }
    }
  }
}

// counters: [0] alive samples, [1] blocks done, [2] bytes read
__global__ void zero_counters(unsigned long long* __restrict__ counters) {
  // the main kernel may start now: it waits for this grid before it adds
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x < 3) counters[threadIdx.x] = 0;
}

// counters: zeroed by zero_counters, the grid this one depends on
template <bool kVec, bool kCount>
__global__ void __launch_bounds__(kRaysPerBlock * 32, kBlocksPerSm)
volume_render_kernel(const float* __restrict__ sigma,
                     const float* __restrict__ rgb, int R, int N,
                     float delta, float log_eps,
                     float* __restrict__ color, float* __restrict__ t_final,
                     float* __restrict__ nproc,
                     unsigned long long* __restrict__ counters) {
  __shared__ float4 sig_stage[kRaysPerBlock][kSigmaSlots];
  __shared__ float4 rgb_stage[kRaysPerBlock][kRgbSlots];
  __shared__ unsigned int counts[kRaysPerBlock];
  __shared__ unsigned int reads[kRaysPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kRaysPerBlock + warp;
  float log_t = 0.0f;                        // log T before the segment
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  unsigned int alive_count = 0, read = 0;
  if (ray < R) {                             // the whole warp or none of it
    const float* s_row = sigma + static_cast<long long>(ray) * N;
    const float* c_row = rgb + static_cast<long long>(ray) * N * 3;
    float4* const ss = sig_stage[warp];
    float4* const cs = rgb_stage[warp];
    float tau[kRun], lt[kRun];
    unsigned int alive;
    // Segment s's rgb copy and segment s + 1's sigma copy share one round
    // trip: a ray of n segments takes n + 1
    int bytes = copy_floats<kSegment, false, kVec>(ss, s_row,
                                                   min(kSegment, N), lane);
    commit();
    for (int base = 0;; base += kSegment) {
      const int k0 = base + lane * kRun;
      landed();                              // sigma(base), rgb(base - 1)
      if (base > 0) accumulate(cs, tau, alive, lane, cr, cg, cb);
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        const float4 v = ss[slot<false>(kRun / 4 * lane + q)];
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
          tau[4 * q + m] = k0 + 4 * q + m < N ? f[m] * delta : 0.0f;
      }
      __syncwarp();                          // both stages free
      log_t -= segment_scan(tau, lt, alive, log_t, log_eps, k0, N, lane);
      alive_count += __popc(alive);
      const int next = base + kSegment;
      const bool more = next < N && log_t > log_eps;
      if (more)
        bytes += copy_floats<kSegment, false, kVec>(
            ss, s_row + next, min(kSegment, N - next), lane);
      // rgb up to the segment's last alive sample: 3 floats a sample
      const int len = 32 - __clz(alive);
      const int used = __reduce_max_sync(kFull, len ? lane * kRun + len : 0);
      bytes += copy_floats<3 * kSegment, true, kVec>(cs, c_row + 3 * base,
                                                     3 * used, lane);
      commit();
      weights(tau, lt);                      // while the copies fly
      if (!more) {
        landed();
        accumulate(cs, tau, alive, lane, cr, cg, cb);
        break;
      }
    }
    read = bytes;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cr += __shfl_xor_sync(kFull, cr, off);
      cg += __shfl_xor_sync(kFull, cg, off);
      cb += __shfl_xor_sync(kFull, cb, off);
      alive_count += __shfl_xor_sync(kFull, alive_count, off);
      if constexpr (kCount) read += __shfl_xor_sync(kFull, read, off);
    }
    if (lane == 0) {
      color[3 * ray] = cr;
      color[3 * ray + 1] = cg;
      color[3 * ray + 2] = cb;
      t_final[ray] = expf(log_t);
    }
  }
  // nproc: each block adds its count to counters[0] and takes a ticket
  // from counters[1]; the last block writes the float
  if (lane == 0) {
    counts[warp] = alive_count;
    if constexpr (kCount) reads[warp] = read;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0, total_read = 0;
#pragma unroll
    for (int i = 0; i < kRaysPerBlock; ++i) {
      total += counts[i];
      if constexpr (kCount) total_read += reads[i];
    }
    // the counters are zero_counters' output: wait for that grid
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (total > 0) atomicAdd(counters, total);
    if constexpr (kCount) atomicAdd(counters + 2, total_read);
    __threadfence();
    if (atomicAdd(counters + 1, 1ull) == gridDim.x - 1) {
      __threadfence();
      *nproc = static_cast<float>(atomicAdd(counters, 0ull));
    }
  }
}

template <bool kVec, bool kCount>
cudaError_t launch(int blocks, cudaStream_t s, const float* sp,
                   const float* cp, int R, int N, float delta, float log_eps,
                   float* col, float* tf, float* np, unsigned long long* c) {
  zero_counters<<<1, 32, 0, s>>>(c);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // programmatic dependent launch: the rays run under the zeroing kernel
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(blocks);
  lc.blockDim = dim3(kRaysPerBlock * 32);
  lc.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return cudaLaunchKernelEx(&lc, volume_render_kernel<kVec, kCount>, sp, cp,
                            R, N, delta, log_eps, col, tf, np, c);
}

}  // namespace

// nproc: one float on the device, the count of alive samples. counters:
// three uint64 that belong to this call alone (zeroed on the stream by the
// launch); with count, counters[2] ends as the bytes the kernel's copies
// read from sigma and rgb. vec: 1 for the 16-byte copies, which need
// N % 4 == 0 and both pointers 16-byte aligned (an error otherwise), 0 for
// 4-byte ones.
extern "C" int volume_render_launch(const void* sigma, const void* rgb, int R,
                                    int N, float delta, float log_eps,
                                    void* color, void* t_final, void* nproc,
                                    void* counters, int vec, int count,
                                    void* stream) {
  if (vec && (N % 4 != 0 || reinterpret_cast<uintptr_t>(sigma) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(rgb) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kRaysPerBlock - 1) / kRaysPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(sigma);
  const float* cp = static_cast<const float*>(rgb);
  float* col = static_cast<float*>(color);
  float* tf = static_cast<float*>(t_final);
  float* np = static_cast<float*>(nproc);
  unsigned long long* c = static_cast<unsigned long long*>(counters);
  const cudaError_t e =
      vec ? (count ? launch<true, true> : launch<true, false>)(
                blocks, s, sp, cp, R, N, delta, log_eps, col, tf, np, c)
          : (count ? launch<false, true> : launch<false, false>)(
                blocks, s, sp, cp, R, N, delta, log_eps, col, tf, np, c);
  return static_cast<int>(e);
}
