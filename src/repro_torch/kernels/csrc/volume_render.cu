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
// Design: one warp per ray, walking 32-sample chunks front to back. Each
// lane takes one sample of the chunk; a __shfl_up_sync inclusive scan of
// the raw tau gives the transmittance before each sample (from the log T
// carried across chunks), which decides `alive` exactly as the Pallas
// kernel does; the masked tau is scanned again for the weights. The warp
// stops as soon as its log T is at or below log(term_eps), so a ray reads
// only the chunks up to its termination (the TPU kernel's block-level
// skip, per ray). Neighbouring lanes read neighbouring samples
// (coalesced). nproc is counted in integers: one 64-bit atomic per ray.
// The scans sum in another order than the plain version's cumsum, so
// color and t_final agree to a tolerance, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kRaysPerBlock = 8;             // 8 warps of 32 lanes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kRaysPerBlock * 32)
volume_render_kernel(const float* __restrict__ sigma,
                     const float* __restrict__ rgb, int R, int N,
                     float delta, float term_eps, float log_eps,
                     float* __restrict__ color, float* __restrict__ t_final,
                     unsigned long long* __restrict__ nproc) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;                      // whole warp leaves together
  const float* s_row = sigma + static_cast<long long>(ray) * N;
  const float* c_row = rgb + static_cast<long long>(ray) * N * 3;
  float log_t = 0.0f;                        // log T before the chunk
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int alive_count = 0;
  for (int base = 0; base < N && log_t > log_eps; base += 32) {
    const int k = base + lane;
    const bool valid = k < N;
    const float tau_raw = valid ? __ldg(s_row + k) * delta : 0.0f;
    const float cum_raw = warp_inclusive_sum(tau_raw, lane);
    const bool alive = valid && expf(log_t - (cum_raw - tau_raw)) > term_eps;
    const float tau = alive ? tau_raw : 0.0f;
    const float cum = warp_inclusive_sum(tau, lane);
    if (alive) {
      const float w = expf(log_t - (cum - tau)) * (1.0f - expf(-tau));
      cr += w * __ldg(c_row + 3 * k);
      cg += w * __ldg(c_row + 3 * k + 1);
      cb += w * __ldg(c_row + 3 * k + 2);
      ++alive_count;
    }
    log_t -= __shfl_sync(kFull, cum, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cr += __shfl_xor_sync(kFull, cr, off);
    cg += __shfl_xor_sync(kFull, cg, off);
    cb += __shfl_xor_sync(kFull, cb, off);
    alive_count += __shfl_xor_sync(kFull, alive_count, off);
  }
  if (lane == 0) {
    color[3 * ray] = cr;
    color[3 * ray + 1] = cg;
    color[3 * ray + 2] = cb;
    t_final[ray] = expf(log_t);
    if (alive_count > 0)
      atomicAdd(nproc, static_cast<unsigned long long>(alive_count));
  }
}

}  // namespace

// nproc must be a zeroed uint64 on the device; it receives the count.
extern "C" int volume_render_launch(const void* sigma, const void* rgb, int R,
                                    int N, float delta, float term_eps,
                                    float log_eps, void* color, void* t_final,
                                    void* nproc, void* stream) {
  if (R > 0) {
    const int blocks = (R + kRaysPerBlock - 1) / kRaysPerBlock;
    volume_render_kernel<<<blocks, kRaysPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigma), static_cast<const float*>(rgb), R,
        N, delta, term_eps, log_eps, static_cast<float*>(color),
        static_cast<float*>(t_final),
        static_cast<unsigned long long*>(nproc));
  }
  return static_cast<int>(cudaGetLastError());
}
