// Control-rate FiLM -> sine-shaper bank -> FiLM, backward, float32.
//
// Replaces the TPU kernel kernels/newt_fused.py:822 _fused_bwd_cr (Pallas:
// _bwd_kernel_cr, _bwd_core, _fold_dfilm_cr, _accumulate_wgrads, and
// _unwindow_dfilm, which ran outside the Pallas call) of the JAX package.
// The forward is newt_fused_cr.cu; like JAX's _fused_fwd_cr it stores no
// activation, so this kernel recomputes the forward per (sample, channel).
//
// What it computes, given exciter (B, Ta, 64), control-rate film
// (B, Tc, 256), the packed weight planes (170, 64) and the output
// cotangent dy (B, Ta, 64), Ta = Tc*hop:
//   d_exciter (B, Ta, 64);
//   d_film (B, Tc, 256) at control rate: each sample's four FiLM
//     cotangents go to its left frame with weight (1-w) and to its right
//     frame with weight w, the transpose of the forward's lerp; the head
//     and tail clamps land on frames 0 and Tc-1;
//   d_planes (170, 64): each weight plane's gradient summed in f32 over all
//     B*Ta samples.
//
// What bounds it on an H100: arithmetic. Per (sample, channel) it redoes
// the forward with a cosine beside each of the 25 sines (1,080 operations,
// an FMA as two), then the chain rule: the transposed 8x8 products and the
// 170 weight-gradient multiply-adds, 641 more: 1.72 kFLOP against 12 bytes of
// exciter, dy and d_exciter. In this first version the 170 shared-memory
// read-modify-writes of the weight-gradient sums per (sample, channel) are
// the likelier limit (one warp-wide shared access per cycle per SM).
// ptxas (sm_90a): 255 registers, 28 B of spills, so one 256-thread block
// per SM; on an H100 SXM at 700 W, 3.4 ms at B=8, Tc=500, hop=128 against
// a 0.84 ms bound (PERF.md).
//
// Design:
//  * Persistent grid (what fits on the card at once) of 256-thread blocks:
//    4 rows of 64 channels. Each row walks over control segments (b, m) of
//    hop samples, strided by the grid's row count; a thread owns one
//    channel of the row's segment and loops over its hop samples, so the
//    segment's FiLM frames {m-1, m, m+1} (clamped) are read once into
//    registers and its FiLM cotangents are summed in registers, indexed by
//    the clamped frame (slot 0, 1, 2 = frame m-1, m, m+1), with no
//    reduction across threads (newt::FilmSegment, shared with the
//    exciter-fused backward newt_fused_x_bwd.cu). The per-sample recompute
//    and chain rule are newt_shaper_bwd.cuh, shared with the audio-rate
//    backward newt_fused_fl_bwd.cu.
//  * Weight-gradient sums: each thread has an exclusive (170,) slot in
//    shared memory, (4, 170, 64) f32 = 174 KB beside the 43.5 KB of weight
//    planes (dynamic shared memory, one block per SM). A warp's slot
//    accesses are 32 consecutive floats: conflict-free.
//  * Cross-block sums (the TPU accumulated into one resident block across
//    its sequential grid; Hopper blocks run in parallel, in no order):
//    deterministic per-block partials plus a second pass, no atomics, so
//    two calls give the same bits. Each block writes its 4 slots summed in
//    row order as one (170, 64) partial; each segment writes its (3, 256)
//    FiLM partial. Then sum_weight_partials adds the block partials in
//    block order and fold_film_partials (newt_shaper_bwd.cuh) adds, for
//    frame f, segment f-1's slot 2, segment f's slot 1 and segment f+1's
//    slot 0, in that order (the analogue of _unwindow_dfilm).
//
// Exactness, as the forward: the recomputed FiLM lerp is the forward's,
// bit for bit (one __fdiv_rn weight, __fmul_rn/__fadd_rn lerp, head clamp
// as w = 0); no --use_fast_math; rintf for the range reduction; the
// gradient's lerp weights are the same w and 1-w.
#include <cuda_runtime.h>

#include "newt_shaper_bwd.cuh"

namespace {

using newt::kC;
using newt::kPlane;

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = kRowsPerBlock * kC;
// weight planes + one weight-gradient slot per thread
constexpr size_t kSmemBytes = static_cast<size_t>(1 + kRowsPerBlock) * kPlane * sizeof(float);

__global__ void __launch_bounds__(kThreads, 1)
film_shaper_cr_bwd_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          const float* __restrict__ dy,
                          float* __restrict__ d_exciter,
                          float* __restrict__ film_part,
                          float* __restrict__ w_part, int n_seg, int tc,
                          int hop) {
  extern __shared__ float smem[];
  float* sw = smem;           // (170, 64) weight planes
  float* acc = smem + kPlane; // (4, 170, 64) weight-gradient sums
  for (int i = threadIdx.x; i < kPlane; i += kThreads) sw[i] = weights[i];
  for (int i = threadIdx.x; i < kRowsPerBlock * kPlane; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int r = threadIdx.x / kC;
  float* my = acc + r * kPlane + c;  // my[k * kC]: plane row k of my slot

  for (int seg = blockIdx.x * kRowsPerBlock + r; seg < n_seg;
       seg += gridDim.x * kRowsPerBlock) {
    const int b = seg / tc;
    newt::FilmSegment fs;
    fs.load(film + static_cast<long long>(b) * tc * (4 * kC), seg - b * tc, tc, hop, c);

    for (int o = 0; o < hop; ++o) {
      // FiLM lerp, exactly as newt_fused_cr.cu
      float film_a[4], w, omw;
      bool lo;
      fs.at(o, film_a, &w, &omw, &lo);
      const float g_in = film_a[0], b_in = film_a[1], g_out = film_a[2];

      // forward recompute and chain rule (JAX _bwd_core), newt_shaper_bwd.cuh
      const long long e = (static_cast<long long>(seg) * hop + o) * kC + c;
      const float xin = exciter[e];
      const float x = g_in * xin + b_in;
      const float g = dy[e];
      float y, dx;
      newt::shaper_backward(x, g * g_out, sw, c, my, &y, &dx);
      d_exciter[e] = dx * g_in;

      // FiLM cotangents (d gamma_in, d beta_in, d gamma_out, d beta_out)
      const float d_film[4] = {dx * xin, dx, g * y, g};
      fs.add(d_film, w, omw, lo);
    }
    fs.store(film_part + static_cast<long long>(seg) * 3 * (4 * kC) + c);
  }

  __syncthreads();
  float* out = w_part + static_cast<long long>(blockIdx.x) * kPlane;
  for (int i = threadIdx.x; i < kPlane; i += kThreads)
    out[i] = ((acc[i] + acc[kPlane + i]) + acc[2 * kPlane + i]) + acc[3 * kPlane + i];
}

}  // namespace

// The number of backward blocks resident on the current device at once
// (SMs x blocks per SM); it also allows the kernel its dynamic shared
// memory there, so call it once per device before the first launch. The
// caller launches min(this, ceil(B*Tc / 4)) blocks and sizes the
// (blocks, 170, 64) weight partials with it. Returns -(CUDA error) on
// failure.
extern "C" int newt_fused_cr_backward_resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(film_shaper_cr_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_cr_bwd_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

// exciter, dy, d_exciter (B, Ta, 64); film, d_film (B, Tc, 256); weights,
// d_planes (170, 64); scratch film_part (B*Tc, 3, 256) and w_part
// (blocks, 170, 64), with blocks as newt_fused_cr_backward_resident_blocks
// says: contiguous float32 on the current device, Ta = Tc*hop. Launches the three kernels
// on `stream` and returns the first CUDA error (0 = launched).
extern "C" int newt_fused_cr_backward(const float* exciter, const float* film,
                                      const float* weights, const float* dy,
                                      float* d_exciter, float* d_film,
                                      float* d_planes, float* film_part,
                                      float* w_part, int b, int ta, int tc,
                                      int blocks, void* stream) {
  if (b <= 0 || tc <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hop = ta / tc;
  film_shaper_cr_bwd_kernel<<<blocks, kThreads, kSmemBytes, s>>>(
      exciter, film, weights, dy, d_exciter, film_part, w_part, b * tc, tc, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  newt::sum_weight_partials<<<(kPlane + 255) / 256, 256, 0, s>>>(w_part, d_planes, kPlane,
                                                                  blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(newt::fold_film(film_part, d_film, b, tc, s));
}
