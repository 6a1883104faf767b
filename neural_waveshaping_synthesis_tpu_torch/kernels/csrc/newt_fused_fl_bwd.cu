// Audio-rate FiLM -> sine-shaper bank -> FiLM, backward, float32.
//
// Replaces the TPU kernels kernels/newt_fused.py:527 _fused_bwd_fl and :450
// _fused_bwd (both reach _run_bwd :395 -> pallas_call with _bwd_kernel_fl /
// _bwd_kernel, _bwd_core, _accumulate_wgrads) of the JAX package: one
// kernel for both, as the forward newt_fused_fl.cu is one for their
// forwards. Like JAX's _fused_fwd_fl the forward stores no activation, so
// this kernel recomputes it per (sample, channel).
//
// What it computes, given exciter (B, Ta, 64), the audio-rate film
// (B, Ta, 256), the packed weight planes (170, 64) and the output cotangent
// dy (B, Ta, 64):
//   d_exciter (B, Ta, 64);
//   d_film (B, Ta, 256): each sample's four FiLM cotangents (d gamma_in,
//     d beta_in, d gamma_out, d beta_out), written where the forward read
//     the FiLM;
//   d_planes (170, 64): each weight plane's gradient summed in f32 over all
//     B*Ta samples.
//
// What bounds it on an H100: arithmetic. Per (sample, channel) it redoes
// the forward with a cosine beside each of the 25 sines and runs the chain
// rule with the 170 weight-gradient multiply-adds: 1,691 operations (an
// FMA as two) against 44 bytes moved (exciter, FiLM, dy in; d_exciter,
// d_film out). As in kernel 2 (newt_fused_cr_bwd.cu), the 170 shared-memory
// read-modify-writes of the gradient sums per (sample, channel) are the
// likelier limit of this first version.
//
// Design, kernel 2's without its FiLM fold:
//  * Persistent grid (what fits on the card at once) of 256-thread blocks:
//    4 rows of 64 channels, each row striding over the samples by the
//    grid's row count. The recompute and chain rule are
//    newt_shaper_bwd.cuh, shared with kernel 2.
//  * Weight-gradient sums: each thread has an exclusive (170,) slot in
//    shared memory, (4, 170, 64) f32 = 174 KB beside the 43.5 KB of weight
//    planes (dynamic shared memory, one block per SM); a warp's slot
//    accesses are 32 consecutive floats, conflict-free.
//  * Cross-block sums (the TPU accumulated into one resident block across
//    its sequential grid; Hopper blocks run in parallel, in no order):
//    deterministic per-block partials plus a second pass, no atomics, so two
//    calls give the same bits. Each block writes its 4 slots summed in row
//    order as one (170, 64) partial; newt::sum_weight_partials adds the
//    partials in block order.
//  * The FiLM cotangents need no fold: each sample's four are its own, and
//    go straight to d_film with coalesced stores.
//
// Exactness: no --use_fast_math; rintf for the range reduction. Samples are
// counted in 32-bit ints (the wrapper refuses B*Ta > 2^30), offsets in
// 64-bit.
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
film_shaper_fl_bwd_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          const float* __restrict__ dy,
                          float* __restrict__ d_exciter,
                          float* __restrict__ d_film,
                          float* __restrict__ w_part, int n_samples) {
  extern __shared__ float smem[];
  float* sw = smem;            // (170, 64) weight planes
  float* acc = smem + kPlane;  // (4, 170, 64) weight-gradient sums
  for (int i = threadIdx.x; i < kPlane; i += kThreads) sw[i] = weights[i];
  for (int i = threadIdx.x; i < kRowsPerBlock * kPlane; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int r = threadIdx.x / kC;
  float* my = acc + r * kPlane + c;  // my[k * kC]: plane row k of my slot

  for (int s = blockIdx.x * kRowsPerBlock + r; s < n_samples;
       s += gridDim.x * kRowsPerBlock) {
    const long long e = static_cast<long long>(s) * kC + c;
    const long long f = static_cast<long long>(s) * (4 * kC) + c;
    const float g_in = film[f], b_in = film[f + kC], g_out = film[f + 2 * kC];
    const float xin = exciter[e];
    const float x = g_in * xin + b_in;
    const float g = dy[e];
    float y, dx;
    newt::shaper_backward(x, g * g_out, sw, c, my, &y, &dx);
    d_exciter[e] = dx * g_in;
    d_film[f] = dx * xin;
    d_film[f + kC] = dx;
    d_film[f + 2 * kC] = g * y;
    d_film[f + 3 * kC] = g;
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
// caller launches min(this, ceil(B*Ta / 4)) blocks and sizes the
// (blocks, 170, 64) weight partials with it. Returns -(CUDA error) on
// failure.
extern "C" int newt_fused_fl_backward_resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(film_shaper_fl_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_fl_bwd_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

// exciter, dy, d_exciter (B, Ta, 64); film, d_film (B, Ta, 256); weights,
// d_planes (170, 64); scratch w_part (blocks, 170, 64), with blocks as
// newt_fused_fl_backward_resident_blocks says: contiguous float32 on the
// current device, n_samples = B*Ta. Launches the two kernels on `stream` and
// returns the first CUDA error (0 = launched).
extern "C" int newt_fused_fl_backward(const float* exciter, const float* film,
                                      const float* weights, const float* dy,
                                      float* d_exciter, float* d_film,
                                      float* d_planes, float* w_part,
                                      int n_samples, int blocks, void* stream) {
  if (n_samples <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  film_shaper_fl_bwd_kernel<<<blocks, kThreads, kSmemBytes, s>>>(
      exciter, film, weights, dy, d_exciter, d_film, w_part, n_samples);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  newt::sum_weight_partials<<<(kPlane + 255) / 256, 256, 0, s>>>(w_part, d_planes, kPlane,
                                                                  blocks);
  return static_cast<int>(cudaGetLastError());
}
