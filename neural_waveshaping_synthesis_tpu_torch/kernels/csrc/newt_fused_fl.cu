// Audio-rate FiLM -> sine-shaper bank -> FiLM, forward, float32.
//
// Replaces the TPU kernels kernels/newt_fused.py:488 film_shaper_fused_fl
// and :417 film_shaper_fused (both reach _run_fwd :364 -> pallas_call with
// _fwd_kernel_fl / _fwd_kernel, _forward_core, _psin) of the JAX package.
// The two Pallas kernels compute the same function and differ only in how
// they fill the TPU's vector lanes: row pairs in 128 lanes, or 64 lanes.
// Hopper has no such lanes, so one kernel covers both; the row pairing and
// its "B*Ta even" requirement, and the padded tile (_pad_rows), are gone.
//
// What it computes, for audio sample s of the (B*Ta) rows and channel c,
// with the FiLM parameters already at audio rate, film (B, Ta, 256):
//   x   = gamma_in * exciter + beta_in, gamma_in = film[s, c] and beta_in =
//         film[s, 64 + c];
//   y   = the per-channel 1 -> 8 -> 8 -> 8 -> 1 sine MLP of
//         newt_shaper.cuh;
//   out = gamma_out * y + beta_out, film[s, 128 + c] and film[s, 192 + c].
//
// What bounds it on an H100: arithmetic. Per (sample, channel) it does 25
// polynomial sines and the MLP's 144 multiply-adds, 743 operations
// counting an FMA as two, against 24 bytes moved (exciter, four FiLM
// floats, output): ~31 operations per byte against a ridge of ~20, so FP32
// ALU throughput bounds it, with memory not far behind (at B=8, Ta=65536:
// 0.372 ms of operations, 0.240 ms of bytes).
//
// What the design does about it: kernel 1's (newt_fused_cr.cu), with the
// FiLM read per sample instead of interpolated. One thread per (sample,
// channel), channels fastest, so a warp's exciter, FiLM and output accesses
// are 128-byte coalesced; the nine weight planes (43.5 KB) sit in shared
// memory, staged once per block; blocks stride over the samples (grid =
// what fits on the card at once). Not yet done (later work): reusing each
// shared-memory weight read for several samples, packed f32x2 FMA.
//
// Exactness, as kernel 1: no --use_fast_math, rintf for the range
// reduction (newt_shaper.cuh). Fed linear_upsample of a control-rate FiLM,
// it computes what kernel 1 computes from that FiLM. Samples are counted
// in 32-bit ints (the wrapper refuses B*Ta > 2^30), offsets in 64-bit.
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

using newt::kC;
using newt::kRows;

constexpr int kThreads = 256;  // 4 samples x 64 channels per block pass
constexpr int kSamplesPerPass = kThreads / kC;

__global__ void __launch_bounds__(kThreads)
film_shaper_fl_kernel(const float* __restrict__ exciter,
                      const float* __restrict__ film,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int n_samples) {
  __shared__ float sw[kRows * kC];
  newt::stage_weights(sw, weights, kThreads);
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int stride = gridDim.x * kSamplesPerPass;
  for (int s = blockIdx.x * kSamplesPerPass + threadIdx.x / kC; s < n_samples;
       s += stride) {
    const long long e = static_cast<long long>(s) * kC + c;
    const float* f = film + static_cast<long long>(s) * (4 * kC) + c;
    const float y = newt::shaper(f[0] * exciter[e] + f[kC], sw, c);
    out[e] = f[2 * kC] * y + f[3 * kC];
  }
}

}  // namespace

// exciter and out (B, Ta, 64), film (B, Ta, 256) at audio rate, weights
// (170, 64): contiguous float32 on the current device, n_samples = B*Ta.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_fl_forward(const float* exciter, const float* film,
                                     const float* weights, float* out,
                                     int n_samples, void* stream) {
  if (n_samples <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_fl_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed =
      (static_cast<long long>(n_samples) + kSamplesPerPass - 1) / kSamplesPerPass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  film_shaper_fl_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, film, weights, out, n_samples);
  return static_cast<int>(cudaGetLastError());
}
