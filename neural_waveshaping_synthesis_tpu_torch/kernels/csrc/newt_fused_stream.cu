// Streaming FiLM ramp -> sine-shaper bank -> FiLM, forward, float32.
//
// Replaces the TPU kernel kernels/newt_fused.py:1509 film_shaper_fused_stream
// (Pallas: _fwd_kernel_stream, _interp_w_stream, _film_planes_stream,
// _windows_stream, _forward_core) of the JAX package: step 5 of
// streaming/synth.py StreamingSynth.step. Same function, not the same
// layout: the TPU's "tile = 2 hops" (hence its even K), row-pair lane
// packing and per-tile frame windows with a replicated tail frame were
// Mosaic artefacts and are gone.
//
// What it computes, for sample t = m*hop + o of buffer b (K frames, Ta =
// K*hop samples) and channel c:
//   start = frame m-1 of the buffer, where frame -1 is prev_film[b] (the
//           last frame of the previous buffer); end = frame m;
//   film_a(t) = start + (end - start) * ((o+1)/hop), for a = gamma_in,
//           beta_in, gamma_out, beta_out (lanes a*64 + c of a frame),
//           exactly as ops/upsample.py segment_interp;
//   out = gamma_out * shaper(gamma_in * exciter + beta_in) + beta_out, the
//         shaper being newt_shaper.cuh's, as in newt_fused_cr.cu.
// No frame is clamped and none is replicated: the ramp of a buffer ends on
// its last frame, which the next buffer takes as prev_film.
//
// What bounds it on an H100: arithmetic, as the cr kernel. Per (sample,
// channel): the ramp 4 * (sub, mul, add) + one division, the FiLM and input
// scale 3, the MLP's 144 multiply-adds, 25 polynomial sines of ~18
// operations and the output FiLM: ~756 operations against 8 bytes of
// exciter in and out (the control-rate film and weights are small and stay
// in L2). At 256 streams of 1024-sample buffers: 12.7 GFLOP, 0.14 GB, a
// bound of ~0.19 ms set by the 67 TFLOP/s f32 rate. At one stream the
// kernel is a few microseconds and the launch dominates.
//
// What the design does about it: the cr kernel's. One thread per (sample,
// channel), channels fastest, so exciter, film and output accesses of a
// warp are 128-byte coalesced; the 170 x 64 weight planes in shared memory;
// a grid of what fits on the card at once striding over the samples, so
// each block stages the weights once. The (B, Ta, 256) audio-rate film never
// exists: the ramp is computed in registers.
//
// Where the numbers would trip, and what holds them:
//  * The ramp is bit-exact to segment_interp: t is ONE IEEE f32 division of
//    exact integers, (o+1)/hop, via __fdiv_rn (no --use_fast_math, which
//    would make division approximate), and start + (end - start) * t is
//    written with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc's default FMA
//    contraction cannot fuse it. Note the form differs from the cr kernel's
//    left*(1-w) + right*w: the two round differently.
//  * Index arithmetic: samples are counted in 32-bit ints (the wrapper
//    refuses B*Ta > 2^30), element and film offsets in 64-bit.
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

using newt::kC;
using newt::kRows;

constexpr int kThreads = 256;  // 4 samples x 64 channels per block pass
constexpr int kSamplesPerPass = kThreads / kC;
constexpr int kFilm = 4 * kC;  // floats per FiLM frame

__device__ __forceinline__ float ramp_exact(float start, float end, float t) {
  return __fadd_rn(start, __fmul_rn(__fsub_rn(end, start), t));
}

__global__ void __launch_bounds__(kThreads)
film_shaper_stream_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ prev_film,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          float* __restrict__ out, int n_samples, int ta, int k,
                          int hop) {
  __shared__ float sw[kRows * kC];
  newt::stage_weights(sw, weights, kThreads);
  __syncthreads();

  const int c = threadIdx.x % kC;
  const float den = static_cast<float>(hop);
  const int stride = gridDim.x * kSamplesPerPass;

  for (int s = blockIdx.x * kSamplesPerPass + threadIdx.x / kC; s < n_samples;
       s += stride) {
    const int b = s / ta;
    const int t = s - b * ta;
    const int m = t / hop;
    const float w = __fdiv_rn(static_cast<float>(t - m * hop + 1), den);

    const float* fe = film + (static_cast<long long>(b) * k + m) * kFilm + c;
    const float* fs = m == 0 ? prev_film + static_cast<long long>(b) * kFilm + c
                             : fe - kFilm;
    const float g_in = ramp_exact(fs[0], fe[0], w);
    const float b_in = ramp_exact(fs[kC], fe[kC], w);
    const float g_out = ramp_exact(fs[2 * kC], fe[2 * kC], w);
    const float b_out = ramp_exact(fs[3 * kC], fe[3 * kC], w);

    const long long e = static_cast<long long>(s) * kC + c;
    const float y = newt::shaper(g_in * exciter[e] + b_in, sw, c);
    out[e] = g_out * y + b_out;
  }
}

}  // namespace

// The number of stream blocks resident on the current device at once (SMs x
// blocks per SM): the grid the forward strides with. It depends only on the
// device, so the caller asks once per device and passes it to every launch.
// Returns -(CUDA error) on failure.
extern "C" int newt_fused_stream_resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_stream_kernel, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

// exciter (B, Ta, 64), prev_film (B, 256), film (B, K, 256) at control rate,
// weights (170, 64) and out (B, Ta, 64): contiguous float32 on the current
// device, Ta = K*hop, n_samples = B*Ta; `blocks` as
// newt_fused_stream_resident_blocks says. Launches min(blocks, what the
// samples need) blocks on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int newt_fused_stream_forward(const float* exciter, const float* prev_film,
                                         const float* film, const float* weights,
                                         float* out, int n_samples, int ta, int k,
                                         int hop, int blocks, void* stream) {
  if (n_samples <= 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long needed =
      (static_cast<long long>(n_samples) + kSamplesPerPass - 1) / kSamplesPerPass;
  const int grid = static_cast<int>(needed < blocks ? needed : blocks);
  film_shaper_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, prev_film, film, weights, out, n_samples, ta, k, hop);
  return static_cast<int>(cudaGetLastError());
}
