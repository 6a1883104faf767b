// Control-rate FiLM -> sine-shaper bank -> FiLM, forward, float32.
//
// Replaces the TPU kernel kernels/newt_fused.py:779 film_shaper_fused_cr
// (Pallas: _fwd_kernel_cr, _interp_w_cr, _film_planes_cr, _forward_core,
// _psin) of the JAX package. Same function, not the same layout: the
// row-pair 128-lane packing, the per-tile frame windows and the
// "tile = 2 hops" geometry were Mosaic artefacts and are gone.
//
// What it computes, for audio sample s = m*hop + o of clip b and channel c:
//   film_a(s) = lerp of film_c[b, :, a*64 + c] between two control frames
//               (a = gamma_in, beta_in, gamma_out, beta_out), align_corners
//               =False, exactly as ops/upsample.py linear_upsample;
//   x  = gamma_in * exciter + beta_in;
//   y  = psin(l4(psin(l3(psin(l2(psin(l1(x * input_scale)))))))), a per-
//        channel 1 -> 8 -> 8 -> 8 -> 1 MLP with a polynomial sine after
//        every layer;
//   out = gamma_out * y + beta_out.
//
// What bounds it on an H100: arithmetic, not memory. Per (sample, channel)
// it does 25 polynomial sines (~10 f32 operations each) and 144 multiply-
// adds of the MLP, ~0.75 kFLOP counting an FMA as two, against 8 bytes of
// exciter in and out (the control-rate film and the weights are small and
// stay in L2). At 67 TFLOP/s f32 and 3.35 TB/s that is ~90 FLOP per byte
// against a ridge of ~20: FP32 ALU throughput bounds it.
//
// What the design does about it: one thread per (sample, channel), channels
// fastest, so a warp's exciter loads, output stores and film loads are
// 128-byte coalesced and nothing but the result goes back to memory. The
// nine weight planes (170 x 64 f32, 43.5 KB) sit in shared memory in the
// pack_weights channel-fastest layout, so a warp's weight reads hit 32
// distinct banks; the shaper itself is newt_shaper.cuh, shared with the
// streaming kernel newt_fused_stream.cu. Blocks stride over the samples
// (grid = what fits on the card at once), so each block stages the weights
// once. The FiLM
// interpolation is done in registers: the (B, Ta, 256) audio-rate film
// never exists. Not yet done (later work): reusing each shared-memory
// weight read for several samples, packed f32x2 FMA.
//
// Where the numbers would trip, and what holds them:
//  * FiLM interpolation is bit-exact to linear_upsample (newt::film_at in
//    newt_shaper.cuh): the weight is ONE IEEE f32 division of exact
//    integers, (2o+1 +- hop) / (2*hop), via __fdiv_rn (the build does not
//    use --use_fast_math, which would make division approximate); the lerp
//    left*(1-w) + right*w is written with __fsub_rn/__fmul_rn/__fadd_rn so
//    that nvcc's default FMA contraction cannot fuse it. The head clamp
//    (first half-hop of a clip copies frame 0) is folded in as w = 0 between
//    two copies of frame 0, which gives frame 0 exactly; the tail clamp is a
//    lerp between two copies of the last frame, as in linear_upsample.
//  * The polynomial sine: see newt_shaper.cuh.
//  * Index arithmetic: samples are counted in 32-bit ints (the wrapper
//    refuses B*Ta > 2^30, so the strided index cannot overflow), element
//    and film offsets in 64-bit.
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

using newt::kC;
using newt::kRows;

constexpr int kThreads = 256;  // 4 samples x 64 channels per block pass
constexpr int kSamplesPerPass = kThreads / kC;

__global__ void __launch_bounds__(kThreads)
film_shaper_cr_kernel(const float* __restrict__ exciter,
                      const float* __restrict__ film,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int n_samples, int ta, int tc,
                      int hop) {
  __shared__ float sw[kRows * kC];
  newt::stage_weights(sw, weights, kThreads);
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int stride = gridDim.x * kSamplesPerPass;

  for (int s = blockIdx.x * kSamplesPerPass + threadIdx.x / kC; s < n_samples;
       s += stride) {
    const int b = s / ta;
    float f[4];  // gamma_in, beta_in, gamma_out, beta_out
    newt::film_at(film + static_cast<long long>(b) * tc * (4 * kC), s - b * ta, hop, tc, c, f);
    const long long e = static_cast<long long>(s) * kC + c;
    const float y = newt::shaper(f[0] * exciter[e] + f[1], sw, c);
    out[e] = f[2] * y + f[3];
  }
}

}  // namespace

// exciter (B, Ta, 64), film (B, Tc, 256) at control rate, weights (170, 64)
// and out (B, Ta, 64): contiguous float32 on the current device, Ta = Tc*hop.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_cr_forward(const float* exciter, const float* film,
                                     const float* weights, float* out,
                                     int n_samples, int ta, int tc, int hop,
                                     void* stream) {
  if (n_samples <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_cr_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed =
      (static_cast<long long>(n_samples) + kSamplesPerPass - 1) / kSamplesPerPass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  film_shaper_cr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, film, weights, out, n_samples, ta, tc, hop);
  return static_cast<int>(cudaGetLastError());
}
