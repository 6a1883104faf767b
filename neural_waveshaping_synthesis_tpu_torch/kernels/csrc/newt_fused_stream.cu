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
// What the design does about it. A thread owns channel c and kS = 4
// consecutive samples (a group); lanes are channels, so each sample's
// exciter, film and output accesses of a warp are 128-byte coalesced. The
// weights sit in shared memory as the channel-major rows that the lane-sum
// backwards read (newt_shaper.cuh, kLd = 172 floats a channel), and
// newt::shaper_n reads each of them once for the group's four samples, four
// at a time (43 ld.shared.v4 per group, conflict-free), which then run as
// four independent chains. The group's sample, buffer and frame indices are
// divided out once and stepped from sample to sample. A grid of what fits on
// the card at once strides over the groups, so each block stages the
// weights once. The (B, Ta, 256) audio-rate film never exists: the ramp is
// computed in registers.
//
// Registers set the pace. With plain loads the compiler hoists all 170
// weights out of the group loop (they do not change in it) into registers:
// one thread per (sample, channel) took 206 registers, one 8-warp block per
// SM, and issued at under half the card's rate; four samples under a
// register cap spilled them instead. The volatile loads of lds4/lds8 stay in
// the loop: 80 registers, three 256-thread blocks (24 warps) per SM. The
// choices (1, 2, 3, 4 or 8 samples a thread; 2, 3 or 4 blocks; scalar loads
// of the (170, 64) planes, this layout or one of its own) were timed in turns
// by scripts/torch_ab_bwd.py --kernel stream (PERF.md §6, kernel 3).
//
// Where the numbers would trip, and what holds them:
//  * The ramp is bit-exact to segment_interp: t is ONE IEEE f32 division of
//    exact integers, (o+1)/hop, via __fdiv_rn (no --use_fast_math, which
//    would make division approximate), and start + (end - start) * t is
//    written with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc's default FMA
//    contraction cannot fuse it. Note the form differs from the cr kernel's
//    left*(1-w) + right*w: the two round differently. Each sample takes its
//    own frame pair and its own division, also in a group that straddles a
//    segment or a buffer.
//  * A sample's bits do not depend on its place in a group (shaper_n treats
//    every slot alike), so two buffers give the bits of one at any cut. The
//    ragged last group (B*Ta not a multiple of kS) computes its missing
//    samples from zeros and stores nothing for them: no other code path.
//  * Index arithmetic: samples are counted in 32-bit ints (the wrapper
//    refuses B*Ta > 2^30), element and film offsets in 64-bit.
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

using newt::kC;

constexpr int kThreads = 256;
constexpr int kGroupsPerPass = kThreads / kC;  // 4 groups of kS samples per block pass
constexpr int kS = 4;                          // samples per thread (a group)
constexpr int kFilm = 4 * kC;                  // floats per FiLM frame

__device__ __forceinline__ float ramp_exact(float start, float end, float t) {
  return __fadd_rn(start, __fmul_rn(__fsub_rn(end, start), t));
}

__global__ void __launch_bounds__(kThreads, 3)
film_shaper_stream_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ prev_film,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          float* __restrict__ out, int n_samples, int k, int hop) {
  __shared__ __align__(16) float sw[kC * newt::kLd];
  newt::stage_weight_rows(sw, weights, kThreads);
  __syncthreads();

  const int c = threadIdx.x % kC;
  const float den = static_cast<float>(hop);
  const int n_groups = (n_samples + kS - 1) / kS;
  const int stride = gridDim.x * kGroupsPerPass;

  for (int g = blockIdx.x * kGroupsPerPass + threadIdx.x / kC; g < n_groups; g += stride) {
    const int s0 = g * kS;
    // frame f = s / hop counts the B*K frames of all buffers in a row
    const int f = s0 / hop;
    int o = s0 - f * hop;
    int b = f / k;
    int m = f - b * k;
    float x[kS], g_out[kS], b_out[kS], y[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      x[i] = g_out[i] = b_out[i] = 0.0f;
      if (s0 + i < n_samples) {
        const float w = __fdiv_rn(static_cast<float>(o + 1), den);
        const float* fe = film + (static_cast<long long>(b) * k + m) * kFilm + c;
        const float* fs = m == 0 ? prev_film + static_cast<long long>(b) * kFilm + c
                                 : fe - kFilm;
        const float g_in = ramp_exact(fs[0], fe[0], w);
        const float b_in = ramp_exact(fs[kC], fe[kC], w);
        g_out[i] = ramp_exact(fs[2 * kC], fe[2 * kC], w);
        b_out[i] = ramp_exact(fs[3 * kC], fe[3 * kC], w);
        x[i] = g_in * exciter[static_cast<long long>(s0 + i) * kC + c] + b_in;
      }
      if (++o == hop) {
        o = 0;
        if (++m == k) {
          m = 0;
          ++b;
        }
      }
    }
    newt::shaper_n<kS>(x, sw, c, y);
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (s0 + i < n_samples) out[static_cast<long long>(s0 + i) * kC + c] = g_out[i] * y[i] + b_out[i];
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
// groups of kS samples need) blocks on `stream` and returns
// cudaGetLastError() (0 = launched). ta is implied by k and hop; the
// interface keeps it.
extern "C" int newt_fused_stream_forward(const float* exciter, const float* prev_film,
                                         const float* film, const float* weights,
                                         float* out, int n_samples, int ta, int k,
                                         int hop, int blocks, void* stream) {
  if (n_samples <= 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = (n_samples + kS - 1) / kS;
  const int needed = (n_groups + kGroupsPerPass - 1) / kGroupsPerPass;
  const int grid = needed < blocks ? needed : blocks;
  film_shaper_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, prev_film, film, weights, out, n_samples, k, hop);
  return static_cast<int>(cudaGetLastError());
}
