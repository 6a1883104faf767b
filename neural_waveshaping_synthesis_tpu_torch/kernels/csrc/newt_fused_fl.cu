// Audio-rate FiLM -> sine-shaper bank -> FiLM, forward: float32 arithmetic
// on float32 or bfloat16 I/O.
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
//         newt_shaper.cuh (shaper_n);
//   out = gamma_out * y + beta_out, film[s, 128 + c] and film[s, 192 + c].
//
// What bounds it on an H100: arithmetic. Per (sample, channel) it does 25
// polynomial sines and the MLP's 144 multiply-adds, 743 operations
// counting an FMA as two, against 24 bytes moved (exciter, four FiLM
// floats, output): ~31 operations per byte against a ridge of ~20, so FP32
// ALU throughput bounds it, with memory not far behind (at B=8, Ta=65536:
// 0.372 ms of operations, 0.240 ms of bytes). In practice the instruction
// issue rate binds first: the sines' range reductions and the integer and
// address work around the FMAs take issue slots too.
//
// What the design does about it: kernel 1's (newt_fused_cr.cu), with the
// FiLM read per sample instead of lerped. A thread owns channel c and kS = 4
// consecutive samples of the flat (B*Ta) index (a group); lanes are
// channels, so each sample's exciter, four FiLM and output accesses of a
// warp are 128-byte coalesced. newt::film_shaper_fl_n reads the group's
// FiLM and runs newt::shaper_n, which reads each weight once for the
// group's four samples from the channel-major rows in shared memory (kLd =
// 172 floats a channel; 43 conflict-free ld.shared.v4 per group). Those
// volatile loads stay in the loop, where plain loads let the compiler hoist
// all 170 weights into 203 registers and fit one 8-warp block per SM;
// __launch_bounds__(256, 3) holds three 256-thread blocks per SM at 80
// registers. A grid of what fits on the card at once strides over the
// groups, so each block stages the weights once. Loading the next group's
// exciter and FiLM before shaping this one, streaming loads and 2 samples a
// thread measured no faster in turns (scripts/torch_fl_lookup_variants.py,
// PERF.md §6). Not yet done: packed f32x2 FMA, fewer instructions in the
// sines' range reductions.
//
// Exactness, as kernel 1: no --use_fast_math, rintf for the range
// reduction (newt_shaper.cuh). Every sample takes film_shaper_cr_n's
// operations in its order, so fed linear_upsample of a control-rate FiLM
// it computes kernel 1's bits from that FiLM. The ragged last group (B*Ta
// not a multiple of kS) computes its missing samples from zeros and stores
// nothing for them; groups may straddle clips. Samples are counted in
// 32-bit ints (the wrapper refuses B*Ta > 2^30, so the strided index cannot
// overflow), offsets in 64-bit.
//
// Mixed precision (the model's compute_dtype = "bfloat16"), as kernel 1: the
// kernel is a template on T, the type of the exciter, the FiLM and the
// output, in two instances, (float) and (bf16). JAX's audio-rate kernel takes
// its FiLM in the exciter's dtype (the "full_lane_cr" fallback hands it the
// bf16 FiLM too; cr_film_f32 applies to the control-rate kernel only), so
// there is no mixed instance. A bf16 exciter sample and each of its four FiLM
// values are widened exactly as they are loaded (2-byte loads; lanes are
// channels, so a warp's access is 64 coalesced bytes), film_shaper_fl_n runs
// unchanged in float32, and the output is rounded once, to nearest even, as
// it is stored. The JAX kernel rounds its FiLM planes and each shaper layer to
// bf16 instead (ROADMAP.md, deviations). The weights stay the float32 (170,
// 64) planes: under bf16 the wrapper packs exact float32 copies of the
// bf16-rounded shaper weights. Each instance asks for its own occupancy.
// ptxas (sm_90a): the bf16 instance 80 registers, 8 bytes of spill stores,
// 44,032 B, three blocks per SM, as the float32 one (80, no spills); on an
// H100 the two run level at (8, 65536, 64) (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

using newt::kC;

constexpr int kThreads = 256;
constexpr int kGroupsPerPass = kThreads / kC;  // 4 groups of kS samples per block pass
constexpr int kS = 4;                          // samples per thread (a group)

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
film_shaper_fl_kernel(const T* __restrict__ exciter,
                      const T* __restrict__ film,
                      const float* __restrict__ weights,
                      T* __restrict__ out, int n_samples) {
  __shared__ __align__(16) float sw[kC * newt::kLd];
  newt::stage_weight_rows(sw, weights, kThreads);
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int n_groups = (n_samples + kS - 1) / kS;
  const int stride = gridDim.x * kGroupsPerPass;

  for (int g = blockIdx.x * kGroupsPerPass + threadIdx.x / kC; g < n_groups; g += stride) {
    const int s0 = g * kS;
    float x[kS], y[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i)
      x[i] = s0 + i < n_samples
                 ? newt::load_f32(exciter + static_cast<long long>(s0 + i) * kC + c)
                 : 0.0f;
    newt::film_shaper_fl_n<kS>(x, film, s0, n_samples, sw, c, y);
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (s0 + i < n_samples) newt::store_as(out + static_cast<long long>(s0 + i) * kC + c, y[i]);
  }
}

template <typename T>
int launch(const T* exciter, const T* film, const float* weights, T* out, int n_samples,
           void* stream) {
  if (n_samples <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_fl_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_groups = (static_cast<long long>(n_samples) + kS - 1) / kS;
  const long long needed = (n_groups + kGroupsPerPass - 1) / kGroupsPerPass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  film_shaper_fl_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, film, weights, out, n_samples);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// exciter and out (B, Ta, 64), film (B, Ta, 256) at audio rate, weights
// (170, 64): contiguous on the current device, n_samples = B*Ta; the weights
// float32, the others float32 here and bfloat16 in the instance below.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_fl_forward(const float* exciter, const float* film,
                                     const float* weights, float* out,
                                     int n_samples, void* stream) {
  return launch(exciter, film, weights, out, n_samples, stream);
}

extern "C" int newt_fused_fl_forward_bf16(const __nv_bfloat16* exciter,
                                          const __nv_bfloat16* film, const float* weights,
                                          __nv_bfloat16* out, int n_samples, void* stream) {
  return launch(exciter, film, weights, out, n_samples, stream);
}
