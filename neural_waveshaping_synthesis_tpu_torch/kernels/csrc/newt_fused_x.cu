// Exciter-fused synthesis, forward, float32: harmonic bank -> H -> 64 mixer
// -> control-rate FiLM -> sine-shaper bank -> FiLM, and for xfull NEWT's
// 64 -> 1 output mix, in one pass.
//
// Replaces the TPU kernels kernels/newt_fused.py:1136
// bank_film_shaper_fused_xcr (xcr; Pallas _fwd_kernel_xcr, _exciter_il) and
// :1383 bank_newt_fused_xfull (xfull; _fwd_kernel_xfull, _out_mix) of the JAX
// package: one template, kOutMix the compile-time flag for the output mix.
// pack_pf's row pairs, the 128-lane offsets and tiled bias and the "tile =
// 2 hops" geometry were Mosaic layouts and are gone: phase and f0 come in as
// (B, Ta), offsets (H,), the mixer as w (H, 64) and b (64,), w_out (64,).
//
// What it computes, for audio sample s = m*hop + o of clip b and channel c:
//   bank[k] = sin(phase[s]*k + offsets[k-1]) for k = 1..H, zero where
//             f0[s]*k >= sr/2 (newt_bank.cuh; the phase is already wrapped
//             to [0, tau));
//   exc     = sum_k bank[k] * w[k-1, c] + b[c];
//   pre     = kernel 1's chain on exc (newt_fused_cr.cu: the FiLM lerp at
//             control rate, FiLM, newt::shaper, FiLM);
//   xcr:   out[b, t, c] = pre;   xfull: out[b, t] = sum_c pre * w_out[c]
//          (the output mix's bias is added outside, as in JAX).
//
// What bounds it on an H100: arithmetic. Per (sample, channel) it does
// kernel 1's ~757 operations, the mix's H multiply-adds (202 at H = 101) and
// 2 of the sample's bank sines (~20 each, an FMA as two), against 8 bytes of
// phase and f0 per sample and 4 bytes of output per element (xcr; xfull 4
// bytes per sample): the (B, Ta, H) bank and the (B, Ta, 64) exciter never
// reach device memory. At 67 TFLOP/s the bound is ~1,000 operations per
// element, ~0.50 ms at 8 x 4 s.
//
// Design: kernel 1's layout, one thread per (sample, channel), channels
// fastest, 256 threads = 4 samples per pass, a persistent grid (what is
// resident) striding over the samples. Per pass the 64 threads of a sample
// compute its H <= 128 harmonics together, two each, into a shared (4, 128)
// bank; after a barrier each thread mixes its channel from the bank row
// (a broadcast read) and the mixer, staged in shared memory channel fastest
// (conflict-free), then runs the chain. The pass loop's trip count is the
// same for every thread of the block and the work is guarded, so every
// thread reaches every barrier on the ragged last pass. xfull reduces each
// sample's 64 products in a fixed order: a shuffle tree in each of its two
// warps, then warp 0 + warp 1 through shared memory. Shared memory: 43.5 KB
// of shaper planes + 32 KB of mixer + 2 KB of bank (dynamic, above 48 KB).
//
// Exactness: the bank as newt_bank.cuh says; the FiLM lerp is kernel 1's
// newt::film_at (one __fdiv_rn weight, an uncontracted lerp, the head clamp
// as w = 0); no --use_fast_math. Samples are counted in 32-bit ints (the
// wrapper refuses B*Ta > 2^30), element offsets in 64-bit.
#include <cuda_runtime.h>

#include "newt_bank.cuh"

namespace {

using newt::kC;
using newt::kMaxHarmonics;
using newt::kRows;

constexpr int kThreads = 256;  // 4 samples x 64 channels per pass
constexpr int kSamplesPerPass = kThreads / kC;
constexpr int kWarps = kThreads / 32;
// shaper planes, mixer, the pass's bank rows, xfull's per-warp sums
constexpr size_t kSmemBytes =
    static_cast<size_t>(kRows * kC + kMaxHarmonics * kC + kSamplesPerPass * kMaxHarmonics +
                        kWarps) * sizeof(float);

template <bool kOutMix>
__global__ void __launch_bounds__(kThreads)
bank_film_shaper_x_kernel(const float* __restrict__ phase, const float* __restrict__ f0,
                          const float* __restrict__ offsets, const float* __restrict__ film,
                          const float* __restrict__ mixer_w, const float* __restrict__ mixer_b,
                          const float* __restrict__ weights, const float* __restrict__ w_out,
                          float* __restrict__ out, int n_samples, int ta, int tc, int hop,
                          int n_harm, float half_sr) {
  extern __shared__ float smem[];
  float* sw = smem;                                         // (170, 64) shaper planes
  float* smw = sw + kRows * kC;                             // (H, 64) mixer w
  float* sbank = smw + kMaxHarmonics * kC;                  // (4, 128) bank rows
  float* swarp = sbank + kSamplesPerPass * kMaxHarmonics;   // (8,) output-mix sums
  newt::stage_weights(sw, weights, kThreads);
  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads) smw[i] = mixer_w[i];
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int row = threadIdx.x / kC;
  float* bank = sbank + row * kMaxHarmonics;
  const float off_lo = c < n_harm ? offsets[c] : 0.0f;
  const float off_hi = c + kC < n_harm ? offsets[c + kC] : 0.0f;
  const float bias = mixer_b[c];
  const float wo = kOutMix ? w_out[c] : 0.0f;
  const int stride = gridDim.x * kSamplesPerPass;

  for (int base = blockIdx.x * kSamplesPerPass; base < n_samples; base += stride) {
    const int s = base + row;
    const bool active = s < n_samples;
    if (active) newt::fill_bank_row(bank, phase[s], f0[s], off_lo, off_hi, c, n_harm, half_sr);
    __syncthreads();

    float pre = 0.0f;
    if (active) {
      const float exc = newt::mix(bank, smw, c, n_harm, bias);
      const int b = s / ta;
      float f[4];  // gamma_in, beta_in, gamma_out, beta_out, as kernel 1
      newt::film_at(film + static_cast<long long>(b) * tc * (4 * kC), s - b * ta, hop, tc, c, f);
      const float y = newt::shaper(f[0] * exc + f[1], sw, c);
      pre = f[2] * y + f[3];
      if (!kOutMix) out[static_cast<long long>(s) * kC + c] = pre;
    }
    if (kOutMix) {  // every lane of the block takes part; a warp is one sample's
      float v = pre * wo;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (threadIdx.x % 32 == 0) swarp[threadIdx.x / 32] = v;
    }
    __syncthreads();  // the bank rows and per-warp sums are read; the next pass may write
    if (kOutMix && active && c == 0) out[s] = swarp[2 * row] + swarp[2 * row + 1];
  }
}

template <bool kOutMix>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bank_film_shaper_x_kernel<kOutMix>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bank_film_shaper_x_kernel<kOutMix>, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

}  // namespace

// The number of forward blocks resident on the current device at once (SMs
// x blocks per SM), for xcr and for xfull; each also allows its kernel the
// dynamic shared memory there, so call it once per device before the first
// launch. The caller launches min(this, ceil(B*Ta / 4)) blocks. Returns
// -(CUDA error) on failure.
extern "C" int newt_fused_xcr_resident_blocks() { return resident_blocks<false>(); }
extern "C" int newt_fused_xfull_resident_blocks() { return resident_blocks<true>(); }

// phase, f0 (B, Ta) with the phase wrapped to [0, tau); offsets (H,); film
// (B, Tc, 256) at control rate; mixer_w (H, 64), mixer_b (64,); weights
// (170, 64); w_out (64,) for xfull or null for xcr; out (B, Ta) for xfull,
// (B, Ta, 64) for xcr: contiguous float32 on the current device, Ta =
// Tc*hop, 2 <= H <= 128, half_sr = sample rate / 2. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_x_forward(const float* phase, const float* f0, const float* offsets,
                                    const float* film, const float* mixer_w,
                                    const float* mixer_b, const float* weights,
                                    const float* w_out, float* out, int n_samples, int ta,
                                    int tc, int hop, int n_harm, int blocks, float half_sr,
                                    void* stream) {
  if (n_samples <= 0 || blocks <= 0 || n_harm < 2 || n_harm > kMaxHarmonics)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_out != nullptr)
    bank_film_shaper_x_kernel<true><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta, tc,
        hop, n_harm, half_sr);
  else
    bank_film_shaper_x_kernel<false><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta, tc,
        hop, n_harm, half_sr);
  return static_cast<int>(cudaGetLastError());
}
