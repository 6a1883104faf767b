// Exciter-fused synthesis, forward: harmonic bank -> H -> 64 mixer ->
// control-rate FiLM -> sine-shaper bank -> FiLM, and for xfull NEWT's 64 -> 1
// output mix, in one pass; float32 arithmetic on float32 or bfloat16 I/O.
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
//             control rate, FiLM, the shaper, FiLM);
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
// Design: kernel 1's group (newt_fused_cr.cu), fed by a bank tile. A block's
// 64-thread groups each own kS = 4 consecutive samples of the flat (B, Ta)
// index a pass, thread c channel c of them; a persistent grid (what is
// resident) strides over the groups. Per pass a group
//   1. builds its samples' H <= 128 harmonics into a shared (128, kS) tile,
//      thread c harmonics c+1 and c+65 of each sample (newt::fill_bank_tile,
//      one 16-B store a row);
//   2. meets at its own named barrier (bar.sync 1 + group, 64 threads): no
//      group waits for another;
//   3. mixes channel c for its kS samples (newt::mix): per harmonic one read
//      of the mixer, staged channel fastest (conflict-free), and one
//      broadcast 16-B read of the tile's row serve kS multiply-adds;
//   4. runs newt::film_shaper_cr_n, kernel 1's routine: the control-rate
//      FiLM lerp, FiLM, newt::shaper_n (each weight read once for the kS
//      samples from the channel-major rows) and FiLM;
//   5. xcr stores its kS outputs; xfull reduces each sample's 64 products in
//      a fixed order, a shuffle tree in each of the group's two warps (kS
//      trees of 5 shuffles), then warp 0 + warp 1 through shared memory after
//      a second group barrier.
// A group's second barrier (xcr's right after the mix) also tells it that
// the tile is read, so the next pass may write it: two barriers a pass. The
// parent ran one thread per (sample, channel) with a block barrier twice per
// 4 samples, and read the 170 weights and the 101-float bank row and mixer
// column as scalars for every pair: ~374 shared-memory instructions per 32
// pairs, now ~95 wavefronts.
//
// Geometry: 384-thread blocks (six groups) sharing one staged copy of the
// weights and the mixer, two blocks (24 warps) per SM: 44,032 B of shaper
// rows + 32 KB of mixer + 12 KB of tiles (89,280 B, dynamic, above 48 KB)
// a block, and __launch_bounds__(384, 2) holds a thread to 80 registers.
// Timed in turns against 256-thread blocks (two per SM, 127 registers) and
// 512-thread ones (two per SM, 64 registers and spills), 8 samples a
// thread, two tiles a group by pass (one barrier a pass for xcr; level) and
// a channel-major mixer read 4 harmonics a load
// (scripts/torch_cr_fwd_variants.py; PERF.md §6, kernel 7).
//
// Exactness: the bank as newt_bank.cuh says, the mix in x @ w + b's order (k
// ascending, then + bias), the FiLM lerp kernel 1's newt::film_at (one
// __fdiv_rn weight per sample, an uncontracted lerp, the head clamp as w =
// 0); no --use_fast_math. A sample's bits do not depend on its slot in a
// group. Samples are counted in 32-bit ints (the wrapper refuses B*Ta >
// 2^30), element offsets in 64-bit.
//
// Mixed precision (the model's compute_dtype = "bfloat16"): the kernel is a
// template on TM, the type of the mixer (w, b, and xfull's w_out) and of the
// output, and TF, the type of the control-rate FiLM, as kernel 1 is on its
// exciter and FiLM. Three instances: (float, float), (bf16, bf16) and (bf16,
// float), the NEWT.cr_film_f32 call. phase, f0 and the offsets are float32
// always (JAX casts phase and f0 to float32 too), and the shaper weights are
// the float32 planes (exact copies of the bf16-rounded weights). A bf16
// mixer entry, bias or FiLM value is widened exactly as it is loaded
// (newt::load_f32), the bank tile, the mix, the chain and xfull's warp sums
// run in float32 as above, and the output is rounded once, to nearest even,
// as it is stored (newt::store_as). The JAX kernel rounds the in-kernel
// exciter and its FiLM planes to bf16 instead; the port keeps float32 between
// load and store (ROADMAP.md, deviations).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "newt_bank.cuh"

namespace {

using newt::kC;
using newt::kMaxHarmonics;

constexpr int kThreads = 384;
constexpr int kGroups = kThreads / kC;  // 64-thread groups a block
constexpr int kS = 4;                   // samples a group holds (a thread: kS of its channel)
constexpr int kTile = kMaxHarmonics * kS;
// shaper rows, mixer, a bank tile and xfull's (2 warps, kS) sums a group
constexpr size_t kSmemBytes =
    static_cast<size_t>(kC * newt::kLd + kMaxHarmonics * kC + kGroups * kTile +
                        kGroups * 2 * kS) * sizeof(float);

// the 64 threads of group g meet (barrier 1 + g; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" : : "r"(1 + g), "n"(kC) : "memory");
}

template <bool kOutMix, typename TM, typename TF>
__global__ void __launch_bounds__(kThreads, 2)
bank_film_shaper_x_kernel(const float* __restrict__ phase, const float* __restrict__ f0,
                          const float* __restrict__ offsets, const TF* __restrict__ film,
                          const TM* __restrict__ mixer_w, const TM* __restrict__ mixer_b,
                          const float* __restrict__ weights, const TM* __restrict__ w_out,
                          TM* __restrict__ out, int n_samples, int ta, int tc, int hop,
                          int n_harm, float half_sr) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                            // (64, kLd) shaper rows
  float* smw = sw + kC * newt::kLd;            // (H, 64) mixer w
  float* stiles = smw + kMaxHarmonics * kC;    // (kGroups, 128, kS) bank tiles
  float* ssums = stiles + kGroups * kTile;      // (kGroups, 2, kS) xfull warp sums
  newt::stage_weight_rows(sw, weights, kThreads);
  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads)
    smw[i] = newt::load_f32(mixer_w + i);
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int grp = threadIdx.x / kC;
  const float off_lo = c < n_harm ? offsets[c] : 0.0f;
  const float off_hi = c + kC < n_harm ? offsets[c + kC] : 0.0f;
  const float bias = newt::load_f32(mixer_b + c);
  const float wo = kOutMix ? newt::load_f32(w_out + c) : 0.0f;
  const int n_groups = (n_samples + kS - 1) / kS;
  const int stride = gridDim.x * kGroups;
  float* tile = stiles + grp * kTile;
  float* sums = ssums + grp * 2 * kS;

  for (int g = blockIdx.x * kGroups + grp; g < n_groups; g += stride) {
    const int s0 = g * kS;
    newt::fill_bank_tile<kS>(tile, phase, f0, s0, n_samples, off_lo, off_hi, c, n_harm, half_sr);
    group_sync(grp);
    float exc[kS], y[kS];
    newt::mix<kS>(tile, smw, c, n_harm, bias, exc);
    if (!kOutMix) group_sync(grp);  // the tile is read: the next pass may write it
    newt::film_shaper_cr_n<kS>(exc, film, s0, n_samples, ta, tc, hop, sw, c, y);
    if (!kOutMix) {
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (s0 + i < n_samples)
          newt::store_as(out + static_cast<long long>(s0 + i) * kC + c, y[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        float v = y[i] * wo;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (c % 32 == 0) sums[(c / 32) * kS + i] = v;
      }
      group_sync(grp);  // the sums are written and the tile read
      if (c < kS && s0 + c < n_samples) newt::store_as(out + s0 + c, sums[c] + sums[kS + c]);
    }
  }
}

template <bool kOutMix, typename TM, typename TF>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bank_film_shaper_x_kernel<kOutMix, TM, TF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bank_film_shaper_x_kernel<kOutMix, TM, TF>, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

template <typename TM, typename TF>
int launch(const float* phase, const float* f0, const float* offsets, const TF* film,
           const TM* mixer_w, const TM* mixer_b, const float* weights, const TM* w_out, TM* out,
           int n_samples, int ta, int tc, int hop, int n_harm, int blocks, float half_sr,
           void* stream) {
  if (n_samples <= 0 || blocks <= 0 || n_harm < 2 || n_harm > kMaxHarmonics)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_out != nullptr)
    bank_film_shaper_x_kernel<true, TM, TF><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta, tc,
        hop, n_harm, half_sr);
  else
    bank_film_shaper_x_kernel<false, TM, TF><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta, tc,
        hop, n_harm, half_sr);
  return static_cast<int>(cudaGetLastError());
}

using bf16 = __nv_bfloat16;

}  // namespace

// The number of forward blocks resident on the current device at once (SMs
// x blocks per SM), for xcr and for xfull, one query per instance (the
// suffix as newt_fused_x_forward's); each also allows its kernel the dynamic
// shared memory there, so call it once per device before the instance's
// first launch. The caller launches min(this, ceil(B*Ta / 24)) blocks (24
// samples a block pass: kernels/newt_fused.py _SAMPLES_PER_PASS). Returns
// -(CUDA error) on failure.
extern "C" int newt_fused_xcr_resident_blocks() { return resident_blocks<false, float, float>(); }
extern "C" int newt_fused_xfull_resident_blocks() { return resident_blocks<true, float, float>(); }
extern "C" int newt_fused_xcr_resident_blocks_bf16() {
  return resident_blocks<false, bf16, bf16>();
}
extern "C" int newt_fused_xfull_resident_blocks_bf16() {
  return resident_blocks<true, bf16, bf16>();
}
extern "C" int newt_fused_xcr_resident_blocks_bf16_f32() {
  return resident_blocks<false, bf16, float>();
}
extern "C" int newt_fused_xfull_resident_blocks_bf16_f32() {
  return resident_blocks<true, bf16, float>();
}

// phase, f0 (B, Ta) with the phase wrapped to [0, tau); offsets (H,); film
// (B, Tc, 256) at control rate; mixer_w (H, 64), mixer_b (64,); weights
// (170, 64); w_out (64,) for xfull or null for xcr; out (B, Ta) for xfull,
// (B, Ta, 64) for xcr: contiguous on the current device, Ta = Tc*hop, 2 <= H
// <= 128, half_sr = sample rate / 2. All float32 here; in the two instances
// below the mixer, w_out and out are bfloat16 (the film too in _bf16, not in
// _bf16_f32), phase, f0, offsets and weights float32 always. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_x_forward(const float* phase, const float* f0, const float* offsets,
                                    const float* film, const float* mixer_w,
                                    const float* mixer_b, const float* weights,
                                    const float* w_out, float* out, int n_samples, int ta,
                                    int tc, int hop, int n_harm, int blocks, float half_sr,
                                    void* stream) {
  return launch(phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta,
                tc, hop, n_harm, blocks, half_sr, stream);
}

extern "C" int newt_fused_x_forward_bf16(const float* phase, const float* f0,
                                         const float* offsets, const bf16* film,
                                         const bf16* mixer_w, const bf16* mixer_b,
                                         const float* weights, const bf16* w_out, bf16* out,
                                         int n_samples, int ta, int tc, int hop, int n_harm,
                                         int blocks, float half_sr, void* stream) {
  return launch(phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta,
                tc, hop, n_harm, blocks, half_sr, stream);
}

extern "C" int newt_fused_x_forward_bf16_f32(const float* phase, const float* f0,
                                             const float* offsets, const float* film,
                                             const bf16* mixer_w, const bf16* mixer_b,
                                             const float* weights, const bf16* w_out, bf16* out,
                                             int n_samples, int ta, int tc, int hop, int n_harm,
                                             int blocks, float half_sr, void* stream) {
  return launch(phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, out, n_samples, ta,
                tc, hop, n_harm, blocks, half_sr, stream);
}
