// Control-rate FiLM -> sine-shaper bank -> FiLM, forward: float32 arithmetic
// on float32 or bfloat16 I/O.
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
// What the design does about it: kernel 3's (newt_fused_stream.cu). A thread
// owns channel c and kS = 4 consecutive samples of the flat (B, Ta) index (a
// group); lanes are channels, so each sample's exciter, film and output
// accesses of a warp are 128-byte coalesced and nothing but the result goes
// back to memory. The weights sit in shared memory as the channel-major rows
// (newt_shaper.cuh, kLd = 172 floats a channel), and
// newt::film_shaper_cr_n, the group routine kernel 7 (newt_fused_x.cu) runs
// too, lerps each sample's FiLM in registers (the (B, Ta, 256) audio-rate
// film never exists) and runs newt::shaper_n, which reads each weight once
// for the group's four samples (43 ld.shared.v4 per group, conflict-free).
// A grid of what fits on the card at once strides over the groups, so each
// block stages the weights once.
//
// Registers set the pace. One thread per (sample, channel) with plain loads
// let the compiler hoist all 170 weights out of the sample loop into 207
// registers: one 8-warp block per SM, 29-30 % of the bound. The volatile
// loads of lds4/lds8 stay in the loop, and __launch_bounds__(256, 3) asks for
// three 256-thread blocks (24 warps) per SM, as kernel 3 runs: 80 registers
// and a few spilled bytes. Two samples a thread (76 registers, no spills)
// ran slower in turns (scripts/torch_cr_fwd_variants.py; PERF.md §6, kernel
// 1). Not yet done: packed f32x2 FMA, one FiLM frame load per group where
// its samples share a segment.
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
//    Each sample of a group takes its own frame pair and division, also in a
//    group that straddles two segments or two clips.
//  * The polynomial sine: see newt_shaper.cuh. shaper_n takes every sample
//    through the same operations in the same order, so a sample's bits do
//    not depend on its slot in a group. The ragged last group (B*Ta not a
//    multiple of kS) computes its missing samples from zeros and stores
//    nothing for them.
//  * Index arithmetic: samples are counted in 32-bit ints (the wrapper
//    refuses B*Ta > 2^30, so the strided index cannot overflow), element
//    and film offsets in 64-bit.
//
// Mixed precision (the model's compute_dtype = "bfloat16"): the kernel is a
// template on TE, the type of the exciter and the output, and TF, the type
// of the control-rate FiLM. Three instances: (float, float), (bf16, bf16)
// and (bf16, float), the NEWT.cr_film_f32 call. A bf16 exciter sample and
// FiLM frame are widened exactly to float32 as they are loaded (a plain
// 2-byte load a lane: lanes are channels, so a warp's access is 64
// coalesced bytes), the routine above runs unchanged in float32, and the
// output is rounded once, to nearest even, as it is stored. The JAX kernel
// rounds its FiLM planes and each shaper layer to bf16 instead; the port
// keeps float32 between load and store (ROADMAP.md, deviations). The
// weights stay the float32 (170, 64) planes: under bf16 the wrapper packs
// exact float32 copies of the bf16-rounded shaper weights.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

using newt::kC;

constexpr int kThreads = 256;
constexpr int kGroupsPerPass = kThreads / kC;  // 4 groups of kS samples per block pass
constexpr int kS = 4;                          // samples per thread (a group)

template <typename TE, typename TF>
__global__ void __launch_bounds__(kThreads, 3)
film_shaper_cr_kernel(const TE* __restrict__ exciter,
                      const TF* __restrict__ film,
                      const float* __restrict__ weights,
                      TE* __restrict__ out, int n_samples, int ta, int tc,
                      int hop) {
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
    newt::film_shaper_cr_n<kS>(x, film, s0, n_samples, ta, tc, hop, sw, c, y);
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (s0 + i < n_samples) newt::store_as(out + static_cast<long long>(s0 + i) * kC + c, y[i]);
  }
}

template <typename TE, typename TF>
int launch(const TE* exciter, const TF* film, const float* weights, TE* out, int n_samples,
           int ta, int tc, int hop, void* stream) {
  if (n_samples <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_cr_kernel<TE, TF>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_groups = (static_cast<long long>(n_samples) + kS - 1) / kS;
  const long long needed = (n_groups + kGroupsPerPass - 1) / kGroupsPerPass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  film_shaper_cr_kernel<TE, TF><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, film, weights, out, n_samples, ta, tc, hop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// exciter (B, Ta, 64), film (B, Tc, 256) at control rate, weights (170, 64)
// and out (B, Ta, 64): contiguous on the current device, Ta = Tc*hop; the
// weights float32, the others float32 here, and bfloat16 (the exciter and the
// output; the FiLM too in _bf16, not in _bf16_f32) in the two instances
// below. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_cr_forward(const float* exciter, const float* film,
                                     const float* weights, float* out,
                                     int n_samples, int ta, int tc, int hop,
                                     void* stream) {
  return launch(exciter, film, weights, out, n_samples, ta, tc, hop, stream);
}

extern "C" int newt_fused_cr_forward_bf16(const __nv_bfloat16* exciter,
                                          const __nv_bfloat16* film, const float* weights,
                                          __nv_bfloat16* out, int n_samples, int ta, int tc,
                                          int hop, void* stream) {
  return launch(exciter, film, weights, out, n_samples, ta, tc, hop, stream);
}

extern "C" int newt_fused_cr_forward_bf16_f32(const __nv_bfloat16* exciter, const float* film,
                                              const float* weights, __nv_bfloat16* out,
                                              int n_samples, int ta, int tc, int hop,
                                              void* stream) {
  return launch(exciter, film, weights, out, n_samples, ta, tc, hop, stream);
}
