// Control-rate FiLM -> sine-shaper bank -> FiLM, backward: float32 arithmetic
// on float32 or bfloat16 I/O.
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
// What bounds it on an H100. The arithmetic is 1.72 kFLOP per (sample,
// channel) (the forward redone with a cosine beside each of the 25 sines,
// then the chain rule with its 170 weight-gradient products) against 12
// bytes of exciter, dy and d_exciter: 0.84 ms at B=8, Tc=500, hop=128. What
// limits it is instruction issue. Per 32 (sample, channel) pairs (one
// channel's pass over 32 lanes) the loop body is 1,687 SASS instructions:
// the arithmetic 682 FFMA, 222 FMUL, 161 FADD and 25 FRND; the lane sums 186
// SHFL and 213 FSEL; 86 weight loads (ld.shared.v4), 8 shared stores, 9
// global loads and ~80 integer and branch instructions. At one instruction
// a cycle per scheduler that is ~420 cycles per SM; it runs at ~580 (2.3 ms).
// A per-thread 170-float gradient slot in shared memory, the earlier design,
// cost ~654 shared-memory instructions per 32 pairs (170 read-modify-writes
// beside the weight reads) and left room for one 8-warp block per SM; this
// one issues 280 (SHFL, LDS, STS).
//
// ptxas (sm_90a): 128 registers, 8 bytes of spill stores and loads, 107,776 B
// of dynamic shared memory: two 8-warp blocks per SM, 264 on an H100. A
// group layout without the spill and one 8-warp block per SM at 163
// registers measured slower, one 16-warp block per SM no faster (PERF.md).
//
// Design:
//  * Lanes are samples, a warp is a channel. A persistent grid (what fits on
//    the card at once) of 8-warp blocks walks over control segments (b, m)
//    of hop samples, one segment per block at a time, strided by the grid.
//    Each warp owns 8 fixed channels; for each chunk of 32 samples of the
//    segment it runs those channels in turn, lane l holding sample 32j + l.
//    Lanes past the segment's end (hop not a multiple of 32) recompute its
//    last sample with a zero cotangent and zero exciter: every term they add
//    is an exact zero, and they write nothing.
//  * Weights as warp-uniform broadcasts and the 170 weight-gradient terms
//    summed across lanes into a per-block (64, 172) gradient table:
//    newt_lanes_bwd.cuh (shared with kernel 8), whose last lane-sum group
//    takes the 12 FiLM cotangent slots here.
//  * Coalesced tiles: each 32-sample x 64-channel chunk of exciter and dy is
//    staged in shared memory by the block with coalesced loads (rows padded
//    to 65 floats, so a warp's column read hits 32 banks); d_exciter goes back
//    into the exciter tile and out with coalesced stores.
//  * FiLM cotangents: newt::FilmSegment gives each lane's lerp (at(), bit for
//    bit the forward's) and its transpose (add()) into the segment's 12
//    slots; those join the last group's lane sum, are added across the
//    segment's chunks in order in shared memory, and the last chunk stores
//    the segment's (3, 256) partial.
//  * Cross-block sums (the TPU accumulated into one resident block across
//    its sequential grid; Hopper blocks run in parallel, in no order):
//    deterministic per-block partials plus a second pass, no atomics, so two
//    calls give the same bits. Each block writes its table as one (170, 64)
//    partial in plane order; newt::sum_weight_partials adds the partials in
//    block order and newt::fold_film_partials adds, for frame f, segment
//    f-1's slot 2, segment f's slot 1 and segment f+1's slot 0, in that
//    order (the analogue of _unwindow_dfilm).
//  * Occupancy: at most 128 registers a thread and 107,776 B of shared
//    memory, so two blocks (16 warps) per SM.
//
// Exactness, as the forward: the recomputed FiLM lerp is the forward's,
// bit for bit (one __fdiv_rn weight, __fmul_rn/__fadd_rn lerp, head clamp
// as w = 0); no --use_fast_math; rintf for the range reduction; the
// gradient's lerp weights are the same w and 1-w. The sums run in another
// order than the plain version's, so d_planes and d_film differ from it by
// rounding.
//
// Mixed precision: the kernel is a template on TE (exciter, dy, d_exciter)
// and TF (FiLM, d_film), in the instances of newt_fused_cr.cu: (float,
// float), (bf16, bf16) and (bf16, float). The tiles in shared memory, the
// FiLM segment, the recompute and every sum stay float32: a bf16 exciter, dy
// or FiLM frame is widened as it is loaded, d_exciter is rounded once as it
// leaves its tile, and d_film once as the fold stores it (the FiLM partials
// are float32 scratch). d_planes stays float32, as the JAX kernel keeps its
// weight gradients ("f32 whatever the activation dtype"); the wrapper's
// autograd rounds it to the shaper leaves' dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "newt_lanes_bwd.cuh"

namespace {

using newt::kC;
using newt::kFilmSlots;
using newt::kLanes;
using newt::kLastTerms;
using newt::kLd;
using newt::kPlane;
using newt::kPW1;
using newt::kTileLd;
using newt::lane_sum;
using newt::row_pos;
using newt::shaper_backward_lanes;
using newt::smem_addr;
using newt::woff;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
constexpr int kChanPerWarp = kC / kWarps;
// weights and gradient table (64, 172) each, exciter and dy tiles (32, 65)
// each, the FiLM slots' sums across chunks (64, 12)
constexpr size_t kSmemBytes =
    static_cast<size_t>(2 * kC * kLd + 2 * kLanes * kTileLd + kC * kFilmSlots) * sizeof(float);

template <typename TE, typename TF>
__global__ void __launch_bounds__(kThreads, 2)
film_shaper_cr_bwd_kernel(const TE* __restrict__ exciter,
                          const TF* __restrict__ film,
                          const float* __restrict__ weights,
                          const TE* __restrict__ dy,
                          TE* __restrict__ d_exciter,
                          float* __restrict__ film_part,
                          float* __restrict__ w_part, int n_seg, int tc,
                          int hop) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // (64, 172) weights
  float* sg = sw + kC * kLd;                     // (64, 172) weight-gradient sums
  float* se = sg + kC * kLd;                     // (32, 65) exciter in, d_exciter out
  float* sdy = se + kLanes * kTileLd;            // (32, 65) dy
  float* sfilm = sdy + kLanes * kTileLd;         // (64, 12) FiLM slot sums
  for (int i = threadIdx.x; i < kC * kLd; i += kThreads) sw[i] = sg[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    sw[(i - k * kC) * kLd + row_pos(k)] = weights[i];
  }
  __syncthreads();

  const unsigned sw_addr = smem_addr(sw);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_chunk = (hop + kLanes - 1) / kLanes;
  long long pend_base = 0;  // the d_exciter tile not yet written back
  int pend_n = 0;

  for (int seg = blockIdx.x; seg < n_seg; seg += gridDim.x) {
    const int b = seg / tc;
    const int m = seg - b * tc;
    const TF* clip = film + static_cast<long long>(b) * tc * (4 * kC);
    for (int j = 0; j < n_chunk; ++j) {
      const int o0 = j * kLanes;
      const int n = min(kLanes, hop - o0) * kC;
      const long long base = (static_cast<long long>(seg) * hop + o0) * kC;
      for (int i = threadIdx.x; i < kLanes * kC; i += kThreads) {
        const int t = (i / kC) * kTileLd + i % kC;
        if (i < pend_n) newt::store_as(d_exciter + pend_base + i, se[t]);
        if (i < n) {
          se[t] = newt::load_f32(exciter + base + i);
          sdy[t] = newt::load_f32(dy + base + i);
        }
      }
      __syncthreads();

      const int o = o0 + lane;
      const bool active = o < hop;
      for (int q = 0; q < kChanPerWarp; ++q) {
        const int c = warp * kChanPerWarp + q;
        newt::FilmSegment fs;
        fs.load(clip, m, tc, hop, c);
        float film_a[4], w, omw;
        bool lo;
        fs.at(active ? o : hop - 1, film_a, &w, &omw, &lo);
        const float g_in = film_a[0], b_in = film_a[1], g_out = film_a[2];
        const float xin = active ? se[lane * kTileLd + c] : 0.0f;
        const float g = active ? sdy[lane * kTileLd + c] : 0.0f;
        const float x = g_in * xin + b_in;
        float y, dx, t[kLanes];
        shaper_backward_lanes(x, g * g_out, sw_addr + woff(c * kLd), sg + c * kLd, lane, t, &y,
                              &dx);
        if (active) se[lane * kTileLd + c] = dx * g_in;

        // FiLM cotangents (d gamma_in, d beta_in, d gamma_out, d beta_out)
        const float d_film[4] = {dx * xin, dx, g * y, g};
        fs.add(d_film, w, omw, lo);
#pragma unroll
        for (int k = 0; k < kFilmSlots; ++k) t[kLastTerms + k] = fs.slot[k / 4][k % 4];
#pragma unroll
        for (int k = kLastTerms + kFilmSlots; k < kLanes; ++k) t[k] = 0.0f;
        const float s = lane_sum(t, lane);
        if (lane < kLastTerms) {
          sg[c * kLd + kPW1 + lane] += s;
        } else if (lane < kLastTerms + kFilmSlots) {
          const int k = lane - kLastTerms;
          float* sum = sfilm + c * kFilmSlots + k;
          const float total = j == 0 ? s : *sum + s;
          if (j == n_chunk - 1)
            film_part[static_cast<long long>(seg) * 3 * (4 * kC) + k * kC + c] = total;
          else
            *sum = total;
        }
      }
      __syncthreads();
      pend_base = base;
      pend_n = n;
    }
  }

  for (int i = threadIdx.x; i < pend_n; i += kThreads)
    newt::store_as(d_exciter + pend_base + i, se[(i / kC) * kTileLd + i % kC]);
  float* out = w_part + static_cast<long long>(blockIdx.x) * kPlane;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    out[i] = sg[(i - k * kC) * kLd + row_pos(k)];
  }
}

// Allows an instance its dynamic shared memory on the current device and
// gives its resident blocks per SM.
template <typename TE, typename TF>
cudaError_t blocks_per_sm(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(film_shaper_cr_bwd_kernel<TE, TF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, film_shaper_cr_bwd_kernel<TE, TF>, kThreads, kSmemBytes);
  return err;
}

template <typename TE, typename TF>
int launch(const TE* exciter, const TF* film, const float* weights, const TE* dy,
           TE* d_exciter, TF* d_film, float* d_planes, float* film_part, float* w_part, int b,
           int ta, int tc, int blocks, void* stream) {
  if (b <= 0 || tc <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hop = ta / tc;
  film_shaper_cr_bwd_kernel<TE, TF><<<blocks, kThreads, kSmemBytes, s>>>(
      exciter, film, weights, dy, d_exciter, film_part, w_part, b * tc, tc, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  newt::sum_weight_partials<<<(kPlane + 255) / 256, 256, 0, s>>>(w_part, d_planes, kPlane,
                                                                  blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(newt::fold_film(film_part, d_film, b, tc, s));
}

}  // namespace

// The number of backward blocks resident on the current device at once
// (SMs x blocks per SM, the least over the three instances); it also allows
// every instance its dynamic shared memory there, so call it once per device
// before the first launch. The caller launches min(this, B*Tc) blocks (one
// control segment per block at a time) and sizes the (blocks, 170, 64)
// weight partials with it. Returns -(CUDA error) on failure.
extern "C" int newt_fused_cr_backward_resident_blocks() {
  int device = 0, sms = 0, f32 = 0, bf16 = 0, mixed = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = blocks_per_sm<float, float>(&f32);
  if (err == cudaSuccess) err = blocks_per_sm<__nv_bfloat16, __nv_bfloat16>(&bf16);
  if (err == cudaSuccess) err = blocks_per_sm<__nv_bfloat16, float>(&mixed);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = f32 < bf16 ? f32 : bf16;
  if (mixed < per_sm) per_sm = mixed;
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

// exciter, dy, d_exciter (B, Ta, 64); film, d_film (B, Tc, 256); weights,
// d_planes (170, 64); scratch film_part (B*Tc, 3, 256) and w_part
// (blocks, 170, 64), with blocks as newt_fused_cr_backward_resident_blocks
// says: contiguous on the current device, Ta = Tc*hop; float32 here, and in
// the two instances below bfloat16 for exciter, dy and d_exciter (and film
// and d_film in _bf16), the weights, d_planes and the scratch float32
// always. Launches the three kernels on `stream` and returns the first CUDA
// error (0 = launched).
extern "C" int newt_fused_cr_backward(const float* exciter, const float* film,
                                      const float* weights, const float* dy,
                                      float* d_exciter, float* d_film,
                                      float* d_planes, float* film_part,
                                      float* w_part, int b, int ta, int tc,
                                      int blocks, void* stream) {
  return launch(exciter, film, weights, dy, d_exciter, d_film, d_planes, film_part, w_part, b,
                ta, tc, blocks, stream);
}

extern "C" int newt_fused_cr_backward_bf16(const __nv_bfloat16* exciter,
                                           const __nv_bfloat16* film, const float* weights,
                                           const __nv_bfloat16* dy, __nv_bfloat16* d_exciter,
                                           __nv_bfloat16* d_film, float* d_planes,
                                           float* film_part, float* w_part, int b, int ta,
                                           int tc, int blocks, void* stream) {
  return launch(exciter, film, weights, dy, d_exciter, d_film, d_planes, film_part, w_part, b,
                ta, tc, blocks, stream);
}

extern "C" int newt_fused_cr_backward_bf16_f32(const __nv_bfloat16* exciter, const float* film,
                                               const float* weights, const __nv_bfloat16* dy,
                                               __nv_bfloat16* d_exciter, float* d_film,
                                               float* d_planes, float* film_part, float* w_part,
                                               int b, int ta, int tc, int blocks, void* stream) {
  return launch(exciter, film, weights, dy, d_exciter, d_film, d_planes, film_part, w_part, b,
                ta, tc, blocks, stream);
}
