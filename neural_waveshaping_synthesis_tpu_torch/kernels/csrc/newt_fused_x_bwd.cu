// Exciter-fused synthesis, backward: the backward of newt_fused_x.cu for xcr
// and, with the compile-time flag kOutMix, xfull; float32 arithmetic on
// float32 or bfloat16 I/O.
//
// Replaces the TPU kernels kernels/newt_fused.py:1199 _fused_bwd_xcr
// (Pallas _bwd_kernel_xcr) and :1447 _fused_bwd_xfull (_bwd_kernel_xfull) of
// the JAX package. Like them it stores nothing in the forward and recomputes
// the bank, the mix and the chain here. The even/odd half accumulators of
// the mixer gradient (dmwe/dmwo) were a Mosaic lane layout and are gone; the
// mixer gradient is, as there, a per-block product dW += bank^T . d_exc.
//
// What it computes, given phase, f0 (B, Ta), offsets (H,), control-rate film
// (B, Tc, 256), the mixer w (H, 64) and b (64,), the shaper planes (170, 64),
// w_out (64,) for xfull, and the output cotangent dy ((B, Ta, 64) for xcr;
// (B, Ta) for xfull, where the chain's cotangent is dy[s] * w_out[c]):
//   d_film (B, Tc, 256) at control rate, folded as newt_fused_cr_bwd.cu
//     folds it (film_part, then newt::fold_film_partials);
//   one (170 + H + 1 [+ 1], 64) table of sums over all B*Ta samples: the 170
//     shaper planes, dW[k, c] = sum bank[k] * d_exc[c], db[c] = sum d_exc[c]
//     and, for xfull, dw_out[c] = sum pre[c] * dy. No exciter cotangent is
//     written (the TPU kernel wrote none either); phase, f0 and offsets get
//     none.
//
// What bounds it on an H100: instruction issue, as kernel 2. Per 32 (sample,
// channel) pairs a warp runs kernel 2's ~1,690-instruction recompute and
// chain rule with its lane sums, and the block adds the two mixer products
// (the exciter's H multiply-adds and dW's H, each with about one shared load
// per two) and the bank's two sines per pair: ~2,000 instructions, against
// 8 bytes of phase and f0 per sample and 4 bytes per element of dy for xcr
// (4 per sample for xfull); the (B, Ta, H) bank and the (B, Ta, 64) exciter
// never reach device memory.
//
// Design: kernel 2's lanes as samples (newt_lanes_bwd.cuh), one 16-warp block
// per SM (the shared memory below holds one block; one 16-warp block and two
// 8-warp blocks per SM measured level for kernel 2). Measured variants, same
// bits (PERF.md): dW's product restricted to each thread's live harmonics,
// and a double-buffered bank tile without step 4's barrier, were no faster.
//  * A persistent grid of blocks walks over control segments (b, m) of hop
//    samples, one segment per block at a time, strided by the grid, in
//    chunks of 32 samples. Per chunk:
//    1. the block builds the (32, H) bank tile in shared memory with
//       newt::bank_sin (lane l is sample l, warps stride over the harmonics)
//       and stages the chunk's dy;
//    2. the exciter tile (32, 64) = bank tile . w + b, a block-wide product:
//       each thread one sample and 4 channels, each output summed over k in
//       newt::mix's order (so the recomputed exciter is kernel 7's, bit for
//       bit);
//    3. each warp runs its 4 fixed channels in turn through
//       shaper_backward_lanes, lane l holding sample 32j + l, and writes
//       d_exc back into the exciter tile. The last lane-sum group takes the
//       10 weight terms, FilmSegment's 12 FiLM slots, d_exc (db) and, for
//       xfull, (g_out * y + b_out) * dy (dw_out): 24 of 32; db and dw_out go
//       to the gradient table's padding positions 170 and 171;
//    4. dW (H, 64) += bank tile^T . d_exc tile: thread t owns harmonics
//       t/16 + 32i x channels t%16 + 16j (i, j < 4) of dW, sums its 16
//       entries over the chunk's 32 samples in order in registers and adds
//       them once to the block's (128, 64) dW table in shared memory.
//    A barrier ends each step; none is per sample. Lanes past the segment's
//    end (hop not a multiple of 32) get a zero bank row and a zero dy: every
//    term they add is an exact zero.
//  * Deterministic, no atomics: the tables are per block and every entry has
//    one owner per step; each block writes them as one partial in row order
//    (planes, dW, db, dw_out), newt::sum_weight_partials adds the partials in
//    block order and newt::fold_film_partials folds the FiLM. Two calls give
//    the same bits.
//  * Shared memory (one block per SM): weights and gradient table (64, 172)
//    each, 88,064 B; the mixer and the dW table (128, 64) each, 65,536 B; the
//    bank tile (32, 129), 16,512 B; the exciter / d_exc and dy tiles (32, 65)
//    each, 16,640 B; the FiLM slot sums (64, 12), 3,072 B; the offsets, 512 B:
//    190,336 B of the 232,448 a block may use. 512 threads: at most 128
//    registers a thread.
//
// Exactness: the bank as newt_bank.cuh says, the FiLM lerp as kernel 2's; no
// --use_fast_math. Segments and samples in 32-bit ints (the wrapper refuses
// B*Ta > 2^30), offsets in 64-bit.
//
// Mixed precision: the instances of newt_fused_x.cu's, a template on TM (the
// mixer w and b, w_out and dy) and TF (the FiLM and d_film): (float, float),
// (bf16, bf16) and (bf16, float). Each bf16 value is widened exactly where
// it is loaded (newt::load_f32): the staged mixer, the bias in step 2, the
// FiLM frames (FilmSegment), w_out, and each dy as step 1 stages it into the
// float32 dy tile (plain loads, so a bf16 dy needs no staging of its own).
// Everything after runs in float32 as above; d_film is rounded once as
// fold_film stores it, and the gradient table (planes, dW, db, dw_out) stays
// float32, rounded to the mixer's dtype by the caller (kernels/newt_fused.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "newt_bank.cuh"
#include "newt_lanes_bwd.cuh"

namespace {

using newt::kC;
using newt::kFilmSlots;
using newt::kLanes;
using newt::kLastTerms;
using newt::kLd;
using newt::kMaxHarmonics;
using newt::kPlane;
using newt::kPW1;
using newt::kTileLd;
using newt::lane_sum;
using newt::row_pos;
using newt::shaper_backward_lanes;
using newt::smem_addr;
using newt::woff;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kLanes;
constexpr int kChanPerWarp = kC / kWarps;
constexpr int kBankLd = kMaxHarmonics + 1;  // a bank tile's row, padded
constexpr int kPB = newt::kRows;            // the mixer bias's position in a channel's row
constexpr int kPWo = newt::kRows + 1;       // the output-mix weight's
constexpr int kQuads = kC / 4;              // product threads per sample / harmonic group
constexpr size_t kSmemBytes =
    static_cast<size_t>(2 * kC * kLd + 2 * kMaxHarmonics * kC + kLanes * kBankLd +
                        2 * kLanes * kTileLd + kC * kFilmSlots + kMaxHarmonics) * sizeof(float);
static_assert(kThreads == kLanes * kQuads, "product A: one thread per (sample, 4 channels)");
static_assert(kThreads * 4 == kMaxHarmonics * kQuads, "product B: 16 dW entries a thread");

template <bool kOutMix, typename TM, typename TF>
__global__ void __launch_bounds__(kThreads, 1)
bank_film_shaper_x_bwd_kernel(const float* __restrict__ phase, const float* __restrict__ f0,
                              const float* __restrict__ offsets, const TF* __restrict__ film,
                              const TM* __restrict__ mixer_w, const TM* __restrict__ mixer_b,
                              const float* __restrict__ weights, const TM* __restrict__ w_out,
                              const TM* __restrict__ dy, float* __restrict__ film_part,
                              float* __restrict__ part, int n_seg, int tc, int hop, int n_harm,
                              float half_sr) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // (64, 172) weights
  float* sg = sw + kC * kLd;                     // (64, 172) weight-gradient sums
  float* smw = sg + kC * kLd;                    // (128, 64) mixer w
  float* sdw = smw + kMaxHarmonics * kC;         // (128, 64) dW sums
  float* sbank = sdw + kMaxHarmonics * kC;       // (32, 129) bank tile
  float* se = sbank + kLanes * kBankLd;          // (32, 65) exciter, then d_exc
  float* sdy = se + kLanes * kTileLd;            // (32, 65) dy; xfull: (32,)
  float* sfilm = sdy + kLanes * kTileLd;         // (64, 12) FiLM slot sums
  float* soff = sfilm + kC * kFilmSlots;         // (128,) offsets
  for (int i = threadIdx.x; i < kC * kLd; i += kThreads) sw[i] = sg[i] = 0.0f;
  for (int i = threadIdx.x; i < kMaxHarmonics * kC; i += kThreads) sdw[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    sw[(i - k * kC) * kLd + row_pos(k)] = weights[i];
  }
  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads)
    smw[i] = newt::load_f32(mixer_w + i);
  for (int i = threadIdx.x; i < n_harm; i += kThreads) soff[i] = offsets[i];
  __syncthreads();

  const unsigned sw_addr = smem_addr(sw);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int quad = threadIdx.x % kQuads;  // products: channels 4quad.. (A), quad + 16j (B)
  const int row = threadIdx.x / kQuads;   // products: sample row (A), harmonics row + 32i (B)
  const int n_chunk = (hop + kLanes - 1) / kLanes;

  for (int seg = blockIdx.x; seg < n_seg; seg += gridDim.x) {
    const int b = seg / tc;
    const int m = seg - b * tc;
    const TF* clip = film + static_cast<long long>(b) * tc * (4 * kC);
    for (int j = 0; j < n_chunk; ++j) {
      const int o0 = j * kLanes;
      const int n = min(kLanes, hop - o0);  // live samples of the chunk
      const int s0 = seg * hop + o0;

      // 1. the bank tile and the chunk's dy (zero past the segment's end)
      {
        const bool live_l = lane < n;
        const float ph = live_l ? phase[s0 + lane] : 0.0f;
        const float fr = live_l ? f0[s0 + lane] : 0.0f;
        for (int k = warp; k < n_harm; k += kWarps) {
          const float kf = static_cast<float>(k + 1);
          const bool live = live_l && __fmul_rn(fr, kf) < half_sr;
          sbank[lane * kBankLd + k] = live ? newt::bank_sin(ph, kf, soff[k]) : 0.0f;
        }
      }
      if (kOutMix) {
        if (warp == 0) sdy[lane] = lane < n ? newt::load_f32(dy + s0 + lane) : 0.0f;
      } else {
        const long long base = static_cast<long long>(s0) * kC;
        for (int i = threadIdx.x; i < kLanes * kC; i += kThreads)
          sdy[(i / kC) * kTileLd + i % kC] = i < n * kC ? newt::load_f32(dy + base + i) : 0.0f;
      }
      __syncthreads();

      // 2. the exciter tile: sample `row`, channels 4quad..4quad+3
      {
        const float* brow = sbank + row * kBankLd;
        const float* wq = smw + 4 * quad;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < n_harm; ++k) {
          const float bk = brow[k];
          const float4 wk = *reinterpret_cast<const float4*>(wq + k * kC);
          acc[0] += bk * wk.x;
          acc[1] += bk * wk.y;
          acc[2] += bk * wk.z;
          acc[3] += bk * wk.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          se[row * kTileLd + 4 * quad + i] = acc[i] + newt::load_f32(mixer_b + 4 * quad + i);
      }
      __syncthreads();

      // 3. the chain, lanes as samples, for the warp's channels
      const int o = o0 + lane;
      const bool active = o < hop;
      const float d_out = kOutMix ? sdy[lane] : 0.0f;
      for (int q = 0; q < kChanPerWarp; ++q) {
        const int c = warp * kChanPerWarp + q;
        newt::FilmSegment fs;
        fs.load(clip, m, tc, hop, c);
        float film_a[4], w, omw;
        bool lo;
        fs.at(active ? o : hop - 1, film_a, &w, &omw, &lo);
        const float g_in = film_a[0], b_in = film_a[1], g_out = film_a[2], b_out = film_a[3];
        const float exc = se[lane * kTileLd + c];
        const float g = kOutMix ? d_out * newt::load_f32(w_out + c) : sdy[lane * kTileLd + c];
        const float x = g_in * exc + b_in;
        float y, dx, t[kLanes];
        shaper_backward_lanes(x, g * g_out, sw_addr + woff(c * kLd), sg + c * kLd, lane, t, &y,
                              &dx);
        const float d_exc = dx * g_in;
        se[lane * kTileLd + c] = d_exc;

        // FiLM cotangents (d gamma_in, d beta_in, d gamma_out, d beta_out)
        const float d_film[4] = {dx * exc, dx, g * y, g};
        fs.add(d_film, w, omw, lo);
#pragma unroll
        for (int k = 0; k < kFilmSlots; ++k) t[kLastTerms + k] = fs.slot[k / 4][k % 4];
        t[kLastTerms + kFilmSlots] = d_exc;
        t[kLastTerms + kFilmSlots + 1] = kOutMix ? (g_out * y + b_out) * d_out : 0.0f;
#pragma unroll
        for (int k = kLastTerms + kFilmSlots + 2; k < kLanes; ++k) t[k] = 0.0f;
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
        } else if (lane == kLastTerms + kFilmSlots) {
          sg[c * kLd + kPB] += s;
        } else if (kOutMix && lane == kLastTerms + kFilmSlots + 1) {
          sg[c * kLd + kPWo] += s;
        }
      }
      __syncthreads();

      // 4. dW += bank tile^T . d_exc tile: harmonics row + 32i, channels
      // quad + 16j, summed over the chunk's samples in order
      {
        float acc[4][4] = {};
#pragma unroll 8
        for (int l = 0; l < kLanes; ++l) {
          float bk[4], de[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) bk[i] = sbank[l * kBankLd + row + kLanes * i];
#pragma unroll
          for (int i = 0; i < 4; ++i) de[i] = se[l * kTileLd + quad + kQuads * i];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] += bk[i] * de[jj];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row + kLanes * i < n_harm) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sdw[(row + kLanes * i) * kC + quad + kQuads * jj] += acc[i][jj];
          }
        }
      }
      __syncthreads();  // the bank and exciter tiles are read; the next chunk may write them
    }
  }

  // the block's partial: planes, dW rows, db, dw_out
  const int n_rows = newt::kRows + n_harm + 1 + (kOutMix ? 1 : 0);
  float* out = part + static_cast<long long>(blockIdx.x) * n_rows * kC;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    out[i] = sg[(i - k * kC) * kLd + row_pos(k)];
  }
  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads) out[kPlane + i] = sdw[i];
  if (threadIdx.x < kC) {
    const int c = threadIdx.x;
    out[kPlane + n_harm * kC + c] = sg[c * kLd + kPB];
    if (kOutMix) out[kPlane + (n_harm + 1) * kC + c] = sg[c * kLd + kPWo];
  }
}

template <bool kOutMix, typename TM, typename TF>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bank_film_shaper_x_bwd_kernel<kOutMix, TM, TF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bank_film_shaper_x_bwd_kernel<kOutMix, TM, TF>, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

template <typename TM, typename TF>
int launch(const float* phase, const float* f0, const float* offsets, const TF* film,
           const TM* mixer_w, const TM* mixer_b, const float* weights, const TM* w_out,
           const TM* dy, TF* d_film, float* grads, float* film_part, float* part, int b, int ta,
           int tc, int n_harm, int blocks, float half_sr, void* stream) {
  if (b <= 0 || tc <= 0 || blocks <= 0 || n_harm < 2 || n_harm > kMaxHarmonics)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hop = ta / tc;
  const bool out_mix = w_out != nullptr;
  if (out_mix)
    bank_film_shaper_x_bwd_kernel<true, TM, TF><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, dy, film_part, part,
        b * tc, tc, hop, n_harm, half_sr);
  else
    bank_film_shaper_x_bwd_kernel<false, TM, TF><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, dy, film_part, part,
        b * tc, tc, hop, n_harm, half_sr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = (newt::kRows + n_harm + 1 + (out_mix ? 1 : 0)) * kC;
  newt::sum_weight_partials<<<(n + 255) / 256, 256, 0, s>>>(part, grads, n, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(newt::fold_film(film_part, d_film, b, tc, s));
}

using bf16 = __nv_bfloat16;

}  // namespace

// The number of backward blocks resident on the current device at once, for
// xcr and for xfull, one query per instance (the suffix as
// newt_fused_x_backward's); each also allows its kernel the dynamic shared
// memory there, so call it once per device before the instance's first
// launch. The caller launches min(this, B*Tc) blocks (one control segment per
// block at a time) and sizes the (blocks, rows, 64) partials with it.
// Returns -(CUDA error) on failure.
extern "C" int newt_fused_xcr_backward_resident_blocks() {
  return resident_blocks<false, float, float>();
}
extern "C" int newt_fused_xfull_backward_resident_blocks() {
  return resident_blocks<true, float, float>();
}
extern "C" int newt_fused_xcr_backward_resident_blocks_bf16() {
  return resident_blocks<false, bf16, bf16>();
}
extern "C" int newt_fused_xfull_backward_resident_blocks_bf16() {
  return resident_blocks<true, bf16, bf16>();
}
extern "C" int newt_fused_xcr_backward_resident_blocks_bf16_f32() {
  return resident_blocks<false, bf16, float>();
}
extern "C" int newt_fused_xfull_backward_resident_blocks_bf16_f32() {
  return resident_blocks<true, bf16, float>();
}

// Inputs as newt_fused_x_forward's, with dy ((B, Ta, 64) for xcr, (B, Ta) for
// xfull, where w_out is not null). Outputs: d_film (B, Tc, 256) and grads
// (rows, 64), rows = 170 + H + 1 (+ 1 for xfull): the planes, dW, db and
// dw_out. Scratch: film_part (B*Tc, 3, 256) and part (blocks, rows, 64), with
// blocks as the resident-blocks query says. Contiguous on the current
// device, Ta = Tc*hop; float32 here; in the two instances below the mixer,
// w_out and dy bfloat16 (the film and d_film too in _bf16, not in
// _bf16_f32), grads and the scratch float32 always. Launches the three
// kernels on `stream` and returns the first CUDA error (0 = launched).
extern "C" int newt_fused_x_backward(const float* phase, const float* f0, const float* offsets,
                                     const float* film, const float* mixer_w,
                                     const float* mixer_b, const float* weights,
                                     const float* w_out, const float* dy, float* d_film,
                                     float* grads, float* film_part, float* part, int b, int ta,
                                     int tc, int n_harm, int blocks, float half_sr,
                                     void* stream) {
  return launch(phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, dy, d_film, grads,
                film_part, part, b, ta, tc, n_harm, blocks, half_sr, stream);
}

extern "C" int newt_fused_x_backward_bf16(const float* phase, const float* f0,
                                          const float* offsets, const bf16* film,
                                          const bf16* mixer_w, const bf16* mixer_b,
                                          const float* weights, const bf16* w_out,
                                          const bf16* dy, bf16* d_film, float* grads,
                                          float* film_part, float* part, int b, int ta, int tc,
                                          int n_harm, int blocks, float half_sr, void* stream) {
  return launch(phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, dy, d_film, grads,
                film_part, part, b, ta, tc, n_harm, blocks, half_sr, stream);
}

extern "C" int newt_fused_x_backward_bf16_f32(const float* phase, const float* f0,
                                              const float* offsets, const float* film,
                                              const bf16* mixer_w, const bf16* mixer_b,
                                              const float* weights, const bf16* w_out,
                                              const bf16* dy, float* d_film, float* grads,
                                              float* film_part, float* part, int b, int ta,
                                              int tc, int n_harm, int blocks, float half_sr,
                                              void* stream) {
  return launch(phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, dy, d_film, grads,
                film_part, part, b, ta, tc, n_harm, blocks, half_sr, stream);
}
