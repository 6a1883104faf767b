// Exciter-fused synthesis, backward, float32: the backward of newt_fused_x.cu
// for xcr and, with the compile-time flag kOutMix, xfull.
//
// Replaces the TPU kernels kernels/newt_fused.py:1199 _fused_bwd_xcr
// (Pallas _bwd_kernel_xcr) and :1447 _fused_bwd_xfull (_bwd_kernel_xfull) of
// the JAX package. Like them it stores nothing in the forward and recomputes
// the bank, the mix and the chain here. The even/odd half accumulators of
// the mixer gradient (dmwe/dmwo) were a Mosaic lane layout and are gone.
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
// What bounds it on an H100: arithmetic, and shared-memory traffic. Per
// (sample, channel) it redoes kernel 2's 1,721 operations without its
// d_exciter, the mix (2H) and the bank's two sines, then the mixer gradient
// (2H more): ~2,160 operations at H = 101 against 8 bytes per sample in
// (12 for xfull's dy) and 4 per element of dy for xcr. The 170 + H
// read-modify-writes of the thread's gradient slots in shared memory per
// sample are the likelier limit, as in kernel 2.
//
// Design: kernel 2's walk over control segments, with 2 rows of 64 threads
// per block, one block per SM. Each row takes a segment (b, m) of hop
// samples, strided by the grid's rows, reads its FiLM frames {m-1, m, m+1}
// once into registers and sums their cotangents in registers (slots 0, 1,
// 2): kernel 2's newt::FilmSegment. Per sample the row's 64 threads build
// the bank into the row's shared bank row (two harmonics each), then, after
// a barrier, each thread mixes its channel, recomputes the chain through
// newt::shaper_backward, and adds bank[k] * d_exc into its own dW column. The block's loops have the same
// trip counts for both rows, with the work of a row past the last segment
// guarded, so __syncthreads is reached by every thread. Shared memory, 2 rows:
//   shaper planes                      43,520 B
//   two 170-float slots per channel    87,040 B
//   two 128-float dW slots per channel 65,536 B
//   mixer w staged                     32,768 B
//   two 128-float bank rows             1,024 B
//   total                             229,888 B of the 232,448 a block may use.
// db and dw_out are per-thread registers, left at the end in the bank rows.
// Each thread's slots are channel fastest: a warp's accesses are 32
// consecutive floats, conflict-free.
//
// Deterministic, no atomics: each block sums its two rows' slots in row order
// into one partial row table, newt::sum_weight_partials adds the tables in
// block order, and the FiLM fold adds fixed segments in a fixed order. Two
// calls give the same bits.
//
// Exactness: the bank and the FiLM lerp as in newt_fused_x.cu; no
// --use_fast_math. Segments and samples in 32-bit ints (the wrapper refuses
// B*Ta > 2^30), offsets in 64-bit.
#include <cuda_runtime.h>

#include "newt_bank.cuh"
#include "newt_shaper_bwd.cuh"

namespace {

using newt::kC;
using newt::kMaxHarmonics;
using newt::kPlane;

constexpr int kRowsPerBlock = 2;
constexpr int kThreads = kRowsPerBlock * kC;
constexpr int kWSlots = kMaxHarmonics * kC;  // one row's dW slots, (128, 64)
constexpr size_t kSmemBytes =
    static_cast<size_t>(kPlane + kRowsPerBlock * kPlane + kRowsPerBlock * kWSlots + kWSlots +
                        kRowsPerBlock * kMaxHarmonics) * sizeof(float);

template <bool kOutMix>
__global__ void __launch_bounds__(kThreads, 1)
bank_film_shaper_x_bwd_kernel(const float* __restrict__ phase, const float* __restrict__ f0,
                              const float* __restrict__ offsets, const float* __restrict__ film,
                              const float* __restrict__ mixer_w,
                              const float* __restrict__ mixer_b,
                              const float* __restrict__ weights, const float* __restrict__ w_out,
                              const float* __restrict__ dy, float* __restrict__ film_part,
                              float* __restrict__ part, int n_seg, int tc, int hop, int n_harm,
                              float half_sr) {
  extern __shared__ float smem[];
  float* sw = smem;                              // (170, 64) shaper planes
  float* acc = sw + kPlane;                      // (2, 170, 64) plane-gradient slots
  float* accw = acc + kRowsPerBlock * kPlane;    // (2, 128, 64) dW slots
  float* smw = accw + kRowsPerBlock * kWSlots;   // (H, 64) mixer w
  float* sbank = smw + kWSlots;                  // (2, 128) bank rows
  for (int i = threadIdx.x; i < kPlane; i += kThreads) sw[i] = weights[i];
  for (int i = threadIdx.x; i < kRowsPerBlock * kPlane; i += kThreads) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < kRowsPerBlock * kWSlots; i += kThreads) accw[i] = 0.0f;
  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads) smw[i] = mixer_w[i];
  __syncthreads();

  const int c = threadIdx.x % kC;
  const int r = threadIdx.x / kC;
  float* my = acc + r * kPlane + c;     // my[k * kC]: plane row k of my slot
  float* myw = accw + r * kWSlots + c;  // myw[k * kC]: dW[k, c] of my slot
  float* bank = sbank + r * kMaxHarmonics;
  const float off_lo = c < n_harm ? offsets[c] : 0.0f;
  const float off_hi = c + kC < n_harm ? offsets[c + kC] : 0.0f;
  const float bias = mixer_b[c];
  const float wo = kOutMix ? w_out[c] : 0.0f;
  float db = 0.0f, dwo = 0.0f;

  for (int base = blockIdx.x * kRowsPerBlock; base < n_seg;
       base += gridDim.x * kRowsPerBlock) {
    const int seg = base + r;
    const bool active = seg < n_seg;
    const int b = active ? seg / tc : 0;
    newt::FilmSegment fs;  // a row past the last segment reads clip 0, frame 0
    fs.load(film + static_cast<long long>(b) * tc * (4 * kC), active ? seg - b * tc : 0, tc, hop,
            c);

    for (int o = 0; o < hop; ++o) {
      const long long s = static_cast<long long>(seg) * hop + o;
      if (active) newt::fill_bank_row(bank, phase[s], f0[s], off_lo, off_hi, c, n_harm, half_sr);
      __syncthreads();
      if (active) {
        const float exc = newt::mix(bank, smw, c, n_harm, bias);
        float film_a[4], w, omw;  // the FiLM lerp, exactly as newt_fused_cr_bwd.cu
        bool lo;
        fs.at(o, film_a, &w, &omw, &lo);
        const float g_in = film_a[0], b_in = film_a[1], g_out = film_a[2], b_out = film_a[3];

        const float x = g_in * exc + b_in;
        const float d_out = kOutMix ? dy[s] : 0.0f;
        const float g = kOutMix ? d_out * wo : dy[s * kC + c];
        float y, dx;
        newt::shaper_backward(x, g * g_out, sw, c, my, &y, &dx);
        const float d_exc = dx * g_in;
        for (int k = 0; k < n_harm; ++k) myw[k * kC] += bank[k] * d_exc;
        db += d_exc;
        if (kOutMix) dwo += (g_out * y + b_out) * d_out;

        // FiLM cotangents (d gamma_in, d beta_in, d gamma_out, d beta_out)
        const float d_film[4] = {dx * exc, dx, g * y, g};
        fs.add(d_film, w, omw, lo);
      }
      __syncthreads();  // the bank row is read; the next sample may write it
    }
    if (active) fs.store(film_part + static_cast<long long>(seg) * 3 * (4 * kC) + c);
  }

  // db and dw_out through the (now idle) bank rows, then the block's partial
  // table: planes, dW rows, db, dw_out, each the two rows' slots in row order
  bank[c] = db;
  bank[kC + c] = dwo;
  __syncthreads();
  const int n_rows = newt::kRows + n_harm + 1 + (kOutMix ? 1 : 0);
  float* out = part + static_cast<long long>(blockIdx.x) * n_rows * kC;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) out[i] = acc[i] + acc[kPlane + i];
  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads)
    out[kPlane + i] = accw[i] + accw[kWSlots + i];
  if (threadIdx.x < kC) {
    const int i = threadIdx.x;
    out[kPlane + n_harm * kC + i] = sbank[i] + sbank[kMaxHarmonics + i];
    if (kOutMix)
      out[kPlane + (n_harm + 1) * kC + i] = sbank[kC + i] + sbank[kMaxHarmonics + kC + i];
  }
}

template <bool kOutMix>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bank_film_shaper_x_bwd_kernel<kOutMix>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bank_film_shaper_x_bwd_kernel<kOutMix>, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

}  // namespace

// The number of backward blocks resident on the current device at once, for
// xcr and for xfull; each also allows its kernel the dynamic shared memory
// there, so call it once per device before the first launch. The caller
// launches min(this, ceil(B*Tc / 2)) blocks and sizes the (blocks, rows, 64)
// partials with it. Returns -(CUDA error) on failure.
extern "C" int newt_fused_xcr_backward_resident_blocks() { return resident_blocks<false>(); }
extern "C" int newt_fused_xfull_backward_resident_blocks() { return resident_blocks<true>(); }

// Inputs as newt_fused_x_forward's, with dy ((B, Ta, 64) for xcr, (B, Ta) for
// xfull, where w_out is not null). Outputs: d_film (B, Tc, 256) and grads
// (rows, 64), rows = 170 + H + 1 (+ 1 for xfull): the planes, dW, db and
// dw_out. Scratch: film_part (B*Tc, 3, 256) and part (blocks, rows, 64), with
// blocks as the resident-blocks query says. Contiguous float32 on the current
// device, Ta = Tc*hop. Launches the three kernels on `stream` and returns the
// first CUDA error (0 = launched).
extern "C" int newt_fused_x_backward(const float* phase, const float* f0, const float* offsets,
                                     const float* film, const float* mixer_w,
                                     const float* mixer_b, const float* weights,
                                     const float* w_out, const float* dy, float* d_film,
                                     float* grads, float* film_part, float* part, int b, int ta,
                                     int tc, int n_harm, int blocks, float half_sr,
                                     void* stream) {
  if (b <= 0 || tc <= 0 || blocks <= 0 || n_harm < 2 || n_harm > kMaxHarmonics)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hop = ta / tc;
  const bool out_mix = w_out != nullptr;
  if (out_mix)
    bank_film_shaper_x_bwd_kernel<true><<<blocks, kThreads, kSmemBytes, s>>>(
        phase, f0, offsets, film, mixer_w, mixer_b, weights, w_out, dy, film_part, part,
        b * tc, tc, hop, n_harm, half_sr);
  else
    bank_film_shaper_x_bwd_kernel<false><<<blocks, kThreads, kSmemBytes, s>>>(
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
