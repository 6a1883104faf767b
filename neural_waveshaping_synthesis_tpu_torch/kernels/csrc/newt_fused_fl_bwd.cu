// Audio-rate FiLM -> sine-shaper bank -> FiLM, backward: float32 arithmetic
// on float32 or bfloat16 I/O.
//
// Replaces the TPU kernels kernels/newt_fused.py:527 _fused_bwd_fl and :450
// _fused_bwd (both reach _run_bwd :395 -> pallas_call with _bwd_kernel_fl /
// _bwd_kernel, _bwd_core, _accumulate_wgrads) of the JAX package: one
// kernel for both, as the forward newt_fused_fl.cu is one for their
// forwards. Like JAX's _fused_fwd_fl the forward stores no activation, so
// this kernel recomputes it per (sample, channel).
//
// What it computes, given exciter (B, Ta, 64), the audio-rate film
// (B, Ta, 256), the packed weight planes (170, 64) and the output cotangent
// dy (B, Ta, 64):
//   d_exciter (B, Ta, 64);
//   d_film (B, Ta, 256): each sample's four FiLM cotangents (d gamma_in,
//     d beta_in, d gamma_out, d beta_out), written where the forward read
//     the FiLM;
//   d_planes (170, 64): each weight plane's gradient summed in f32 over all
//     B*Ta samples.
//
// What bounds it on an H100: instruction issue, as kernel 2
// (newt_fused_cr_bwd.cu), whose recompute and chain rule it runs. Per
// (sample, channel) that is 1,691 operations (an FMA as two) against 44
// bytes moved (exciter, FiLM, dy in; d_exciter, d_film out): 0.83 ms of
// arithmetic and 0.43 ms of traffic at B*Ta = 512,000. Per 32 (sample,
// channel) pairs a warp's pass is 1,529 SASS instructions (678 FFMA, 212
// FMUL, 130 FADD, 25 FRND; 171 SHFL and 174 FSEL of the lane sums; 88
// shared loads, the weights' ld.shared.v4 broadcasts and the tiles' reads;
// 11 shared stores): 1.50 ms at one instruction a cycle per scheduler and
// 1.98 GHz; it runs at ~2.2 ms (PERF.md).
//
// Design, kernel 2's lanes as samples without its FiLM segment and fold:
//  * Lanes are samples, a warp is a channel. A persistent grid (what fits on
//    the card at once) of 16-warp blocks walks the flat sample index in
//    chunks of 32 samples, one chunk per block at a time, strided by the
//    grid. The FiLM is per sample, so a chunk may cross a clip boundary.
//    Each warp owns 4 fixed channels and runs them in turn, lane l holding
//    sample 32j + l. Lanes past B*Ta recompute with a zero exciter, FiLM and
//    cotangent: every term they add is an exact zero, and they write nothing.
//  * Weights as warp-uniform broadcasts and the 170 weight-gradient terms
//    summed across lanes into a per-block (64, 172) gradient table:
//    newt_lanes_bwd.cuh (shared with kernels 2 and 8). The last group holds
//    only the 10 terms of w1, scale and b4, summed over 16 term slots by
//    newt::lane_sum16.
//  * Coalesced, double-buffered tiles: each chunk's exciter and dy (32, 64)
//    and FiLM (32, 256) are staged in shared memory by the block with
//    coalesced 4-byte cp.async copies, rows padded to 65 and 257 floats, so a
//    warp's column read (32 samples of one channel) hits 32 banks. d_exciter
//    goes back into the exciter tile and the four FiLM cotangents into the
//    FiLM tile in place (each lane overwrites only its own four slots, after
//    reading them). Two buffers: while the warps work on chunk j in one,
//    the block stores chunk j - grid's results from the other with coalesced
//    stores and starts the copies of chunk j + grid into it, so the loads
//    are in flight during the arithmetic (one block per SM has no other
//    block to hide them behind).
//  * Cross-block sums (the TPU accumulated into one resident block across
//    its sequential grid; Hopper blocks run in parallel, in no order):
//    deterministic per-block partials plus a second pass, no atomics, so two
//    calls give the same bits. Each block writes its table as one (170, 64)
//    partial in plane order; newt::sum_weight_partials adds the partials in
//    block order.
//  * Occupancy: weights and gradient table 88,064 B, two buffers of the
//    exciter and dy tiles (16,640 B) and the FiLM tile (32,896 B): 187,136 B,
//    one 16-warp block per SM, at most 128 registers a thread. Measured
//    against synchronous staging in one buffer and against two 8-warp blocks
//    per SM that take a chunk's channels in two halves (PERF.md).
//
// Exactness: no --use_fast_math; rintf for the range reduction; the
// recompute's sums in newt_lanes_bwd.cuh's order. The weight-gradient sums
// run in another order than the plain version's, so d_planes differs from it
// by rounding. Samples are counted in 32-bit ints (the wrapper refuses
// B*Ta > 2^30), offsets in 64-bit.
//
// Mixed precision: the kernel is a template on T, the type of the exciter,
// the FiLM, dy, d_exciter and d_film, in the instances of newt_fused_fl.cu:
// (float) and (bf16). The design question is the staging: cp.async copies 4,
// 8 or 16 bytes, and a bf16 element is 2. Three ways were weighed:
//  * widen in registers into the float tiles (plain loads and shared
//    stores): the loads would no longer be in flight during the arithmetic,
//    which is what the two buffers are for (one block per SM hides nothing);
//  * 16-byte copies: a 16-B aligned row would be a multiple of 4 words, so a
//    warp's column read (32 rows, one channel) would meet 4-way bank
//    conflicts without a swizzle of the tile (PERF.md §7 lists a swizzled
//    FiLM tile as an untried lever of the float32 kernel too);
//  * (chosen) tiles of T, each 4-byte cp.async moving one word: one float or
//    a pair of bf16 channels. A row is padded by one word, 65 floats or 66
//    bf16 (33 words) for exciter and dy, 257 floats or 258 bf16 (129 words)
//    for the FiLM: an odd number of words, so the 32 lanes' reads of one
//    channel (word l*33 + c/2) hit 32 banks. The float instance is the
//    float32 kernel as it was; the bf16 one issues half the copies and its
//    tiles take half the bytes (137,984 B in all, still one 16-warp block
//    per SM: two would need 275,968).
// A bf16 value is widened as a lane reads it from its tile. d_exciter and
// the four FiLM cotangents are rounded once, to nearest even, as the lane
// writes them back into the tiles in place; the block's word stores then
// copy them out unchanged. Channels c and c + 1 share a word but belong to
// one warp, which writes them in two of its passes (2-byte shared stores).
// The weight table, the gradient table, the per-block partials and d_planes
// stay float32, as JAX sums its weight gradients in float32 whatever the
// activation dtype (rsum, kernels/newt_fused.py:218-223). The bf16 copies
// need 4-byte aligned exciter, FiLM and dy; the wrapper sees to it. ptxas
// (sm_90a): the bf16 instance 128 registers, 12 bytes of spill stores and
// loads (the float32 one 128, none); on an H100 it runs level with the
// float32 instance at (8, 64000, 64) (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "newt_lanes_bwd.cuh"

namespace {

using newt::kC;
using newt::kLanes;
using newt::kLastTerms;
using newt::kLd;
using newt::kPlane;
using newt::kPW1;
using newt::lane_sum16;
using newt::load_f32;
using newt::row_pos;
using newt::shaper_backward_lanes;
using newt::smem_addr;
using newt::store_as;
using newt::woff;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kLanes;
constexpr int kChanPerWarp = kC / kWarps;
constexpr int kFilm = 4 * kC;  // a sample's FiLM row

// The staging tiles of I/O type T: a copy moves one 4-byte word of kPer
// elements; rows are padded by one word (an odd number of words).
template <typename T>
struct Tiles {
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  static constexpr int kLd = kC + kPer;          // exciter and dy rows: 65 floats, 66 bf16
  static constexpr int kFilmLd = kFilm + kPer;   // FiLM rows: 257 floats, 258 bf16
  // one buffer: the exciter and dy tiles (32, kLd) and the FiLM tile (32, kFilmLd)
  static constexpr int kBuf = 2 * kLanes * kLd + kLanes * kFilmLd;
  // weights and gradient table (64, 172) floats each, then two buffers
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(2 * kC * newt::kLd) * sizeof(float) + 2 * kBuf * sizeof(T);
};

// a 4-byte asynchronous copy global -> shared (ordered after this thread's
// earlier reads of dst), and its group fences
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// one 4-byte word from a tile to device memory, its bits unchanged
template <typename T>
__device__ __forceinline__ void store_word(T* dst, const T* src) {
  *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
film_shaper_fl_bwd_kernel(const T* __restrict__ exciter,
                          const T* __restrict__ film,
                          const float* __restrict__ weights,
                          const T* __restrict__ dy,
                          T* __restrict__ d_exciter,
                          T* __restrict__ d_film,
                          float* __restrict__ w_part, int n_samples) {
  using Tl = Tiles<T>;
  constexpr int kPer = Tl::kPer, kTLd = Tl::kLd, kFLd = Tl::kFilmLd, kBuf = Tl::kBuf;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // (64, 172) weights
  float* sg = sw + kC * kLd;                     // (64, 172) weight-gradient sums
  T* tiles = reinterpret_cast<T*>(sg + kC * kLd);  // two buffers of (se, sdy, sf)
  for (int i = threadIdx.x; i < kC * kLd; i += kThreads) sw[i] = sg[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    sw[(i - k * kC) * kLd + row_pos(k)] = weights[i];
  }

  const unsigned sw_addr = smem_addr(sw);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_chunk = (n_samples + kLanes - 1) / kLanes;
  auto rows_of = [&](int j) { return j < n_chunk ? min(kLanes, n_samples - j * kLanes) : 0; };
  // Writes back the tiles of buf (wb_rows samples from sample wb: d_exciter,
  // d_film) and starts the copies of ld_rows samples from sample ld into
  // them, a word (kPer elements) at a time; a row is an even number of
  // elements, so no word straddles two rows or the last row's end. Each
  // thread reads a word before its own copy overwrites it.
  auto stage = [&](T* buf, long long wb, int wb_rows, long long ld, int ld_rows) {
    T* se = buf;
    T* sdy = se + kLanes * kTLd;
    T* sf = sdy + kLanes * kTLd;
    for (int i = threadIdx.x * kPer; i < kLanes * kC; i += kThreads * kPer) {
      const int t = (i / kC) * kTLd + i % kC;
      if (i < wb_rows * kC) store_word(d_exciter + wb * kC + i, se + t);
      if (i < ld_rows * kC) {
        cp_async4(se + t, exciter + ld * kC + i);
        cp_async4(sdy + t, dy + ld * kC + i);
      }
    }
    for (int i = threadIdx.x * kPer; i < kLanes * kFilm; i += kThreads * kPer) {
      const int t = (i / kFilm) * kFLd + i % kFilm;
      if (i < wb_rows * kFilm) store_word(d_film + wb * kFilm + i, sf + t);
      if (i < ld_rows * kFilm) cp_async4(sf + t, film + ld * kFilm + i);
    }
    cp_async_commit();
  };
  int cur = 0;
  long long pend = 0;  // the first sample of the other buffer's tiles, not yet written back
  int pend_rows = 0;
  stage(tiles, 0, 0, static_cast<long long>(blockIdx.x) * kLanes, rows_of(blockIdx.x));

  for (int j = blockIdx.x; j < n_chunk; j += gridDim.x) {
    const int jn = j + gridDim.x;
    stage(tiles + (cur ^ 1) * kBuf, pend, pend_rows, static_cast<long long>(jn) * kLanes,
          rows_of(jn));
    cp_async_wait<1>();
    __syncthreads();

    T* se = tiles + cur * kBuf;
    T* sdy = se + kLanes * kTLd;
    T* row = sdy + kLanes * kTLd + lane * kFLd;
    const int rows = rows_of(j);
    const bool active = lane < rows;
    for (int q = 0; q < kChanPerWarp; ++q) {
      const int c = warp * kChanPerWarp + q;
      const float g_in = active ? load_f32(row + c) : 0.0f;
      const float b_in = active ? load_f32(row + kC + c) : 0.0f;
      const float g_out = active ? load_f32(row + 2 * kC + c) : 0.0f;
      const float xin = active ? load_f32(se + lane * kTLd + c) : 0.0f;
      const float g = active ? load_f32(sdy + lane * kTLd + c) : 0.0f;
      const float x = g_in * xin + b_in;
      float y, dx, t[16];
      shaper_backward_lanes(x, g * g_out, sw_addr + woff(c * kLd), sg + c * kLd, lane, t, &y,
                            &dx);
      if (active) {
        store_as(se + lane * kTLd + c, dx * g_in);
        // FiLM cotangents (d gamma_in, d beta_in, d gamma_out, d beta_out)
        store_as(row + c, dx * xin);
        store_as(row + kC + c, dx);
        store_as(row + 2 * kC + c, g * y);
        store_as(row + 3 * kC + c, g);
      }
#pragma unroll
      for (int k = kLastTerms; k < 16; ++k) t[k] = 0.0f;
      const float s = lane_sum16(t, lane);
      if (lane < kLastTerms) sg[c * kLd + kPW1 + lane] += s;
    }
    __syncthreads();
    pend = static_cast<long long>(j) * kLanes;
    pend_rows = rows;
    cur ^= 1;
  }

  cp_async_wait<0>();
  stage(tiles + (cur ^ 1) * kBuf, pend, pend_rows, 0, 0);
  float* out = w_part + static_cast<long long>(blockIdx.x) * kPlane;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    out[i] = sg[(i - k * kC) * kLd + row_pos(k)];
  }
}

// Allows an instance its dynamic shared memory on the current device and
// gives its resident blocks per SM.
template <typename T>
cudaError_t blocks_per_sm(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(film_shaper_fl_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Tiles<T>::kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, film_shaper_fl_bwd_kernel<T>, kThreads, Tiles<T>::kSmemBytes);
  return err;
}

template <typename T>
int launch(const T* exciter, const T* film, const float* weights, const T* dy, T* d_exciter,
           T* d_film, float* d_planes, float* w_part, int n_samples, int blocks, void* stream) {
  if (n_samples <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  film_shaper_fl_bwd_kernel<T><<<blocks, kThreads, Tiles<T>::kSmemBytes, s>>>(
      exciter, film, weights, dy, d_exciter, d_film, w_part, n_samples);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  newt::sum_weight_partials<<<(kPlane + 255) / 256, 256, 0, s>>>(w_part, d_planes, kPlane,
                                                                  blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of backward blocks resident on the current device at once
// (SMs x blocks per SM, the least over the two instances); it also allows
// every instance its dynamic shared memory there, so call it once per device
// before the first launch. The caller launches min(this, ceil(B*Ta / 32))
// blocks (one 32-sample chunk per block at a time) and sizes the (blocks,
// 170, 64) weight partials with it. Returns -(CUDA error) on failure.
extern "C" int newt_fused_fl_backward_resident_blocks() {
  int device = 0, sms = 0, f32 = 0, bf16 = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = blocks_per_sm<float>(&f32);
  if (err == cudaSuccess) err = blocks_per_sm<__nv_bfloat16>(&bf16);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int per_sm = f32 < bf16 ? f32 : bf16;
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

// exciter, dy, d_exciter (B, Ta, 64); film, d_film (B, Ta, 256); weights,
// d_planes (170, 64); scratch w_part (blocks, 170, 64), with blocks as
// newt_fused_fl_backward_resident_blocks says: contiguous on the current
// device, n_samples = B*Ta; float32 here, and in the instance below bfloat16
// for exciter, film, dy, d_exciter and d_film (4-byte aligned), the weights,
// d_planes and the scratch float32 always. Launches the two kernels on
// `stream` and returns the first CUDA error (0 = launched).
extern "C" int newt_fused_fl_backward(const float* exciter, const float* film,
                                      const float* weights, const float* dy,
                                      float* d_exciter, float* d_film,
                                      float* d_planes, float* w_part,
                                      int n_samples, int blocks, void* stream) {
  return launch(exciter, film, weights, dy, d_exciter, d_film, d_planes, w_part, n_samples,
                blocks, stream);
}

extern "C" int newt_fused_fl_backward_bf16(const __nv_bfloat16* exciter,
                                           const __nv_bfloat16* film, const float* weights,
                                           const __nv_bfloat16* dy, __nv_bfloat16* d_exciter,
                                           __nv_bfloat16* d_film, float* d_planes,
                                           float* w_part, int n_samples, int blocks,
                                           void* stream) {
  return launch(exciter, film, weights, dy, d_exciter, d_film, d_planes, w_part, n_samples,
                blocks, stream);
}
