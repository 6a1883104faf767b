// Control-rate FiLM -> sine-shaper bank -> FiLM, backward, float32.
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
//  * Weights as broadcasts: a channel-major copy of the planes in shared
//    memory, one row of 170 per channel padded to 172 (16-B aligned), in an
//    order where every 8-wide group starts on 16 bytes. All lanes of a warp
//    read the same address, 4 weights per ld.shared.v4: 79 loads per 32
//    samples (43 in the recompute, 36 in the chain rule).
//  * Weight-gradient sums across lanes: the 170 per-sample terms form six
//    groups of 32 (w3 in two, w2 in two; b3, w4, b2, b1; w1, scale, b4 and
//    the 12 FiLM cotangent slots). Each group is summed over the 32 lanes by
//    a fixed-order butterfly reduce-scatter (__shfl_xor_sync, 31 shuffles;
//    lane l ends with the sum of term l) and lane l adds it to position l of
//    the group in the block's (64, 172) gradient table in shared memory.
//    A warp owns its channels' rows, so there is no race and no atomic. In
//    the four w2/w3 groups each lane orders its rows by its lane bits, so
//    the butterfly's first two steps need no select (22 FSEL, not 62).
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
#include <cuda_runtime.h>

#include "newt_shaper_bwd.cuh"

namespace {

using newt::kC;
using newt::kPlane;
using newt::kW;

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
constexpr int kChanPerWarp = kC / kWarps;
constexpr int kLd = 172;         // a channel's row of 170, padded to 16 bytes
constexpr int kTileLd = kC + 1;  // a staging tile's row, padded
constexpr int kFilmSlots = 12;   // FilmSegment's (3, 4) cotangent slots
// Positions in a channel's row, for the weights and the gradient table: the
// six lane-sum groups are 0-31, 32-63, 64-95, 96-127, 128-159 and 160-169.
constexpr int kPW3 = 0;    // w3 (64), u*8+v
constexpr int kPW2 = 64;   // w2 (64), u*8+v
constexpr int kPB3 = 128;  // b3 (8)
constexpr int kPW4 = 136;  // w4 (8)
constexpr int kPB2 = 144;  // b2 (8)
constexpr int kPB1 = 152;  // b1 (8)
constexpr int kPW1 = 160;  // w1 (8)
constexpr int kPScale = 168;
constexpr int kPB4 = 169;
constexpr int kLastTerms = 10;  // weight terms of the last group: w1, scale, b4
// weights and gradient table (64, 172) each, exciter and dy tiles (32, 65)
// each, the FiLM slots' sums across chunks (64, 12)
constexpr size_t kSmemBytes =
    static_cast<size_t>(2 * kC * kLd + 2 * kLanes * kTileLd + kC * kFilmSlots) * sizeof(float);

// position in a channel's row of packed plane row k (newt_shaper.cuh order)
__device__ __forceinline__ int row_pos(int k) {
  if (k == newt::kScale) return kPScale;
  if (k < newt::kB1) return kPW1 + (k - newt::kW1);
  if (k < newt::kW2) return kPB1 + (k - newt::kB1);
  if (k < newt::kB2) return kPW2 + (k - newt::kW2);
  if (k < newt::kW3) return kPB2 + (k - newt::kB2);
  if (k < newt::kB3) return kPW3 + (k - newt::kW3);
  if (k < newt::kW4) return kPB3 + (k - newt::kB3);
  if (k < newt::kB4) return kPW4 + (k - newt::kW4);
  return kPB4;
}

// The shared-memory (32-bit) address of `p`, and the byte offset of weight
// position `pos` in a row.
__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__host__ __device__ constexpr unsigned woff(int pos) { return 4u * pos; }

// One 16-B shared load from a 32-bit shared address (one base register per
// channel, constant offsets). volatile: the compiler re-reads the weights
// where the chain rule needs them again instead of holding 170 in registers.
__device__ __forceinline__ float4 lds4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void lds8(unsigned addr, float out[kW]) {
  const float4 a = lds4(addr), b = lds4(addr + 16);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// One butterfly step on v[0 .. 2*kOff): lanes with bit kOff set keep the
// upper kOff values and add their partner's, the others the lower.
template <int kOff, int kN>
__device__ __forceinline__ void fold(float (&v)[kN], bool upper) {
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// -> in lane l, the sum of v[l] over the warp's 32 lanes, in a fixed order.
__device__ __forceinline__ float lane_sum(float (&v)[kLanes], int lane) {
  fold<16>(v, lane & 16);
  fold<8>(v, lane & 8);
  fold<4>(v, lane & 4);
  fold<2>(v, lane & 2);
  fold<1>(v, lane & 1);
  return v[0];
}

// The weight gradient of rows kU0..kU0+3 of an 8x8 layer, dp[v] * h[u],
// summed over the lanes into g (32 positions, row kU0+i at 8i): lane_sum
// without most of its selects. Each lane lays out its 32 terms with row i at
// kU0 + (i ^ p), p = lane bits 4..3, so that in the butterfly's steps over
// those bits every lane keeps the same registers and sends the same others;
// the first step's kept product is fused into its add.
template <int kU0>
__device__ __forceinline__ void add_outer(const float h[kW], const float dp[kW], float* g,
                                          int lane) {
  float a[4], hp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (lane & 16) ? h[kU0 + (i ^ 2)] : h[kU0 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) hp[i] = (lane & 8) ? a[i ^ 1] : a[i];  // row kU0 + (i ^ p)
  float v16[16], v8[kW];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int v = 0; v < kW; ++v)
      v16[i * kW + v] = fmaf(dp[v], hp[i], __shfl_xor_sync(0xffffffffu, dp[v] * hp[i + 2], 16));
  }
#pragma unroll
  for (int v = 0; v < kW; ++v) v8[v] = v16[v] + __shfl_xor_sync(0xffffffffu, v16[kW + v], 8);
  // v8[v]: row kU0 + p over the lanes that share bits 2..0; then over v
  fold<4>(v8, lane & 4);
  fold<2>(v8, lane & 2);
  fold<1>(v8, lane & 1);
  g[lane] += v8[0];  // row kU0 + p, column lane & 7: position lane
}

// An 8 -> 8 sine layer: hn, cn = sin, cos of (h @ w + bias), with w's row u
// at shared address w + woff(8u); the sums in newt::shaper_backward's order.
__device__ __forceinline__ void layer(const float h[kW], unsigned w, unsigned bias, float hn[kW],
                                      float cn[kW]) {
  float acc[kW], row[kW];
  lds8(w, row);
#pragma unroll
  for (int v = 0; v < kW; ++v) acc[v] = h[0] * row[v];
#pragma unroll
  for (int u = 1; u < kW; ++u) {
    lds8(w + woff(u * kW), row);
#pragma unroll
    for (int v = 0; v < kW; ++v) acc[v] += h[u] * row[v];
  }
  lds8(bias, row);
#pragma unroll
  for (int v = 0; v < kW; ++v) newt::psincos(acc[v] + row[v], &hn[v], &cn[v]);
}

// dh[u] = sum over v of dp[v] * w[u*8 + v], the layer's input cotangent
__device__ __forceinline__ void layer_back(const float dp[kW], unsigned w, float dh[kW]) {
  float row[kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    lds8(w + woff(u * kW), row);
    float d = 0.0f;
#pragma unroll
    for (int v = 0; v < kW; ++v) d += dp[v] * row[v];
    dh[u] = d;
  }
}

// newt::shaper_backward for the warp's 32 samples of one channel: wa is the
// shared address of the channel's weight row, gc its gradient row. Sums the first five groups'
// terms over the lanes into gc and leaves this lane's terms of the last group
// (w1, scale, b4) in `last`, for the caller to sum with the FiLM slots.
__device__ __forceinline__ void shaper_backward_lanes(float x, float ds, unsigned wa, float* gc,
                                                      int lane, float last[kLastTerms], float* y,
                                                      float* dx) {
  const float4 sb = lds4(wa + woff(kPScale));  // scale, b4, padding
  const float h0 = x * sb.x;
  float h1[kW], c1[kW], h2[kW], c2[kW], h3[kW], c3[kW], w[kW], bias[kW];
  lds8(wa + woff(kPW1), w);
  lds8(wa + woff(kPB1), bias);
#pragma unroll
  for (int v = 0; v < kW; ++v) newt::psincos(h0 * w[v] + bias[v], &h1[v], &c1[v]);
  layer(h1, wa + woff(kPW2), wa + woff(kPB2), h2, c2);
  layer(h2, wa + woff(kPW3), wa + woff(kPB3), h3, c3);
  lds8(wa + woff(kPW4), w);
  float acc4 = h3[0] * w[0];
#pragma unroll
  for (int u = 1; u < kW; ++u) acc4 += h3[u] * w[u];
  float c4;
  newt::psincos(acc4 + sb.y, y, &c4);

  const float dp4 = ds * c4;
  float g4[kLanes];  // the fifth group: b3, w4, b2, b1
  float dp[kW], dh[kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    g4[8 + u] = dp4 * h3[u];
    dp[u] = dp4 * w[u] * c3[u];  // dp3
    g4[u] = dp[u];
  }
  add_outer<0>(h2, dp, gc + kPW3, lane);
  add_outer<4>(h2, dp, gc + kPW3 + 32, lane);
  layer_back(dp, wa + woff(kPW3), dh);  // dh2
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    dp[v] = dh[v] * c2[v];  // dp2
    g4[16 + v] = dp[v];
  }
  add_outer<0>(h1, dp, gc + kPW2, lane);
  add_outer<4>(h1, dp, gc + kPW2 + 32, lane);
  layer_back(dp, wa + woff(kPW2), dh);  // dh1
  lds8(wa + woff(kPW1), w);
  float dh0 = 0.0f;
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    const float dp1 = dh[v] * c1[v];
    g4[24 + v] = dp1;
    last[v] = dp1 * h0;
    dh0 += dp1 * w[v];
  }
  gc[kPB3 + lane] += lane_sum(g4, lane);
  last[8] = dh0 * x;  // scale
  last[9] = dp4;      // b4
  *dx = dh0 * sb.x;
}

__global__ void __launch_bounds__(kThreads, 2)
film_shaper_cr_bwd_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          const float* __restrict__ dy,
                          float* __restrict__ d_exciter,
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
    const float* clip = film + static_cast<long long>(b) * tc * (4 * kC);
    for (int j = 0; j < n_chunk; ++j) {
      const int o0 = j * kLanes;
      const int n = min(kLanes, hop - o0) * kC;
      const long long base = (static_cast<long long>(seg) * hop + o0) * kC;
      for (int i = threadIdx.x; i < kLanes * kC; i += kThreads) {
        const int t = (i / kC) * kTileLd + i % kC;
        if (i < pend_n) d_exciter[pend_base + i] = se[t];
        if (i < n) {
          se[t] = exciter[base + i];
          sdy[t] = dy[base + i];
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
    d_exciter[pend_base + i] = se[(i / kC) * kTileLd + i % kC];
  float* out = w_part + static_cast<long long>(blockIdx.x) * kPlane;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    out[i] = sg[(i - k * kC) * kLd + row_pos(k)];
  }
}

}  // namespace

// The number of backward blocks resident on the current device at once
// (SMs x blocks per SM); it also allows the kernel its dynamic shared
// memory there, so call it once per device before the first launch. The
// caller launches min(this, B*Tc) blocks (one control segment per block at
// a time) and sizes the (blocks, 170, 64) weight partials with it. Returns
// -(CUDA error) on failure.
extern "C" int newt_fused_cr_backward_resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(film_shaper_cr_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_cr_bwd_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  return sms * per_sm;
}

// exciter, dy, d_exciter (B, Ta, 64); film, d_film (B, Tc, 256); weights,
// d_planes (170, 64); scratch film_part (B*Tc, 3, 256) and w_part
// (blocks, 170, 64), with blocks as newt_fused_cr_backward_resident_blocks
// says: contiguous float32 on the current device, Ta = Tc*hop. Launches the three kernels
// on `stream` and returns the first CUDA error (0 = launched).
extern "C" int newt_fused_cr_backward(const float* exciter, const float* film,
                                      const float* weights, const float* dy,
                                      float* d_exciter, float* d_film,
                                      float* d_planes, float* film_part,
                                      float* w_part, int b, int ta, int tc,
                                      int blocks, void* stream) {
  if (b <= 0 || tc <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hop = ta / tc;
  film_shaper_cr_bwd_kernel<<<blocks, kThreads, kSmemBytes, s>>>(
      exciter, film, weights, dy, d_exciter, film_part, w_part, b * tc, tc, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  newt::sum_weight_partials<<<(kPlane + 255) / 256, 256, 0, s>>>(w_part, d_planes, kPlane,
                                                                  blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(newt::fold_film(film_part, d_film, b, tc, s));
}
