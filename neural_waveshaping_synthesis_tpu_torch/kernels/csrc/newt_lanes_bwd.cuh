// The recompute backward of the sine-shaper bank with lanes as samples,
// float32: what the backwards newt_fused_cr_bwd.cu (kernel 2),
// newt_fused_fl_bwd.cu (kernel 6) and newt_fused_x_bwd.cu (kernel 8) share.
// A warp runs one channel over 32 samples, lane l holding sample l of a
// chunk, and sums the weight gradients across its lanes instead of keeping a
// gradient slot per thread.
//
//  * Weights as broadcasts: the channel-major rows of newt_shaper.cuh (kLd,
//    row_pos, lds4/lds8; the forward shaper_n reads them too). All lanes of
//    a warp read the same address, 4 weights per ld.shared.v4: 79 loads per
//    32 samples (43 in the recompute, 36 in the chain rule). In a row, the
//    six lane-sum groups below are positions 0-31, 32-63, 64-95, 96-127,
//    128-159 and 160-169; kernel 8 keeps its mixer bias and output-mix
//    weight gradients in the padding, 170 and 171.
//  * Weight-gradient sums across lanes: the 170 per-sample terms form six
//    groups of 32 (w3 in two, w2 in two; b3, w4, b2, b1; w1, scale, b4 and up
//    to 22 terms of the caller's). Each group is summed over the 32 lanes by
//    a fixed-order butterfly reduce-scatter (__shfl_xor_sync, 31 shuffles;
//    lane l ends with the sum of term l) and lane l adds it to position l of
//    the group in the block's (64, kLd) gradient table in shared memory. A
//    warp owns its channels' rows, so there is no race and no atomic. In the
//    four w2/w3 groups each lane orders its rows by its lane bits, so the
//    butterfly's first two steps need no select (22 FSEL, not 62).
//    shaper_backward_lanes sums the first five groups and leaves the last
//    group's 10 weight terms to the caller, which adds its own terms (the
//    FiLM slots, and kernel 8's mixer bias and output-mix weight) before
//    lane_sum; kernel 6 adds none and sums 16 slots with lane_sum16.
//
// Exactness: the recompute's sums run layer by layer, each over the input
// rows in ascending order, as the plain version sums h @ w.
#pragma once

#include "newt_shaper_bwd.cuh"

namespace newt {

constexpr int kLanes = 32;
constexpr int kTileLd = kC + 1;  // a staging tile's row, padded
constexpr int kFilmSlots = 12;   // FilmSegment's (3, 4) cotangent slots
constexpr int kLastTerms = 10;  // weight terms of the last group: w1, scale, b4

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

// -> in lane l, the sum of v[l & 15] over the warp's 32 lanes, in a fixed
// order: a group of 16 terms (the last group, when the caller adds none of
// its own) in 16 shuffles, not lane_sum's 31. Lanes l and l ^ 16 add the
// same two halves, so they hold the same bits.
__device__ __forceinline__ float lane_sum16(float (&v)[16], int lane) {
  fold<8>(v, lane & 8);
  fold<4>(v, lane & 4);
  fold<2>(v, lane & 2);
  fold<1>(v, lane & 1);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
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
// at shared address w + woff(8u); each output summed over rows u ascending.
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

// The recompute of the shaper (keeping its activations and sine
// derivatives) and the chain rule of JAX _bwd_core from ds, the cotangent of
// the shaper's output (dy * gamma_out), for the warp's 32 samples of one
// channel: wa is the shared address of the channel's weight row, gc its
// gradient row. Returns the shaper's output in *y (for d gamma_out) and the
// cotangent of x in *dx. Sums the first five groups' terms over the lanes
// into gc and leaves this lane's terms of the last group (w1, scale, b4) in
// `last`, for the caller to sum with its own terms.
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

}  // namespace newt
