// What every backward kernel shares once it has its FiLM values in
// registers, float32: the sine-and-cosine polynomial, the control-rate FiLM
// segment, the fixed-order sum of the per-block weight-gradient partials,
// and the fold of the control-rate FiLM gradient. The backwards
// newt_fused_cr_bwd.cu, newt_fused_fl_bwd.cu and newt_fused_x_bwd.cu
// (kernels 2, 6 and 8) run the shaper's recompute and chain rule with lanes
// as samples (newt_lanes_bwd.cuh) on the weights of newt_shaper.cuh.
//
// The cosine fit is ops/fastmath.py _COS_EVEN_COEFFS, sharing the sine's
// range reduction (rintf: round half to even, as jnp.round).
#pragma once

#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace newt {

constexpr int kPlane = kRows * kC;

// float32 roundings of the cosine fit's coefficients, written exactly.
constexpr float kK0 = 0x1.000000p+0f;
constexpr float kK1 = -0x1.000000p-1f;
constexpr float kK2 = 0x1.555554p-5f;
constexpr float kK3 = -0x1.6c1696p-10f;
constexpr float kK4 = 0x1.a01592p-16f;
constexpr float kK5 = -0x1.27a71cp-22f;
constexpr float kK6 = 0x1.1b2c92p-29f;
constexpr float kK7 = -0x1.5614d2p-37f;

// sine and cosine of one argument, sharing the range reduction
__device__ __forceinline__ void psincos(float x, float* sn, float* cs) {
  const float r = x - kTau * rintf(x * kInvTau);
  const float s = r * r;
  float p = kS6;
  p = p * s + kS5;
  p = p * s + kS4;
  p = p * s + kS3;
  p = p * s + kS2;
  p = p * s + kS1;
  p = p * s + kS0;
  *sn = r * p;
  float q = kK7;
  q = q * s + kK6;
  q = q * s + kK5;
  q = q * s + kK4;
  q = q * s + kK3;
  q = q * s + kK2;
  q = q * s + kK1;
  q = q * s + kK0;
  *cs = q;
}

// The control-rate FiLM of one segment (clip, frame m) of hop samples, for the
// backwards that walk segments (newt_fused_cr_bwd.cu, newt_fused_x_bwd.cu):
// frames m-1, m and m+1 (clamped) of channel c read once into registers, and
// the cotangents of those frames summed in registers by clamped frame (slot
// 0, 1, 2), with no reduction across threads. at() is newt::film_at for
// sample o of the segment, bit for bit; add() is its transpose (the left
// frame with weight 1-w, the right with w; the head and tail clamps land on
// frames 0 and tc-1); store() writes the (3, 4*kC) partial that
// fold_film_partials sums.
struct FilmSegment {
  float frame[3][4];
  float slot[3][4];
  int m, hop;
  bool has_next;

  // clip: float32 or bfloat16 frames (kernel 2's instances), widened here
  template <typename TF>
  __device__ __forceinline__ void load(const TF* clip, int m_, int tc, int hop_, int c) {
    m = m_;
    hop = hop_;
    has_next = m + 1 < tc;
    const int f[3] = {max(m - 1, 0), m, min(m + 1, tc - 1)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        frame[j][a] = load_f32(clip + static_cast<long long>(f[j]) * (4 * kC) + a * kC + c);
        slot[j][a] = 0.0f;
      }
    }
  }

  __device__ __forceinline__ void at(int o, float film[4], float* w, float* omw, bool* lo) const {
    const int two_o1 = 2 * o + 1;
    *lo = two_o1 < hop;
    *w = __fdiv_rn(static_cast<float>(*lo ? two_o1 + hop : two_o1 - hop),
                   static_cast<float>(2 * hop));
    if (*lo && m == 0) *w = 0.0f;
    *omw = __fsub_rn(1.0f, *w);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      film[a] = lerp_exact(*lo ? frame[0][a] : frame[1][a], *lo ? frame[1][a] : frame[2][a], *w,
                           *omw);
  }

  __device__ __forceinline__ void add(const float d[4], float w, float omw, bool lo) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float dl = omw * d[a];
      const float dr = w * d[a];
      if (lo) {
        if (m > 0) slot[0][a] += dl; else slot[1][a] += dl;
        slot[1][a] += dr;
      } else {
        slot[1][a] += dl;
        if (has_next) slot[2][a] += dr; else slot[1][a] += dr;
      }
    }
  }

  // part: this segment's (3, 4*kC) partial, offset to channel c
  __device__ __forceinline__ void store(float* part) const {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int a = 0; a < 4; ++a) part[(j * 4 + a) * kC] = slot[j][a];
    }
  }
};

// d_planes[i] = sum over blocks k = 0, 1, ... of w_part[k, i], in that order,
// for i < n (each block's partial is n floats; kPlane for the shaper planes
// alone): the second pass of the deterministic cross-block gradient sum.
__global__ void sum_weight_partials(const float* __restrict__ w_part,
                                    float* __restrict__ d_planes, int n, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += w_part[static_cast<long long>(k) * n + i];
  d_planes[i] = s;
}

// The control-rate FiLM gradient's second pass, for the backwards that walk
// control segments (newt_fused_cr_bwd.cu, newt_fused_x_bwd.cu): each segment
// (b, m) left its FiLM cotangents summed by clamped frame in part[seg, slot]
// (slot 0, 1, 2 = frame m-1, m, m+1); d_film[b, f, j] = part[f-1, slot 2] +
// part[f, slot 1] + part[f+1, slot 0] over the segments of clip b that exist,
// in that order. The sum is float32; a bfloat16 d_film (kernel 2's bf16
// instance) is rounded once as it is stored.
template <typename TF>
__global__ void fold_film_partials(const float* __restrict__ part,
                                   TF* __restrict__ d_film, long long n, int tc) {
  const int width = 4 * kC;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long seg = idx / width;
    const int j = static_cast<int>(idx - seg * width);
    const int f = static_cast<int>(seg % tc);
    float s = 0.0f;
    if (f > 0) s += part[((seg - 1) * 3 + 2) * width + j];
    s += part[(seg * 3 + 1) * width + j];
    if (f + 1 < tc) s += part[((seg + 1) * 3 + 0) * width + j];
    store_as(d_film + idx, s);
  }
}

// Launches fold_film_partials for b clips of tc frames on `stream`.
template <typename TF>
inline cudaError_t fold_film(const float* part, TF* d_film, int b, int tc,
                             cudaStream_t stream) {
  const long long n = static_cast<long long>(b) * tc * 4 * kC;
  const long long want = (n + 255) / 256;
  const int grid = static_cast<int>(want < 65535 ? want : 65535);
  fold_film_partials<TF><<<grid, 256, 0, stream>>>(part, d_film, n, tc);
  return cudaGetLastError();
}

}  // namespace newt
