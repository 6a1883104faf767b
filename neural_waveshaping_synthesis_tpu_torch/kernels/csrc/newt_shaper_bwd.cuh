// The recompute backward of the sine-shaper bank for one (sample, channel),
// float32: what the backward kernels newt_fused_cr_bwd.cu (control-rate
// FiLM) and newt_fused_fl_bwd.cu (audio-rate FiLM) share once each has its
// FiLM values in registers, and the fixed-order sum of their per-block
// weight-gradient partials.
//
// The weights are the packed (170, 64) planes of newt_shaper.cuh, staged in
// shared memory by the kernel. Each thread owns one (170,) weight-gradient
// slot in shared memory, channel fastest (my[k * kC] is plane row k of the
// thread's channel), so a warp's slot accesses are 32 consecutive floats.
//
// The cosine fit is ops/fastmath.py _COS_EVEN_COEFFS, sharing the sine's
// range reduction (rintf: round half to even, as jnp.round).
#pragma once

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

// For x = gamma_in * exciter + beta_in of channel c: recomputes the shaper
// (keeping its activations and sine derivatives), then runs the chain rule
// of JAX _bwd_core from ds, the cotangent of the shaper's output (dy *
// gamma_out). Adds this sample's 170 weight-plane gradients into the
// thread's slot `my`; returns the shaper's output in *y (for d gamma_out)
// and the cotangent of x in *dx.
__device__ __forceinline__ void shaper_backward(float x, float ds, const float* sw, int c,
                                                float* my, float* y, float* dx) {
  const float scale = sw[kScale * kC + c];
  const float h0 = x * scale;
  float h1[kW], c1[kW], h2[kW], c2[kW], h3[kW], c3[kW];
#pragma unroll
  for (int v = 0; v < kW; ++v)
    psincos(h0 * sw[(kW1 + v) * kC + c] + sw[(kB1 + v) * kC + c], &h1[v], &c1[v]);
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    float acc2 = h1[0] * sw[(kW2 + v) * kC + c];
#pragma unroll
    for (int u = 1; u < kW; ++u) acc2 += h1[u] * sw[(kW2 + u * kW + v) * kC + c];
    psincos(acc2 + sw[(kB2 + v) * kC + c], &h2[v], &c2[v]);
  }
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    float acc3 = h2[0] * sw[(kW3 + v) * kC + c];
#pragma unroll
    for (int u = 1; u < kW; ++u) acc3 += h2[u] * sw[(kW3 + u * kW + v) * kC + c];
    psincos(acc3 + sw[(kB3 + v) * kC + c], &h3[v], &c3[v]);
  }
  float acc4 = h3[0] * sw[kW4 * kC + c];
#pragma unroll
  for (int u = 1; u < kW; ++u) acc4 += h3[u] * sw[(kW4 + u) * kC + c];
  float c4;
  psincos(acc4 + sw[kB4 * kC + c], y, &c4);

  const float dp4 = ds * c4;
  my[kB4 * kC] += dp4;
  float dp[kW], dh[kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    my[(kW4 + u) * kC] += dp4 * h3[u];
    dp[u] = dp4 * sw[(kW4 + u) * kC + c] * c3[u];  // dp3
  }
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    float d = 0.0f;
#pragma unroll
    for (int v = 0; v < kW; ++v) {
      my[(kW3 + u * kW + v) * kC] += dp[v] * h2[u];
      d += dp[v] * sw[(kW3 + u * kW + v) * kC + c];
    }
    dh[u] = d;  // dh2
  }
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    my[(kB3 + v) * kC] += dp[v];
    dp[v] = dh[v] * c2[v];  // dp2
  }
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    float d = 0.0f;
#pragma unroll
    for (int v = 0; v < kW; ++v) {
      my[(kW2 + u * kW + v) * kC] += dp[v] * h1[u];
      d += dp[v] * sw[(kW2 + u * kW + v) * kC + c];
    }
    dh[u] = d;  // dh1
  }
  float dh0 = 0.0f;
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    my[(kB2 + v) * kC] += dp[v];
    const float dp1 = dh[v] * c1[v];
    my[(kB1 + v) * kC] += dp1;
    my[(kW1 + v) * kC] += dp1 * h0;
    dh0 += dp1 * sw[(kW1 + v) * kC + c];
  }
  my[kScale * kC] += dh0 * x;
  *dx = dh0 * scale;
}

// d_planes[i] = sum over blocks k = 0, 1, ... of w_part[k, i], in that order:
// the second pass of the deterministic cross-block weight-gradient sum.
__global__ void sum_weight_partials(const float* __restrict__ w_part,
                                    float* __restrict__ d_planes, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kPlane) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += w_part[static_cast<long long>(k) * kPlane + i];
  d_planes[i] = s;
}

}  // namespace newt
