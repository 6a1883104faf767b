// The exciter of the exciter-fused kernels newt_fused_x.cu (forward) and
// newt_fused_x_bwd.cu (backward), float32: one harmonic's sine (bank_sin,
// both kernels), and for the forward the antialiased harmonic bank of a
// group of S consecutive samples, built by the group's 64 threads into a
// shared (H, S) tile, and its H -> 64 mix. The backward builds a 32-sample
// bank tile with bank_sin and mixes it in a block-wide product of its own,
// each output summed in mix's order.
//
// The bank is ops/oscillator.py bank_from_wrapped_phase for one sample:
// harmonic k = 1..H is sin(phase*k + offset[k-1]) by the polynomial sine,
// zeroed where f0*k >= sr/2. Its argument reaches tau*H (~640 rad at H = 101,
// where one float32 ulp is 6.1e-5), so the argument and its range reduction
// are written with __fmul_rn/__fadd_rn/__fsub_rn and rintf: no FMA
// contraction, rounded where the plain version (and ops/fastmath.py
// _reduce) rounds. A contracted argument would move each harmonic by up to
// ~3e-5, and the mix adds 101 of them. The mask's product is __fmul_rn too.
// The Horner chain may contract, as in newt_shaper.cuh.
#pragma once

#include "newt_shaper.cuh"

namespace newt {

// The most harmonics the kernels take: a bank row and the staged mixer are
// sized for it (kernels/newt_fused.py H_MAX).
constexpr int kMaxHarmonics = 2 * kC;

__device__ __forceinline__ float bank_sin(float phase, float k, float offset) {
  const float x = __fadd_rn(__fmul_rn(phase, k), offset);
  const float r = __fsub_rn(x, __fmul_rn(kTau, rintf(__fmul_rn(x, kInvTau))));
  const float s = r * r;
  float p = kS6;
  p = p * s + kS5;
  p = p * s + kS4;
  p = p * s + kS3;
  p = p * s + kS2;
  p = p * s + kS1;
  p = p * s + kS0;
  return r * p;
}

// S floats (S a multiple of 4) from / to shared memory at p, 16-B aligned,
// as S/4 16-byte accesses.
template <int S>
__device__ __forceinline__ void sts_n(float* p, const float (&v)[S]) {
  static_assert(S % 4 == 0, "16-byte accesses");
#pragma unroll
  for (int q = 0; q < S; q += 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

template <int S>
__device__ __forceinline__ void lds_n(const float* p, float (&v)[S]) {
  static_assert(S % 4 == 0, "16-byte accesses");
#pragma unroll
  for (int q = 0; q < S; q += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + q);
    v[q] = a.x, v[q + 1] = a.y, v[q + 2] = a.z, v[q + 3] = a.w;
  }
}

// Thread c of a group writes harmonics c+1 and c+65 of the group's S samples
// s0 .. s0+S-1 into rows c and c+64 of its (kMaxHarmonics, S) tile (a
// sample fastest, one 16-B store per row at S = 4): zero past n_harm, where
// f0*k >= half_sr, and for samples at or past n_samples (their f0 taken as
// half_sr). off_lo / off_hi are offsets[c] and offsets[c + 64] (0 past
// n_harm).
template <int S>
__device__ __forceinline__ void fill_bank_tile(float* tile, const float* __restrict__ phase,
                                               const float* __restrict__ f0, int s0,
                                               int n_samples, float off_lo, float off_hi, int c,
                                               int n_harm, float half_sr) {
  float ph[S], hz[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const bool in = s0 + i < n_samples;
    ph[i] = in ? phase[s0 + i] : 0.0f;
    hz[i] = in ? f0[s0 + i] : half_sr;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = c + 1 + j * kC;
    const float kf = static_cast<float>(k);
    float v[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const bool live = k <= n_harm && __fmul_rn(hz[i], kf) < half_sr;
      v[i] = live ? bank_sin(ph[i], kf, j ? off_hi : off_lo) : 0.0f;
    }
    sts_n<S>(tile + (c + j * kC) * S, v);
  }
}

// Channel c of the harmonic mixer for the S samples of a bank tile: out[i] =
// sum over k < n_harm of tile[k][i] * w[k, c] (w staged channel fastest),
// then + bias, as x @ w + b. Per k one read of w[k, c] and one broadcast read
// of the tile's row k serve S multiply-adds.
template <int S>
__device__ __forceinline__ void mix(const float* tile, const float* w, int c, int n_harm,
                                    float bias, float (&out)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) out[i] = 0.0f;
  for (int k = 0; k < n_harm; ++k) {
    const float wk = w[k * kC + c];
    float r[S];
    lds_n<S>(tile + k * S, r);
#pragma unroll
    for (int i = 0; i < S; ++i) out[i] += r[i] * wk;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) out[i] += bias;
}

}  // namespace newt
