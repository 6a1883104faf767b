// The exciter of the exciter-fused kernels newt_fused_x.cu (forward) and
// newt_fused_x_bwd.cu (backward), float32: one harmonic's sine (bank_sin,
// both kernels), and for the forward one sample's antialiased harmonic bank,
// built by the 64 threads of that sample, and its H -> 64 mix. The backward
// builds a 32-sample bank tile with bank_sin and mixes it in a block-wide
// product of its own, each output summed in mix's order.
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

// Thread c of a sample's 64 writes harmonics c+1 and c+65 of that sample
// into row[c] and row[c + 64]: zero past n_harm and where f0*k >= half_sr.
// off_lo / off_hi are offsets[c] and offsets[c + 64] (0 past n_harm).
__device__ __forceinline__ void fill_bank_row(float* row, float phase, float f0,
                                              float off_lo, float off_hi, int c,
                                              int n_harm, float half_sr) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = c + 1 + j * kC;
    const float kf = static_cast<float>(k);
    const bool live = k <= n_harm && __fmul_rn(f0, kf) < half_sr;
    row[c + j * kC] = live ? bank_sin(phase, kf, j ? off_hi : off_lo) : 0.0f;
  }
}

// Channel c of the harmonic mixer for one bank row: sum over k < n_harm of
// row[k] * w[k, c] (w staged channel fastest), then + bias, as x @ w + b.
__device__ __forceinline__ float mix(const float* row, const float* w, int c, int n_harm,
                                     float bias) {
  float acc = 0.0f;
  for (int k = 0; k < n_harm; ++k) acc += row[k] * w[k * kC + c];
  return acc + bias;
}

}  // namespace newt
