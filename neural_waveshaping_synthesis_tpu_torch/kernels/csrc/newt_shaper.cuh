// The learned sine-shaper bank of the forwards, float32: shaper_n runs S
// samples of one channel, each weight read once for all S, from a
// channel-major copy of the weights that the lane-sum backwards read too
// (kernel 3, newt_fused_stream.cu, calls it directly); around it the group
// routines of the fused forwards, FiLM -> shaper_n -> FiLM over S consecutive
// flat samples: film_shaper_cr_n with the control-rate FiLM lerped per sample
// (film_at; newt_fused_cr.cu, kernel 1, and newt_fused_x.cu, kernel 7) and
// film_shaper_fl_n with the audio-rate FiLM read per sample (newt_fused_fl.cu,
// kernel 5).
//
// The kernels take the packed (170, 64) planes of kernels/newt_fused.py
// pack_weights, channel fastest (the JAX pack_weights layout): scale, w1 (8),
// b1 (8), w2 (64, row u*8+v), b2 (8), w3 (64), b3 (8), w4 (8), b4 (1), and
// stage them once per block into the channel-major rows (stage_weight_rows).
//
// The polynomial sine reduces with rintf (round half to even, like
// jnp.round / torch.round; roundf would round half away from zero) and runs
// in f32 with the coefficients rounded to f32, as ops/fastmath.py. FMA
// contraction of the reduction, the Horner chain and the MLP's sums is
// allowed: the kernel-vs-plain tolerance (rtol 1e-4, atol 1e-5) absorbs it.
//
// The arithmetic is float32 whatever the I/O type: load_f32 widens a
// bfloat16 exciter, FiLM or cotangent exactly on its way in, and store_as
// rounds a result once, to nearest even, on its way out (kernels 1, 2, 5 and
// 6 take float32 or bfloat16 I/O; the others float32).
#pragma once

#include <cuda_bf16.h>

namespace newt {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kC = 64;  // channels (waveshapers)
constexpr int kW = 8;   // shaper width

// Row offsets of the packed weight planes, each row kC channels wide.
constexpr int kScale = 0;
constexpr int kW1 = 1;
constexpr int kB1 = kW1 + kW;
constexpr int kW2 = kB1 + kW;
constexpr int kB2 = kW2 + kW * kW;
constexpr int kW3 = kB2 + kW;
constexpr int kB3 = kW3 + kW * kW;
constexpr int kW4 = kB3 + kW;
constexpr int kB4 = kW4 + kW;
constexpr int kRows = kB4 + 1;  // 170

// float32 roundings of 2*pi, 1/(2*pi) and the sine fit's coefficients
// (ops/fastmath.py _SIN_ODD_COEFFS), written exactly.
constexpr float kTau = 0x1.921fb6p+2f;
constexpr float kInvTau = 0x1.45f306p-3f;
constexpr float kS0 = 0x1.000000p+0f;
constexpr float kS1 = -0x1.555552p-3f;
constexpr float kS2 = 0x1.1110e0p-7f;
constexpr float kS3 = -0x1.a01402p-13f;
constexpr float kS4 = 0x1.717e48p-19f;
constexpr float kS5 = -0x1.a7f056p-26f;
constexpr float kS6 = 0x1.27c49ep-33f;

__device__ __forceinline__ float psin(float x) {
  const float r = x - kTau * rintf(x * kInvTau);
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

// left*(1-w) + right*w written with __fmul_rn/__fadd_rn, so that nvcc's
// default FMA contraction cannot fuse it: the in-kernel FiLM then equals
// ops/upsample.py linear_upsample bit for bit.
__device__ __forceinline__ float lerp_exact(float left, float right, float w,
                                            float one_minus_w) {
  return __fadd_rn(__fmul_rn(left, one_minus_w), __fmul_rn(right, w));
}

// The four FiLM values (gamma_in, beta_in, gamma_out, beta_out) of channel c
// at audio sample t = m*hop + o of a clip, from the clip's (tc, 4*kC)
// control-rate frames at `clip`: linear_upsample's align_corners=False lerp
// between two frames. The weight is ONE IEEE division of exact integers,
// (2o+1 +- hop) / (2*hop) (__fdiv_rn; the build does not use
// --use_fast_math); the head clamp (the first half-hop copies frame 0) is a
// lerp of weight 0 between two copies of frame 0, the tail clamp one between
// two copies of the last. A bfloat16 `clip` is widened before the lerp.
template <typename TF>
__device__ __forceinline__ void film_at(const TF* clip, int m, int o, int hop, int tc, int c,
                                        float film[4]) {
  const int two_o1 = 2 * o + 1;
  const bool lo = two_o1 < hop;
  const int f_left = lo ? max(m - 1, 0) : m;
  const int f_right = lo ? m : min(m + 1, tc - 1);
  float w = __fdiv_rn(static_cast<float>(lo ? two_o1 + hop : two_o1 - hop),
                      static_cast<float>(2 * hop));
  if (lo && m == 0) w = 0.0f;  // head clamp: frame 0 exactly
  const float omw = __fsub_rn(1.0f, w);
  const TF* fl = clip + static_cast<long long>(f_left) * (4 * kC) + c;
  const TF* fr = clip + static_cast<long long>(f_right) * (4 * kC) + c;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    film[a] = lerp_exact(load_f32(fl + a * kC), load_f32(fr + a * kC), w, omw);
}

// The channel-major copy of the weights that shaper_n reads, and the
// lane-sum backwards (newt_lanes_bwd.cuh) too: in shared memory, one row of
// the 170 weights per channel, padded to kLd = 172 floats (16-B aligned), in
// an order where every 8-wide group starts on 16 bytes (row_pos), read 4
// weights per ld.shared.v4. With lanes as channels (shaper_n) the 8 channels
// of a quarter-warp start 12 banks apart (172 mod 32), so each 16-B load
// touches 32 distinct banks; with lanes as samples (the backwards) all lanes
// read one address, a broadcast. 170 and 171 are padding.
constexpr int kLd = 172;   // a channel's row of 170, padded to 16 bytes
constexpr int kPW3 = 0;    // w3 (64), u*8+v
constexpr int kPW2 = 64;   // w2 (64), u*8+v
constexpr int kPB3 = 128;  // b3 (8)
constexpr int kPW4 = 136;  // w4 (8)
constexpr int kPB2 = 144;  // b2 (8)
constexpr int kPB1 = 152;  // b1 (8)
constexpr int kPW1 = 160;  // w1 (8)
constexpr int kPScale = 168;
constexpr int kPB4 = 169;

// position in a channel's row of packed plane row k (pack_weights order)
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
// channel, constant offsets). volatile: the compiler reads the weights where
// they are used (again where the chain rule needs them; in every pass of a
// kernel's loop) instead of holding 170 in registers.
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

// Copies the (kRows, kC) weight planes into the channel-major rows (kC,
// kLd) at sw (16-B aligned); the caller synchronises the block afterwards.
__device__ __forceinline__ void stage_weight_rows(float* sw, const float* __restrict__ weights,
                                                  int n_threads) {
  for (int i = threadIdx.x; i < kRows * kC; i += n_threads) {
    const int k = i / kC;
    sw[(i - k * kC) * kLd + row_pos(k)] = weights[i];
  }
}

// One 8 -> 8 sine layer for S samples: o[v] = psin(sum_u h[u] w(u, v) + b[v]),
// the weights from channel rows at shared addresses w_addr (w(u, v) at u*8+v)
// and b_addr. u runs outermost, so each weight row w(u, 0..7) is two 16-B
// loads, and each sum still runs over u = 0..7 in order.
template <int S>
__device__ __forceinline__ void sine_layer_n(const float (&h)[kW][S], unsigned w_addr,
                                             unsigned b_addr, float (&o)[kW][S]) {
  float w[kW];
  lds8(w_addr, w);
#pragma unroll
  for (int v = 0; v < kW; ++v)
#pragma unroll
    for (int i = 0; i < S; ++i) o[v][i] = h[0][i] * w[v];
#pragma unroll
  for (int u = 1; u < kW; ++u) {
    lds8(w_addr + woff(u * kW), w);
#pragma unroll
    for (int v = 0; v < kW; ++v)
#pragma unroll
      for (int i = 0; i < S; ++i) o[v][i] += h[u][i] * w[v];
  }
  lds8(b_addr, w);
#pragma unroll
  for (int v = 0; v < kW; ++v)
#pragma unroll
    for (int i = 0; i < S; ++i) o[v][i] = psin(o[v][i] + w[v]);
}

// The 1 -> 8 -> 8 -> 8 -> 1 sine MLP of channel c for S samples at once
// (input scale first, a polynomial sine after every layer, each sum over
// its inputs in order), with the weights in the channel-major rows at sw
// (stage_weight_rows). Each weight is read from shared memory once for all S
// samples (43 ld.shared.v4 per S samples), and the S samples' layers
// interleave, so a thread runs S independent chains. Every sample takes the
// same operations in the same order, so a sample's bits do not depend on its
// slot in a group, nor on S.
template <int S>
__device__ __forceinline__ void shaper_n(const float (&x)[S], const float* sw, int c,
                                         float (&y)[S]) {
  const unsigned a = smem_addr(sw) + woff(c * kLd);
  float h1[kW][S], h2[kW][S], w[kW], b[kW];
  const float4 tail = lds4(a + woff(kPScale));  // scale, b4
  lds8(a + woff(kPW1), w);
  lds8(a + woff(kPB1), b);
#pragma unroll
  for (int v = 0; v < kW; ++v)
#pragma unroll
    for (int i = 0; i < S; ++i) h1[v][i] = psin((x[i] * tail.x) * w[v] + b[v]);
  sine_layer_n<S>(h1, a + woff(kPW2), a + woff(kPB2), h2);
  sine_layer_n<S>(h2, a + woff(kPW3), a + woff(kPB3), h1);  // h1 now holds layer 3
  lds8(a + woff(kPW4), w);
  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = h1[0][i] * w[0];
#pragma unroll
  for (int u = 1; u < kW; ++u)
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] += h1[u][i] * w[u];
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = psin(acc[i] + tail.y);
}

// The control-rate chain of S consecutive samples s0 .. s0+S-1 of the flat
// (B, Ta) sample index and channel c, a thread's group in kernels 1 and 7:
// y[i] = gamma_out * shaper_n(gamma_in * exc[i] + beta_in) + beta_out, the
// FiLM at sample s0+i from the (B, tc, 4*kC) control-rate `film` (film_at),
// the shaper shaper_n's, on the channel-major rows at sw. The clip, frame and
// in-frame offset are divided out once (s0 < n_samples) and stepped from
// sample to sample, across a frame's and a clip's end too (a group may
// straddle two clips: B*Ta need not be a multiple of S). Each sample keeps
// film_at's own frame pair and division. Samples at or past n_samples run on
// zeros; the caller stores nothing for them. `film` is float32 or bfloat16
// (kernel 1's instances); film_at widens it.
template <int S, typename TF>
__device__ __forceinline__ void film_shaper_cr_n(const float (&exc)[S], const TF* film, int s0,
                                                 int n_samples, int ta, int tc, int hop,
                                                 const float* sw, int c, float (&y)[S]) {
  const int b = s0 / ta;
  const int t = s0 - b * ta;
  int m = t / hop;
  int o = t - m * hop;
  const TF* clip = film + static_cast<long long>(b) * tc * (4 * kC);
  float x[S], g_out[S], b_out[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x[i] = g_out[i] = b_out[i] = 0.0f;
    if (s0 + i < n_samples) {
      float f[4];  // gamma_in, beta_in, gamma_out, beta_out
      film_at(clip, m, o, hop, tc, c, f);
      x[i] = f[0] * exc[i] + f[1];
      g_out[i] = f[2];
      b_out[i] = f[3];
    }
    if (++o == hop) {
      o = 0;
      if (++m == tc) {
        m = 0;
        clip += static_cast<long long>(tc) * (4 * kC);
      }
    }
  }
  shaper_n<S>(x, sw, c, y);
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = g_out[i] * y[i] + b_out[i];
}

// The audio-rate chain of S consecutive samples s0 .. s0+S-1 of the flat
// (B*Ta) sample index and channel c, a thread's group in kernel 5: as
// film_shaper_cr_n, with each sample's four FiLM values read from the
// (B*Ta, 4*kC) audio-rate `film` (gamma_in, beta_in, gamma_out, beta_out at
// film[s, a*kC + c]; lanes are channels, so each of a warp's loads is 128
// bytes) instead of lerped, in film_shaper_cr_n's expressions and order, so
// that fed linear_upsample of a control-rate FiLM it gives
// film_shaper_cr_n's bits. The audio-rate FiLM has no clip structure, so a
// group that straddles two clips needs nothing more. Samples at or past
// n_samples run on zeros and read nothing; the caller stores nothing for
// them. `film` is float32 or bfloat16 (kernel 5's instances); load_f32 widens
// each of its four reads.
template <int S, typename TF>
__device__ __forceinline__ void film_shaper_fl_n(const float (&exc)[S], const TF* film, int s0,
                                                 int n_samples, const float* sw, int c,
                                                 float (&y)[S]) {
  float x[S], g_out[S], b_out[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x[i] = g_out[i] = b_out[i] = 0.0f;
    if (s0 + i < n_samples) {
      const TF* f = film + static_cast<long long>(s0 + i) * (4 * kC) + c;
      x[i] = load_f32(f) * exc[i] + load_f32(f + kC);
      g_out[i] = load_f32(f + 2 * kC);
      b_out[i] = load_f32(f + 3 * kC);
    }
  }
  shaper_n<S>(x, sw, c, y);
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = g_out[i] * y[i] + b_out[i];
}

}  // namespace newt
