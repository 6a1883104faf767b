// Control-rate FiLM -> sine-shaper bank -> FiLM, forward, float32.
//
// Replaces the TPU kernel kernels/newt_fused.py:779 film_shaper_fused_cr
// (Pallas: _fwd_kernel_cr, _interp_w_cr, _film_planes_cr, _forward_core,
// _psin) of the JAX package. Same function, not the same layout: the
// row-pair 128-lane packing, the per-tile frame windows and the
// "tile = 2 hops" geometry were Mosaic artefacts and are gone.
//
// What it computes, for audio sample s = m*hop + o of clip b and channel c:
//   film_a(s) = lerp of film_c[b, :, a*64 + c] between two control frames
//               (a = gamma_in, beta_in, gamma_out, beta_out), align_corners
//               =False, exactly as ops/upsample.py linear_upsample;
//   x  = gamma_in * exciter + beta_in;
//   y  = psin(l4(psin(l3(psin(l2(psin(l1(x * input_scale)))))))), a per-
//        channel 1 -> 8 -> 8 -> 8 -> 1 MLP with a polynomial sine after
//        every layer;
//   out = gamma_out * y + beta_out.
//
// What bounds it on an H100: arithmetic, not memory. Per (sample, channel)
// it does 25 polynomial sines (~10 f32 operations each) and 144 multiply-
// adds of the MLP, ~0.75 kFLOP counting an FMA as two, against 8 bytes of
// exciter in and out (the control-rate film and the weights are small and
// stay in L2). At 67 TFLOP/s f32 and 3.35 TB/s that is ~90 FLOP per byte
// against a ridge of ~20: FP32 ALU throughput bounds it.
//
// What the design does about it: one thread per (sample, channel), channels
// fastest, so a warp's exciter loads, output stores and film loads are
// 128-byte coalesced and nothing but the result goes back to memory. The
// nine weight planes (170 x 64 f32, 43.5 KB) sit in shared memory in the
// pack_weights channel-fastest layout, so a warp's weight reads hit 32
// distinct banks. Blocks stride over the samples (grid = what fits on the
// card at once), so each block stages the weights once. The FiLM
// interpolation is done in registers: the (B, Ta, 256) audio-rate film
// never exists. Not yet done (later work): reusing each shared-memory
// weight read for several samples, packed f32x2 FMA.
//
// Where the numbers would trip, and what holds them:
//  * FiLM interpolation is bit-exact to linear_upsample: the weight is ONE
//    IEEE f32 division of exact integers, (2o+1 +- hop) / (2*hop), via
//    __fdiv_rn (the build does not use --use_fast_math, which would make
//    division approximate); the lerp left*(1-w) + right*w is written with
//    __fsub_rn/__fmul_rn/__fadd_rn so that nvcc's default FMA contraction
//    cannot fuse it. The head clamp (first half-hop of a clip copies frame
//    0) is folded in as w = 0 between two copies of frame 0, which gives
//    frame 0 exactly; the tail clamp is a lerp between two copies of the
//    last frame, as in linear_upsample.
//  * The polynomial sine reduces with rintf (round half to even, like
//    jnp.round / torch.round; roundf would round half away from zero) and
//    runs in f32 with the coefficients rounded to f32, as ops/fastmath.py.
//    FMA contraction of the reduction and the Horner chain is allowed: the
//    kernel-vs-plain tolerance (rtol 1e-4, atol 1e-5) absorbs it.
//  * Index arithmetic: samples are counted in 32-bit ints (the wrapper
//    refuses B*Ta > 2^30, so the strided index cannot overflow), element
//    and film offsets in 64-bit.
#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;       // channels (waveshapers)
constexpr int kW = 8;        // shaper width
constexpr int kThreads = 256;  // 4 samples x 64 channels per block pass
constexpr int kSamplesPerPass = kThreads / kC;

// Row offsets of the packed weight planes, each row 64 channels wide
// (the JAX pack_weights layout): scale, w1, b1, w2 (rows u*8+v), b2, w3,
// b3, w4, b4.
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

__device__ __forceinline__ float lerp_exact(float left, float right, float w,
                                            float one_minus_w) {
  return __fadd_rn(__fmul_rn(left, one_minus_w), __fmul_rn(right, w));
}

__global__ void __launch_bounds__(kThreads)
film_shaper_cr_kernel(const float* __restrict__ exciter,
                      const float* __restrict__ film,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int n_samples, int ta, int tc,
                      int hop) {
  __shared__ float sw[kRows * kC];
  for (int i = threadIdx.x; i < kRows * kC; i += kThreads) sw[i] = weights[i];
  __syncthreads();

  const int c = threadIdx.x % kC;
  const float scale = sw[kScale * kC + c];
  const float den = static_cast<float>(2 * hop);
  const int stride = gridDim.x * kSamplesPerPass;

  for (int s = blockIdx.x * kSamplesPerPass + threadIdx.x / kC; s < n_samples;
       s += stride) {
    const int b = s / ta;
    const int t = s - b * ta;
    const int m = t / hop;
    const int two_o1 = 2 * (t - m * hop) + 1;
    const bool lo = two_o1 < hop;
    const int f_left = lo ? max(m - 1, 0) : m;
    const int f_right = lo ? m : min(m + 1, tc - 1);
    float w = __fdiv_rn(static_cast<float>(lo ? two_o1 + hop : two_o1 - hop),
                        den);
    if (lo && m == 0) w = 0.0f;  // head clamp: frame 0 exactly
    const float omw = __fsub_rn(1.0f, w);

    const long long row = static_cast<long long>(b) * tc;
    const float* fl = film + (row + f_left) * (4 * kC) + c;
    const float* fr = film + (row + f_right) * (4 * kC) + c;
    const float g_in = lerp_exact(fl[0], fr[0], w, omw);
    const float b_in = lerp_exact(fl[kC], fr[kC], w, omw);
    const float g_out = lerp_exact(fl[2 * kC], fr[2 * kC], w, omw);
    const float b_out = lerp_exact(fl[3 * kC], fr[3 * kC], w, omw);

    const long long e = static_cast<long long>(s) * kC + c;
    const float h0 = (g_in * exciter[e] + b_in) * scale;

    float h1[kW], h2[kW];
#pragma unroll
    for (int v = 0; v < kW; ++v)
      h1[v] = psin(h0 * sw[(kW1 + v) * kC + c] + sw[(kB1 + v) * kC + c]);
#pragma unroll
    for (int v = 0; v < kW; ++v) {
      float acc = h1[0] * sw[(kW2 + v) * kC + c];
#pragma unroll
      for (int u = 1; u < kW; ++u) acc += h1[u] * sw[(kW2 + u * kW + v) * kC + c];
      h2[v] = psin(acc + sw[(kB2 + v) * kC + c]);
    }
#pragma unroll
    for (int v = 0; v < kW; ++v) {
      float acc = h2[0] * sw[(kW3 + v) * kC + c];
#pragma unroll
      for (int u = 1; u < kW; ++u) acc += h2[u] * sw[(kW3 + u * kW + v) * kC + c];
      h1[v] = psin(acc + sw[(kB3 + v) * kC + c]);  // h1 now holds layer 3
    }
    float acc = h1[0] * sw[kW4 * kC + c];
#pragma unroll
    for (int u = 1; u < kW; ++u) acc += h1[u] * sw[(kW4 + u) * kC + c];
    const float y = psin(acc + sw[kB4 * kC + c]);
    out[e] = g_out * y + b_out;
  }
}

}  // namespace

// exciter (B, Ta, 64), film (B, Tc, 256) at control rate, weights (170, 64)
// and out (B, Ta, 64): contiguous float32 on the current device, Ta = Tc*hop.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int newt_fused_cr_forward(const float* exciter, const float* film,
                                     const float* weights, float* out,
                                     int n_samples, int ta, int tc, int hop,
                                     void* stream) {
  if (n_samples <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, film_shaper_cr_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed =
      (static_cast<long long>(n_samples) + kSamplesPerPass - 1) / kSamplesPerPass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  film_shaper_cr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      exciter, film, weights, out, n_samples, ta, tc, hop);
  return static_cast<int>(cudaGetLastError());
}
