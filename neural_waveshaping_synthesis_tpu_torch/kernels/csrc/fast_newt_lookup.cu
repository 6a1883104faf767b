// FastNEWT table lookup, forward, float32.
//
// Replaces the TPU kernel kernels/fast_newt.py:68 fast_newt_lookup_pallas
// (Pallas: _lookup_kernel) of the JAX package, the per-channel linear
// interpolation into a baked (S, C) table of the 64 learned shapers that
// FastNEWT uses in place of the shaper MLP (reference shaping.py:82-151).
//
// What it computes, for element (n, c) of x viewed as (N, C), N = B*Ta:
//   idx   = S * (x - min) / (max - min)          (S, not S - 1: a quirk kept)
//   lower = clamp(floor(idx), 0, S - 1)
//   upper = min(lower + 1, S - 1)
//   out   = (table[upper, c] - table[lower, c]) * (idx - lower) + table[lower, c]
// Below min the fraction is negative and the first two entries extrapolate
// linearly; above max both indices are S - 1 and the result is table[S-1].
//
// What bounds it on an H100: bytes. Per element it reads 4 B of x, writes
// 4 B and does ~10 f32 operations; the table (S*C*4 B = 1 MiB at S = 4096,
// C = 64) is read once from device memory and then gathered from the 50 MB
// L2. At 3.35 TB/s and 67 TFLOP/s that is ~1.25 FLOP per byte against a
// ridge of ~20.
//
// What the design does about it: one thread per element, channels fastest,
// so a warp's x loads and out stores are 128-byte coalesced. The two table
// reads go through the read-only data path (__ldg), which keeps recently
// touched table rows in L1; neighbouring samples of an exciter are close in
// value, so a block's gathers mostly hit the same rows. The table does not
// fit in one block's 227 KB of shared memory. Not yet done (later work):
// staging a slice of channels of the table in shared memory per block
// (8 channels x 4096 x 4 B = 128 KB), vector loads of 4 channels.
//
// Exactness: the index and the lerp are written with __fsub_rn, __fmul_rn,
// __fdiv_rn and __fadd_rn, so nvcc cannot contract them into FMAs (and the
// build has no --use_fast_math), in the order of the plain PyTorch version
// kernels/fast_newt.py fast_newt_lookup_plain: the two agree bit for bit.
// The floor is clamped as a float before the conversion, so an x far
// outside the table cannot overflow the integer index.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fast_newt_lookup_kernel(const float* __restrict__ x,
                        const float* __restrict__ table,
                        float* __restrict__ out, long long n, int s, int c,
                        float table_min, float span) {
  const float s_f = static_cast<float>(s);
  const float last = static_cast<float>(s - 1);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int ch = static_cast<int>(i % c);
    const float idx =
        __fdiv_rn(__fmul_rn(s_f, __fsub_rn(x[i], table_min)), span);
    const float lower_f = fminf(fmaxf(floorf(idx), 0.0f), last);
    const int lower = static_cast<int>(lower_f);
    const int upper = min(lower + 1, s - 1);
    const float lo = __ldg(table + static_cast<long long>(lower) * c + ch);
    const float hi = __ldg(table + static_cast<long long>(upper) * c + ch);
    const float fract = __fsub_rn(idx, lower_f);
    out[i] = __fadd_rn(__fmul_rn(__fsub_rn(hi, lo), fract), lo);
  }
}

}  // namespace

// x and out (N, C), table (S, C): contiguous float32 on the current device,
// n = N*C elements, S >= 2, span = max - min (computed by the caller in
// double and rounded, as the JAX code's Python float is). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fast_newt_lookup_forward(const float* x, const float* table,
                                        float* out, long long n, int s, int c,
                                        float table_min, float span,
                                        void* stream) {
  if (n <= 0) return 0;
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long max_grid = 1LL << 20;  // the loop strides over the rest
  const int grid = static_cast<int>(needed < max_grid ? needed : max_grid);
  fast_newt_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, table, out, n, s, c, table_min, span);
  return static_cast<int>(cudaGetLastError());
}
