// FastNEWT table lookup, forward: a float32 table, a float32 or bfloat16 x,
// a float32 output.
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
// C = 64) is read once from device memory and then gathered from L1 and the
// 50 MB L2. At 3.35 TB/s and 67 TFLOP/s that is ~1.25 FLOP per byte against
// a ridge of ~20.
//
// What the design does about it: a streaming pass. Rows and channels are
// walked as two 32-bit ints (the wrapper refuses N >= 2^31 and S*C >= 2^31),
// the 64-bit element offset formed once per row, with no division in the
// loop; a grid of the blocks that fit on the card at once strides over the
// rows. The vec4 path gives a thread 4 consecutive channels of a row: one
// 16-B streaming load of x (__ldcs: read once, so the table keeps the
// cache), four index-and-lerp computations, eight __ldg table gathers, one
// 16-B streaming store (__stcs); at C = 64, 16 threads cover a row and a
// 256-thread block 16 rows a pass. The scalar path, the other instance of
// the same kernel template, gives a thread one channel: the wrapper
// (kernels/fast_newt.py _lookup_path) takes it where C % 4 != 0 or x or the
// output is not 16-B aligned (the table is read by 4-B gathers either way).
// A row's threads are a power of two (the units of a row rounded up, at most
// a block), so the thread's channel and first row come from one mask and one
// shift.
//
// What the measurements say (scripts/torch_fl_lookup_variants.py, in turns;
// PERF.md §6): on the x a FastNEWT render hands it, the gathers mostly hit
// L1 (the pass takes only a few per cent less when they are confined to two
// table rows), and neither 2 or 4 rows in flight a thread nor cached in
// place of streaming accesses makes it faster. On x uniform over the table
// the gathers reach L2 and the pass takes about 3x as long; an 8-channel
// slice of the table in shared memory per block is then faster, but slower
// on the render's x. Not yet done: PyTorch's copy of the same bytes takes
// about four fifths of this pass's time; what holds the pass back is not
// found yet.
//
// Exactness: the index and the lerp are written with __fsub_rn, __fmul_rn,
// __fdiv_rn and __fadd_rn, so nvcc cannot contract them into FMAs (and the
// build has no --use_fast_math), in the order of the plain PyTorch version
// kernels/fast_newt.py fast_newt_lookup_plain: the two agree bit for bit on
// either path. The floor is clamped as a float before the conversion, so an
// x far outside the table cannot overflow the integer index.
//
// Mixed precision (a bfloat16 x: NEWT under the model's compute_dtype =
// "bfloat16"): the instance with TX = __nv_bfloat16 reproduces the JAX
// model's XLA lookup on a bf16 x, where the index arithmetic is bf16 and the
// interpolation float32 against the float32 table: x - min, S * (...), / span
// and idx - lower each round to bf16 (computed in float32 and rounded to
// nearest even after each operation, as XLA's and PyTorch's CPU bf16 ops do;
// lower itself is rounded to bf16 before the subtraction, as JAX casts it, so
// at S = 4096 a clamped lower of 4095 reads as 4096), and the lerp is
// float32. The bf16 index is coarse: at S = 4096 it sits up to 16 bins from
// the float32 one inside the table (its step is 16 bins above index 2048); the
// kernel shows the bf16 index's bins, bit for bit the plain version's. Per
// element it reads 2 B of x and writes 4 B; the vec4 path loads 4 bf16 (8 B, x
// 8-B aligned) and stores 4 float32 (16 B).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// v rounded to the index arithmetic's type TX: itself for float, to nearest
// even bf16 (and widened back) for __nv_bfloat16
template <typename TX>
__device__ __forceinline__ float round_as(float v) { return v; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Lookup {
  const float* table;
  int s, c;
  float s_f, last, table_min, span;

  // out for x at the table column `col` (table + channel), the index in TX
  template <typename TX>
  __device__ __forceinline__ float at(float x, const float* col) const {
    const float idx = round_as<TX>(__fdiv_rn(
        round_as<TX>(__fmul_rn(s_f, round_as<TX>(__fsub_rn(x, table_min)))), span));
    const float lower_f = fminf(fmaxf(floorf(idx), 0.0f), last);
    const int lower = static_cast<int>(lower_f);
    const int upper = min(lower + 1, s - 1);
    const float lo = __ldg(col + lower * c);
    const float hi = __ldg(col + upper * c);
    const float fract = round_as<TX>(__fsub_rn(idx, round_as<TX>(lower_f)));
    return __fadd_rn(__fmul_rn(__fsub_rn(hi, lo), fract), lo);
  }
};

// kWidth consecutive elements of x from p on, widened to float32: one 16-B
// (float) or 8-B (bf16) streaming load for 4, one 4- or 2-B load for 1
__device__ __forceinline__ void load_x(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));  // element 0 in a.x's low half
  v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xffff0000u);
}
__device__ __forceinline__ void load_x(const float* p, float (&v)[1]) { v[0] = __ldcs(p); }
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __uint_as_float(static_cast<unsigned>(
                             __ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
}

__device__ __forceinline__ void store_out(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_out(float* p, const float (&v)[1]) { __stcs(p, v[0]); }

// kWidth = 4: a unit is 4 consecutive channels (C % 4 == 0, x aligned to 4
// elements, out to 16 B); kWidth = 1: one channel. units = C / 4 or C units a
// row, covered by 2^row_shift threads a row; a block's pass covers kThreads
// >> row_shift rows. TX is x's type.
template <typename TX, int kWidth>
__global__ void __launch_bounds__(kThreads)
fast_newt_lookup_kernel(const TX* __restrict__ x, float* __restrict__ out, Lookup f,
                        int n_rows, int units, int row_shift) {
  const int first_unit = threadIdx.x & ((1 << row_shift) - 1);
  const unsigned rows_per_pass = kThreads >> row_shift;
  const unsigned stride = gridDim.x * rows_per_pass;
  for (unsigned r = blockIdx.x * rows_per_pass + (threadIdx.x >> row_shift);
       r < static_cast<unsigned>(n_rows); r += stride) {
    const long long row = static_cast<long long>(r) * f.c;
    for (int u = first_unit; u < units; u += 1 << row_shift) {
      const int ch = kWidth * u;
      float v[kWidth];
      load_x(x + row + ch, v);
#pragma unroll
      for (int i = 0; i < kWidth; ++i) v[i] = f.at<TX>(v[i], f.table + ch + i);
      store_out(out + row + ch, v);
    }
  }
}

template <typename TX, int kWidth>
cudaError_t launch(const TX* x, const float* table, float* out, int n_rows, int s, int c,
                   float table_min, float span, cudaStream_t stream) {
  const int units = c / kWidth;
  int row_shift = 0;
  while ((1 << row_shift) < units && (1 << row_shift) < kThreads) ++row_shift;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fast_newt_lookup_kernel<TX, kWidth>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long rows_per_pass = kThreads >> row_shift;
  const long long needed = (n_rows + rows_per_pass - 1) / rows_per_pass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const Lookup f{table, s, c, static_cast<float>(s), static_cast<float>(s - 1), table_min, span};
  fast_newt_lookup_kernel<TX, kWidth><<<grid, kThreads, 0, stream>>>(x, out, f, n_rows, units,
                                                                      row_shift);
  return cudaGetLastError();
}

template <typename TX>
int lookup_rows(const TX* x, const float* table, float* out, int n_rows, int s, int c, int vec4,
                float table_min, float span, void* stream) {
  if (n_rows <= 0 || c <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec4 ? launch<TX, 4>(x, table, out, n_rows, s, c, table_min, span, st)
                               : launch<TX, 1>(x, table, out, n_rows, s, c, table_min, span, st));
}

}  // namespace

// x and out (N, C), table (S, C): contiguous float32 on the current device
// (x bfloat16 in _bf16), n_rows = N < 2^31, S >= 2, S*C < 2^31, span = max -
// min (computed by the caller in double and rounded, as the JAX code's Python
// float is); vec4 = 1 takes the vec4 path (C % 4 == 0, x aligned to 4
// elements, out to 16 B), 0 the scalar path. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int fast_newt_lookup_rows(const float* x, const float* table, float* out,
                                     int n_rows, int s, int c, int vec4, float table_min,
                                     float span, void* stream) {
  return lookup_rows(x, table, out, n_rows, s, c, vec4, table_min, span, stream);
}

extern "C" int fast_newt_lookup_rows_bf16(const __nv_bfloat16* x, const float* table,
                                          float* out, int n_rows, int s, int c, int vec4,
                                          float table_min, float span, void* stream) {
  return lookup_rows(x, table, out, n_rows, s, c, vec4, table_min, span, stream);
}
