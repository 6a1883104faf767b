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
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Lookup {
  const float* table;
  int s, c;
  float s_f, last, table_min, span;

  // out for x at the table column `col` (table + channel)
  __device__ __forceinline__ float operator()(float x, const float* col) const {
    const float idx = __fdiv_rn(__fmul_rn(s_f, __fsub_rn(x, table_min)), span);
    const float lower_f = fminf(fmaxf(floorf(idx), 0.0f), last);
    const int lower = static_cast<int>(lower_f);
    const int upper = min(lower + 1, s - 1);
    const float lo = __ldg(col + lower * c);
    const float hi = __ldg(col + upper * c);
    const float fract = __fsub_rn(idx, lower_f);
    return __fadd_rn(__fmul_rn(__fsub_rn(hi, lo), fract), lo);
  }

  // 4 consecutive channels from `col` on
  __device__ __forceinline__ float4 operator()(float4 x, const float* col) const {
    return make_float4((*this)(x.x, col), (*this)(x.y, col + 1), (*this)(x.z, col + 2),
                       (*this)(x.w, col + 3));
  }
};

// V = float4: a unit is 4 consecutive channels (C % 4 == 0, x and out 16-B
// aligned); V = float: one channel. units = C / 4 or C units a row, covered
// by 2^row_shift threads a row; a block's pass covers kThreads >> row_shift
// rows.
template <typename V>
__global__ void __launch_bounds__(kThreads)
fast_newt_lookup_kernel(const float* __restrict__ x, float* __restrict__ out, Lookup f,
                        int n_rows, int units, int row_shift) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  const int first_unit = threadIdx.x & ((1 << row_shift) - 1);
  const unsigned rows_per_pass = kThreads >> row_shift;
  const unsigned stride = gridDim.x * rows_per_pass;
  for (unsigned r = blockIdx.x * rows_per_pass + (threadIdx.x >> row_shift);
       r < static_cast<unsigned>(n_rows); r += stride) {
    const long long row = static_cast<long long>(r) * f.c;
    for (int u = first_unit; u < units; u += 1 << row_shift) {
      const int ch = kWidth * u;
      const V v = __ldcs(reinterpret_cast<const V*>(x + row + ch));
      __stcs(reinterpret_cast<V*>(out + row + ch), f(v, f.table + ch));
    }
  }
}

template <typename V>
cudaError_t launch(const float* x, const float* table, float* out, int n_rows, int s, int c,
                   float table_min, float span, cudaStream_t stream) {
  const int units = c / static_cast<int>(sizeof(V) / sizeof(float));
  int row_shift = 0;
  while ((1 << row_shift) < units && (1 << row_shift) < kThreads) ++row_shift;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fast_newt_lookup_kernel<V>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long rows_per_pass = kThreads >> row_shift;
  const long long needed = (n_rows + rows_per_pass - 1) / rows_per_pass;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const Lookup f{table, s, c, static_cast<float>(s), static_cast<float>(s - 1), table_min, span};
  fast_newt_lookup_kernel<V><<<grid, kThreads, 0, stream>>>(x, out, f, n_rows, units, row_shift);
  return cudaGetLastError();
}

}  // namespace

// x and out (N, C), table (S, C): contiguous float32 on the current device,
// n_rows = N < 2^31, S >= 2, S*C < 2^31, span = max - min (computed by the
// caller in double and rounded, as the JAX code's Python float is); vec4 = 1
// takes the vec4 path (C % 4 == 0, x and out 16-B aligned), 0 the scalar
// path. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fast_newt_lookup_rows(const float* x, const float* table, float* out,
                                     int n_rows, int s, int c, int vec4, float table_min,
                                     float span, void* stream) {
  if (n_rows <= 0 || c <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec4 ? launch<float4>(x, table, out, n_rows, s, c, table_min, span, st)
                               : launch<float>(x, table, out, n_rows, s, c, table_min, span, st));
}
