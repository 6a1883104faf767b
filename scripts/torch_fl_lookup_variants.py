#!/usr/bin/env python3
"""Write variants of the audio-rate forward (kernel 5,
``kernels/csrc/newt_fused_fl.cu``, ``--kernel fl_fwd``) and of the FastNEWT
lookup (kernel 4, ``kernels/csrc/fast_newt_lookup.cu``, ``--kernel lookup``)
for ``scripts/torch_ab_bwd.py``: each the checkout's source with one design
choice changed and the same C interface.

    python3 scripts/torch_fl_lookup_variants.py [--out build]
    mkdir -p build/p && git archive HEAD neural_waveshaping_synthesis_tpu_torch/kernels/csrc \\
        | tar -x -C build/p --strip-components=3
    python3 scripts/torch_ab_bwd.py --kernel fl_fwd build/p/newt_fused_fl.cu build/ab_fl_fwd/*.cu
    python3 scripts/torch_ab_bwd.py --kernel lookup build/p/fast_newt_lookup.cu build/ab_lookup/*.cu

The variants (``<name>.cu``): in ``--out``/ab_fl_fwd, kernel 5 with

- ``s2``: 2 samples a thread in place of 4;
- ``ldcs``: the exciter and the FiLM read by streaming loads (``__ldcs``:
  read once, evict first);
- ``prefetch``: the next group's exciter and FiLM loaded into registers
  before this group is shaped (one pass ahead);

(all three the same bits); in ``--out``/ab_lookup, kernel 4 with

- ``rows2``, ``rows4``: 2 or 4 rows in flight a thread in place of 1;
- ``cached``: x read through the read-only path (``__ldg``) and the output
  stored plainly, in place of the streaming ``__ldcs``/``__stcs``;
- ``slice``: on the vec4 path where C % 8 == 0, the table is 16-B aligned
  and 8 channels of it fit in shared memory, a block of 1024 threads per SM stages an
  8-channel slice of the table (channel-major) and walks a contiguous
  chunk of rows, two rows in flight a thread, gathering from shared memory
  (the same bits);
- ``l1rows``: a diagnostic, not the lookup: every gather confined to the
  table's rows 0 and 1, so that it hits L1; the pass's time when the
  gathers cost nothing beyond L1.

Run it where the sources are (the chip's copy of the repo has no ``.git``,
so the parent's sources are unpacked beforehand); ``build/`` is not
committed.
"""
import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "neural_waveshaping_synthesis_tpu_torch" / "kernels" / "csrc"

# kernel 5
KS = "constexpr int kS = 4;"
FL_CALL = "    newt::film_shaper_fl_n<kS>(x, film, s0, n_samples, sw, c, y);\n"
FL_KERNEL = "__global__ void __launch_bounds__(kThreads, 3)"
FL_LOAD = "      x[i] = s0 + i < n_samples ? exciter[static_cast<long long>(s0 + i) * kC + c] : 0.0f;\n"
FL_LOOP = FL_LOAD.join(("""  for (int g = blockIdx.x * kGroupsPerPass + threadIdx.x / kC; g < n_groups; g += stride) {
    const int s0 = g * kS;
    float x[kS], y[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i)
""", FL_CALL.join(("", """#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (s0 + i < n_samples) out[static_cast<long long>(s0 + i) * kC + c] = y[i];
  }
"""))))
FL_CS = r'''
// newt::film_shaper_fl_n with __ldcs loads of the FiLM (the exciter too, by the caller)
template <int S>
__device__ __forceinline__ void film_shaper_fl_n_cs(const float (&exc)[S], const float* film, int s0,
                                                    int n_samples, const float* sw, int c,
                                                    float (&y)[S]) {
  float x[S], g_out[S], b_out[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x[i] = g_out[i] = b_out[i] = 0.0f;
    if (s0 + i < n_samples) {
      const float* f = film + static_cast<long long>(s0 + i) * (4 * kC) + c;
      x[i] = __ldcs(f) * exc[i] + __ldcs(f + kC);
      g_out[i] = __ldcs(f + 2 * kC);
      b_out[i] = __ldcs(f + 3 * kC);
    }
  }
  newt::shaper_n<S>(x, sw, c, y);
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = g_out[i] * y[i] + b_out[i];
}

'''
FL_PREFETCH_LOOP = r'''  int g = blockIdx.x * kGroupsPerPass + threadIdx.x / kC;
  float e[kS], f[4][kS];  // the exciter and FiLM of group g (zeros past the end)
  auto load = [&](int grp) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int s = grp * kS + i;
      const bool in = grp < n_groups && s < n_samples;
      const float* p = film + static_cast<long long>(s) * (4 * kC) + c;
      e[i] = in ? exciter[static_cast<long long>(s) * kC + c] : 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) f[a][i] = in ? p[a * kC] : 0.0f;
    }
  };
  load(g);
  for (; g < n_groups; g += stride) {
    const int s0 = g * kS;
    float x[kS], g_out[kS], b_out[kS], y[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      x[i] = f[0][i] * e[i] + f[1][i];
      g_out[i] = f[2][i];
      b_out[i] = f[3][i];
    }
    load(g + stride);  // the next group's, in flight while this one is shaped
    newt::shaper_n<kS>(x, sw, c, y);
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (s0 + i < n_samples) out[static_cast<long long>(s0 + i) * kC + c] = g_out[i] * y[i] + b_out[i];
  }
'''

# kernel 4
GATHER = "    const float lo = __ldg(col + lower * c);\n    const float hi = __ldg(col + upper * c);\n"
LAUNCH_T = "template <typename V>\ncudaError_t launch("
DISPATCH = "  return static_cast<int>(vec4 ? launch<float4>("
LOOP4 = """  for (unsigned r = blockIdx.x * rows_per_pass + (threadIdx.x >> row_shift);
       r < static_cast<unsigned>(n_rows); r += stride) {
    const long long row = static_cast<long long>(r) * f.c;
    for (int u = first_unit; u < units; u += 1 << row_shift) {
      const int ch = kWidth * u;
      const V v = __ldcs(reinterpret_cast<const V*>(x + row + ch));
      __stcs(reinterpret_cast<V*>(out + row + ch), f(v, f.table + ch));
    }
  }
"""
ROWS_LOOP = """  const unsigned n = static_cast<unsigned>(n_rows);
  for (unsigned r0 = blockIdx.x * rows_per_pass * kRows + (threadIdx.x >> row_shift); r0 < n;
       r0 += stride * kRows) {
    for (int u = first_unit; u < units; u += 1 << row_shift) {
      const int ch = kWidth * u;
      V v[kRows];  // the unit's x in kRows rows a pass apart, loaded before any lookup
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k * rows_per_pass < n)
          v[k] = __ldcs(reinterpret_cast<const V*>(
              x + static_cast<long long>(r0 + k * rows_per_pass) * f.c + ch));
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k * rows_per_pass < n)
          __stcs(reinterpret_cast<V*>(out + static_cast<long long>(r0 + k * rows_per_pass) * f.c + ch),
                 f(v[k], f.table + ch));
    }
  }
"""
HOST_ROWS = "  const long long rows_per_pass = kThreads >> row_shift;"
PLAIN_STORE = r'''
template <typename V>
__device__ __forceinline__ void plain_store(V* p, V v) { *p = v; }

'''
SLICE = r'''
constexpr int kSliceC = 8;          // channels of the table slice a block stages
constexpr int kSliceThreads = 1024; // two threads a row (4 channels each)
constexpr int kSliceRows = 2;       // rows in flight a thread

__device__ __forceinline__ float slice_lerp(const Lookup& f, float x, const float* col) {
  const float idx = __fdiv_rn(__fmul_rn(f.s_f, __fsub_rn(x, f.table_min)), f.span);
  const float lower_f = fminf(fmaxf(floorf(idx), 0.0f), f.last);
  const int lower = static_cast<int>(lower_f);
  const int upper = min(lower + 1, f.s - 1);
  const float lo = col[lower], hi = col[upper];
  const float fract = __fsub_rn(idx, lower_f);
  return __fadd_rn(__fmul_rn(__fsub_rn(hi, lo), fract), lo);
}

__global__ void __launch_bounds__(kSliceThreads, 1)
fast_newt_lookup_slice_kernel(const float* __restrict__ x, float* __restrict__ out, Lookup f,
                              int n_rows, int rows_per_chunk) {
  extern __shared__ __align__(16) float slice[];  // (kSliceC, S), channel-major
  const int groups = f.c / kSliceC;
  const int c0 = (blockIdx.x % groups) * kSliceC;
  const int r_begin = (blockIdx.x / groups) * rows_per_chunk;
  const int r_end = r_begin + min(rows_per_chunk, n_rows - r_begin);
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * f.s; i += kSliceThreads) {
    const int k = i >> 1, h = 4 * (i & 1);
    const float4 v = __ldg(reinterpret_cast<const float4*>(f.table + k * f.c + c0 + h));
    slice[(h + 0) * f.s + k] = v.x;
    slice[(h + 1) * f.s + k] = v.y;
    slice[(h + 2) * f.s + k] = v.z;
    slice[(h + 3) * f.s + k] = v.w;
  }
  __syncthreads();
  const int h = 4 * (threadIdx.x & 1);
  const float* col = slice + h * f.s;
  constexpr int kRowsPerPass = kSliceThreads / 2;
  for (int r = r_begin + (threadIdx.x >> 1); r < r_end; r += kSliceRows * kRowsPerPass) {
    float4 v[kSliceRows];
#pragma unroll
    for (int k = 0; k < kSliceRows; ++k)
      if (r + k * kRowsPerPass < r_end)
        v[k] = __ldcs(reinterpret_cast<const float4*>(
            x + static_cast<long long>(r + k * kRowsPerPass) * f.c + c0 + h));
#pragma unroll
    for (int k = 0; k < kSliceRows; ++k) {
      if (r + k * kRowsPerPass >= r_end) break;
      float4 o;
      o.x = slice_lerp(f, v[k].x, col);
      o.y = slice_lerp(f, v[k].y, col + f.s);
      o.z = slice_lerp(f, v[k].z, col + 2 * f.s);
      o.w = slice_lerp(f, v[k].w, col + 3 * f.s);
      __stcs(reinterpret_cast<float4*>(out + static_cast<long long>(r + k * kRowsPerPass) * f.c + c0 + h), o);
    }
  }
}

cudaError_t launch_slice(const float* x, const float* table, float* out, int n_rows, int s, int c,
                         float table_min, float span, cudaStream_t stream, bool* launched) {
  *launched = false;
  const size_t bytes = static_cast<size_t>(kSliceC) * s * sizeof(float);
  int device = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess || c % kSliceC != 0 || bytes > static_cast<size_t>(max_smem) ||
      reinterpret_cast<unsigned long long>(table) % 16 != 0)  // staged by 16-B loads
    return err;
  err = cudaFuncSetAttribute(fast_newt_lookup_slice_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int groups = c / kSliceC;
  int chunks = sms / groups > 0 ? sms / groups : 1;
  if (chunks > n_rows) chunks = n_rows;
  const int rows_per_chunk = static_cast<int>((static_cast<long long>(n_rows) + chunks - 1) / chunks);
  chunks = (n_rows + rows_per_chunk - 1) / rows_per_chunk;
  const Lookup f{table, s, c, static_cast<float>(s), static_cast<float>(s - 1), table_min, span};
  fast_newt_lookup_slice_kernel<<<groups * chunks, kSliceThreads, bytes, stream>>>(
      x, out, f, n_rows, rows_per_chunk);
  *launched = true;
  return cudaGetLastError();
}

'''
SLICE_DISPATCH = r'''  if (vec4) {
    bool launched = false;
    const cudaError_t err = launch_slice(x, table, out, n_rows, s, c, table_min, span,
                                         static_cast<cudaStream_t>(stream), &launched);
    if (err != cudaSuccess || launched) return static_cast<int>(err);
  }
'''


def _need(src: str, name: str, *snippets: str) -> None:
    missing = [s for s in snippets if s not in src]
    if missing:
        raise ValueError(f"{name} no longer has {missing[0]!r}: update the variants")


def fl_variants(src: str) -> dict:
    """{name: source} of every variant of kernel 5's source ``src``."""
    _need(src, "newt_fused_fl.cu", KS, FL_CALL, FL_KERNEL, FL_LOAD, FL_LOOP)
    cs_load = FL_LOAD.replace("exciter[static_cast<long long>(s0 + i) * kC + c]",
                              "__ldcs(exciter + static_cast<long long>(s0 + i) * kC + c)")
    return {
        "s2": src.replace(KS, "constexpr int kS = 2;"),
        "ldcs": src.replace(FL_KERNEL, FL_CS + FL_KERNEL, 1).replace(FL_LOAD, cs_load).replace(
            FL_CALL, FL_CALL.replace("newt::film_shaper_fl_n", "film_shaper_fl_n_cs")),
        "prefetch": src.replace(FL_LOOP, FL_PREFETCH_LOOP),
    }


def lookup_variants(src: str) -> dict:
    """{name: source} of every variant of kernel 4's source ``src``."""
    kernel = "template <typename V>\n__global__"
    _need(src, "fast_newt_lookup.cu", GATHER, LAUNCH_T, DISPATCH, LOOP4, HOST_ROWS, kernel, "__ldcs(", "__stcs(")

    def rows(k):
        return (src.replace(kernel, f"constexpr int kRows = {k};\n\n" + kernel, 1).replace(LOOP4, ROWS_LOOP)
                .replace(HOST_ROWS, HOST_ROWS.replace("kThreads >> row_shift;", "(kThreads >> row_shift) * kRows;")))

    return {
        "rows2": rows(2),
        "rows4": rows(4),
        "cached": src.replace(kernel, PLAIN_STORE + kernel, 1).replace("__ldcs(", "__ldg(")
                     .replace("__stcs(", "plain_store("),
        "slice": src.replace(LAUNCH_T, SLICE + LAUNCH_T, 1).replace(DISPATCH, SLICE_DISPATCH + DISPATCH),
        "l1rows": src.replace(GATHER, GATHER.replace("lower * c", "(lower & 1) * c")
                              .replace("upper * c", "(upper & 1) * c")),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "build")
    args = ap.parse_args()
    for sub, source, make in (("ab_fl_fwd", "newt_fused_fl.cu", fl_variants),
                              ("ab_lookup", "fast_newt_lookup.cu", lookup_variants)):
        out = args.out / sub
        out.mkdir(parents=True, exist_ok=True)
        for name, code in make((CSRC / source).read_text()).items():
            (out / f"{name}.cu").write_text(code)
            print(out / f"{name}.cu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
