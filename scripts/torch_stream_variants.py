#!/usr/bin/env python3
"""Write variants of the stream kernel (``kernels/csrc/newt_fused_stream.cu``,
kernel 3) for ``scripts/torch_ab_bwd.py --kernel stream``: each the
checkout's source with one design choice changed, the same C interface and
the same bits.

    python3 scripts/torch_stream_variants.py [--out build/ab_stream]
    git show HEAD~1:neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_stream.cu \
        > build/ab_stream/parent.cu
    python3 scripts/torch_ab_bwd.py --kernel stream build/ab_stream/*.cu

The variants (``<name>.cu`` in ``--out``):

- ``s2``, ``s8``: 2 or 8 samples a thread (8 at one block per SM);
- ``b2``, ``b4``: 4 samples a thread at two or four 256-thread blocks per SM;
- ``own``: a channel-major weight copy of its own, rows ordered so that one
  output's 8 inputs are adjacent (the sums then run with v outermost), read
  by plain float4 loads kept in the loop by an opaque zero offset;
- ``scalar``: scalar loads of the (170, 64) planes, kept in the loop by the
  opaque zero;
- ``hoisted``: the same scalar loads without the opaque zero: the compiler
  hoists the 170 weights out of the loop and, under the register cap, spills
  them.

Run it where the sources are (the chip's copy of the repo has no ``.git``,
so the parent's source is written beforehand); ``build/`` is not committed.
"""
import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "neural_waveshaping_synthesis_tpu_torch" / "kernels" / "csrc" / "newt_fused_stream.cu"

KS = "constexpr int kS = 4; "
LB = "__launch_bounds__(kThreads, 3)"
STAGE = """  __shared__ __align__(16) float sw[kC * newt::kLd];
  newt::stage_weight_rows(sw, weights, kThreads);
  __syncthreads();
"""
CALL = "    newt::shaper_n<kS>(x, sw, c, y);"
KERNEL = "__global__ void " + LB

OPAQUE = r'''
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}
'''

OWN = r'''
constexpr int kPitch = 172;

__device__ __forceinline__ int v4_pos(int r) {
  using namespace newt;
  if (r == kScale) return 168;
  if (r == kB4) return 169;
  if (r >= kW2 && r < kB2) { const int q = r - kW2; return 16 + (q % kW) * kW + q / kW; }
  if (r >= kW3 && r < kB3) { const int q = r - kW3; return 88 + (q % kW) * kW + q / kW; }
  return r - 1;
}

__device__ __forceinline__ void ld8(const float4* p, int q, float (&w)[8]) {
  const float4 a = p[q], b = p[q + 1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

template <int S>
__device__ __forceinline__ void shaper_n_own(const float (&x)[S], const float4* p, float (&y)[S]) {
  using namespace newt;
  float h1[kW][S], h2[kW][S], w[8], bb[8];
  const float4 tail = p[42];
  ld8(p, 0, w);
  ld8(p, 2, bb);
#pragma unroll
  for (int v = 0; v < kW; ++v)
#pragma unroll
    for (int i = 0; i < S; ++i) h1[v][i] = psin((x[i] * tail.x) * w[v] + bb[v]);
  ld8(p, 20, bb);
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    ld8(p, 4 + 2 * v, w);
    float acc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = h1[0][i] * w[0];
#pragma unroll
    for (int u = 1; u < kW; ++u)
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] += h1[u][i] * w[u];
#pragma unroll
    for (int i = 0; i < S; ++i) h2[v][i] = psin(acc[i] + bb[v]);
  }
  ld8(p, 38, bb);
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    ld8(p, 22 + 2 * v, w);
    float acc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = h2[0][i] * w[0];
#pragma unroll
    for (int u = 1; u < kW; ++u)
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] += h2[u][i] * w[u];
#pragma unroll
    for (int i = 0; i < S; ++i) h1[v][i] = psin(acc[i] + bb[v]);
  }
  ld8(p, 40, w);
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
'''
SCALAR = r'''
template <int S>
__device__ __forceinline__ void shaper_n_scalar(const float (&x)[S], const float* sw, int c,
                                                float (&y)[S]) {
  using namespace newt;
  float h1[kW][S], h2[kW][S];
  const float scale = sw[kScale * kC + c];
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    const float w = sw[(kW1 + v) * kC + c];
    const float b = sw[(kB1 + v) * kC + c];
#pragma unroll
    for (int i = 0; i < S; ++i) h1[v][i] = psin((x[i] * scale) * w + b);
  }
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    float acc[S];
    const float w0 = sw[(kW2 + v) * kC + c];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = h1[0][i] * w0;
#pragma unroll
    for (int u = 1; u < kW; ++u) {
      const float w = sw[(kW2 + u * kW + v) * kC + c];
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] += h1[u][i] * w;
    }
    const float b = sw[(kB2 + v) * kC + c];
#pragma unroll
    for (int i = 0; i < S; ++i) h2[v][i] = psin(acc[i] + b);
  }
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    float acc[S];
    const float w0 = sw[(kW3 + v) * kC + c];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = h2[0][i] * w0;
#pragma unroll
    for (int u = 1; u < kW; ++u) {
      const float w = sw[(kW3 + u * kW + v) * kC + c];
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] += h2[u][i] * w;
    }
    const float b = sw[(kB3 + v) * kC + c];
#pragma unroll
    for (int i = 0; i < S; ++i) h1[v][i] = psin(acc[i] + b);
  }
  float acc[S];
  const float w0 = sw[kW4 * kC + c];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = h1[0][i] * w0;
#pragma unroll
  for (int u = 1; u < kW; ++u) {
    const float w = sw[(kW4 + u) * kC + c];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] += h1[u][i] * w;
  }
  const float b4 = sw[kB4 * kC + c];
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = psin(acc[i] + b4);
}
'''

SCALAR_STAGE = """  __shared__ float sw[newt::kRows * kC];
  for (int i = threadIdx.x; i < newt::kRows * kC; i += kThreads) sw[i] = weights[i];
  __syncthreads();
"""
OWN_STAGE = """  __shared__ __align__(16) float sw[kC * kPitch];
  for (int i = threadIdx.x; i < newt::kRows * kC; i += kThreads)
    sw[(i % kC) * kPitch + v4_pos(i / kC)] = weights[i];
  __syncthreads();
"""


def variants(src: str) -> dict:
    """{name: source} of every variant of the checkout's kernel ``src``."""
    missing = [s for s in (KS, KERNEL, STAGE, CALL) if s not in src]
    if missing:
        raise ValueError(f"{SRC.name} no longer has {missing[0]!r}: update the variants")

    def helpers(code):
        return src.replace(KERNEL, code + "\n" + KERNEL, 1)

    scalar = helpers(OPAQUE + SCALAR).replace(STAGE, SCALAR_STAGE)
    return {
        "s2": src.replace(KS, "constexpr int kS = 2; "),
        "s8": src.replace(KS, "constexpr int kS = 8; ").replace(LB, "__launch_bounds__(kThreads, 1)"),
        "b2": src.replace(LB, "__launch_bounds__(kThreads, 2)"),
        "b4": src.replace(LB, "__launch_bounds__(kThreads, 4)"),
        "own": helpers(OPAQUE + OWN).replace(STAGE, OWN_STAGE).replace(
            CALL, "    shaper_n_own<kS>(x, reinterpret_cast<const float4*>(sw + opaque_zero() + c * kPitch), y);"),
        "scalar": scalar.replace(CALL, "    shaper_n_scalar<kS>(x, sw + opaque_zero(), c, y);"),
        "hoisted": scalar.replace(CALL, "    shaper_n_scalar<kS>(x, sw, c, y);"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab_stream")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    for name, code in variants(SRC.read_text()).items():
        (args.out / f"{name}.cu").write_text(code)
        print(args.out / f"{name}.cu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
