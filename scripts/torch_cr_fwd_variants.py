#!/usr/bin/env python3
"""Write variants of the control-rate forwards for ``scripts/torch_ab_bwd.py``:
kernel 1 (``kernels/csrc/newt_fused_cr.cu``, ``--kernel cr_fwd``) and kernel
7 (``kernels/csrc/newt_fused_x.cu``, xcr and xfull, ``--kernel x_fwd``), each
the checkout's source with one design choice changed, the same C interface
and the same bits.

    python3 scripts/torch_cr_fwd_variants.py [--out build]
    mkdir -p build/p && git archive HEAD neural_waveshaping_synthesis_tpu_torch/kernels/csrc \\
        | tar -x -C build/p --strip-components=3
    python3 scripts/torch_ab_bwd.py --kernel cr_fwd build/p/newt_fused_cr.cu build/ab_cr_fwd/*.cu
    python3 scripts/torch_ab_bwd.py --kernel x_fwd build/p/newt_fused_x.cu build/ab_x_fwd/*.cu

The variants (``<name>.cu``): in ``--out``/ab_cr_fwd, kernel 1 with

- ``s2``: 2 samples a thread in place of 4;

in ``--out``/ab_x_fwd, kernel 7 with

- ``t256``, ``t512``: 256- or 512-thread blocks (4 or 8 groups sharing one
  staged copy of the weights and the mixer) in place of 384, two blocks per
  SM;
- ``s8``: 8 samples a thread (a group) in place of 4;
- ``double``: two bank tiles (and xfull's sums) a group, used by turns
  from pass to pass, in place of one: xcr then needs no barrier after the
  mix (one a pass, xfull two);
- ``mixcm``: the mixer staged channel-major (a channel's 128 weights, zero
  past H, padded to 132 floats), read 4 harmonics per 16-byte load.

Run it where the sources are (the chip's copy of the repo has no ``.git``,
so the parent's sources are unpacked beforehand); ``build/`` is not
committed.
"""
import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "neural_waveshaping_synthesis_tpu_torch" / "kernels" / "csrc"

KS = "constexpr int kS = 4;"
THREADS = "constexpr int kThreads = 384;"
SMEM = "kGroups * kTile +\n                        kGroups * 2 * kS)"
SUMS_AT = "stiles + kGroups * kTile;"
TILE_AT = "  float* tile = stiles + grp * kTile;\n  float* sums = ssums + grp * 2 * kS;\n"
LOOP = "g += stride) {\n    const int s0 = g * kS;\n"
MIX_SYNC = "    if (!kOutMix) group_sync(grp);  // the tile is read: the next pass may write it\n"
MIX = "    newt::mix<kS>(tile, smw, c, n_harm, bias, exc);\n"
STAGE_MIX = "  for (int i = threadIdx.x; i < n_harm * kC; i += kThreads) smw[i] = mixer_w[i];\n"
MIX_SIZE = "kMaxHarmonics * kC"
KERNEL = "template <bool kOutMix>\n__global__"

TILE = "constexpr int kTile = kMaxHarmonics * kS;\n"
MIX_LD = "constexpr int kMixLd = kMaxHarmonics + 4;  // a channel's mixer column, padded\n"
MIX_CM = r'''
template <int S>
__device__ __forceinline__ void mix_cm(const float* tile, const float* wc, int n_harm, float bias,
                                       float (&out)[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) out[i] = 0.0f;
  for (int k = 0; k < n_harm; k += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(wc + k);
    const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float r[S];
      newt::lds_n<S>(tile + (k + q) * S, r);
#pragma unroll
      for (int i = 0; i < S; ++i) out[i] += r[i] * wk[q];
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) out[i] += bias;
}

'''
STAGE_MIX_CM = """  for (int i = threadIdx.x; i < kMixLd * kC; i += kThreads) {
    const int k = i / kC;
    smw[(i - k * kC) * kMixLd + k] = k < n_harm ? mixer_w[i] : 0.0f;
  }
"""


def _need(src: str, name: str, *snippets: str) -> None:
    missing = [s for s in snippets if s not in src]
    if missing:
        raise ValueError(f"{name} no longer has {missing[0]!r}: update the variants")


def cr_variants(src: str) -> dict:
    """{name: source} of every variant of kernel 1's source ``src``."""
    _need(src, "newt_fused_cr.cu", KS)
    return {"s2": src.replace(KS, "constexpr int kS = 2;")}


def x_variants(src: str) -> dict:
    """{name: source} of every variant of kernel 7's source ``src``."""
    _need(src, "newt_fused_x.cu", KS, THREADS, SMEM, SUMS_AT, TILE_AT, LOOP, MIX_SYNC, MIX, STAGE_MIX,
          MIX_SIZE, KERNEL, TILE)
    return {
        "t256": src.replace(THREADS, "constexpr int kThreads = 256;"),
        "t512": src.replace(THREADS, "constexpr int kThreads = 512;"),
        "s8": src.replace(KS, "constexpr int kS = 8;"),
        "double": src.replace(SMEM, "2 * kGroups * kTile + 2 * kGroups * 2 * kS)")
                     .replace(SUMS_AT, "stiles + 2 * kGroups * kTile;").replace(TILE_AT, "  int buf = 0;\n")
                     .replace(LOOP, "g += stride, buf ^= 1) {\n    const int s0 = g * kS;\n"
                              "    float* tile = stiles + (buf * kGroups + grp) * kTile;\n"
                              "    float* sums = ssums + (buf * kGroups + grp) * 2 * kS;\n")
                     .replace(MIX_SYNC, ""),
        "mixcm": src.replace(KERNEL, MIX_CM + KERNEL, 1).replace(STAGE_MIX, STAGE_MIX_CM)
                    .replace(TILE, TILE + MIX_LD)
                    .replace(MIX_SIZE, "kC * kMixLd")
                    .replace(MIX, "    mix_cm<kS>(tile, smw + c * kMixLd, n_harm, bias, exc);\n"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "build")
    args = ap.parse_args()
    for sub, source, make in (("ab_cr_fwd", "newt_fused_cr.cu", cr_variants),
                              ("ab_x_fwd", "newt_fused_x.cu", x_variants)):
        out = args.out / sub
        out.mkdir(parents=True, exist_ok=True)
        for name, code in make((CSRC / source).read_text()).items():
            (out / f"{name}.cu").write_text(code)
            print(out / f"{name}.cu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
