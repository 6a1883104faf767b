#!/usr/bin/env python3
"""Write variants of the audio-rate backward (``kernels/csrc/newt_fused_fl_bwd.cu``,
kernel 6) for ``scripts/torch_ab_bwd.py --kernel fl``: each the checkout's
source with its kernel function (from ``constexpr int kWarps`` to the end of
the anonymous namespace) replaced by an earlier design step, the same C
interface and the same recompute.

    python3 scripts/torch_fl_bwd_variants.py [--out build/ab_fl]
    python3 scripts/torch_ab_bwd.py --kernel fl build/ab_fl/*.cu

The variants (``<name>.cu`` in ``--out``):

- ``sync``: one buffer of tiles, staged with plain loads and stores between
  two barriers (the block waits for each chunk's loads before its arithmetic);
- ``split``: two 8-warp blocks per SM instead of one of 16, each chunk taken
  in two passes of 32 channels, the tiles a pass's half (exciter and dy
  (32, 33), FiLM (32, 129)), staged as in ``sync``: 113,024 B a block.

Both give the shipped kernel's d_exciter and d_film bit for bit (``sync`` its
d_planes too; ``split`` has twice the blocks, so its partials sum in another
order). ``build/`` is not committed.
"""
import argparse
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "neural_waveshaping_synthesis_tpu_torch" / "kernels" / "csrc" / "newt_fused_fl_bwd.cu"
START, END = "constexpr int kWarps", "}  // namespace"

SYNC = r"""constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kLanes;
constexpr int kChanPerWarp = kC / kWarps;
constexpr int kFilm = 4 * kC;          // a sample's FiLM row
constexpr int kFilmLd = kFilm + 1;     // the FiLM tile's row, padded
// weights and gradient table (64, 172) each, exciter and dy tiles (32, 65)
// each, the FiLM tile (32, 257)
constexpr size_t kSmemBytes =
    static_cast<size_t>(2 * kC * kLd + 2 * kLanes * kTileLd + kLanes * kFilmLd) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 1)
film_shaper_fl_bwd_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          const float* __restrict__ dy,
                          float* __restrict__ d_exciter,
                          float* __restrict__ d_film,
                          float* __restrict__ w_part, int n_samples) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // (64, 172) weights
  float* sg = sw + kC * kLd;                     // (64, 172) weight-gradient sums
  float* se = sg + kC * kLd;                     // (32, 65) exciter in, d_exciter out
  float* sdy = se + kLanes * kTileLd;            // (32, 65) dy
  float* sf = sdy + kLanes * kTileLd;            // (32, 257) FiLM in, d_film out
  for (int i = threadIdx.x; i < kC * kLd; i += kThreads) sw[i] = sg[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    sw[(i - k * kC) * kLd + row_pos(k)] = weights[i];
  }
  __syncthreads();

  const unsigned sw_addr = smem_addr(sw);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_chunk = (n_samples + kLanes - 1) / kLanes;
  long long pend = 0;  // the first sample of the tiles not yet written back
  int pend_rows = 0;

  for (int j = blockIdx.x; j < n_chunk; j += gridDim.x) {
    const long long s0 = static_cast<long long>(j) * kLanes;
    const int rows = min(kLanes, n_samples - j * kLanes);
    for (int i = threadIdx.x; i < kLanes * kC; i += kThreads) {
      const int t = (i / kC) * kTileLd + i % kC;
      if (i < pend_rows * kC) d_exciter[pend * kC + i] = se[t];
      if (i < rows * kC) {
        se[t] = exciter[s0 * kC + i];
        sdy[t] = dy[s0 * kC + i];
      }
    }
    for (int i = threadIdx.x; i < kLanes * kFilm; i += kThreads) {
      const int t = (i / kFilm) * kFilmLd + i % kFilm;
      if (i < pend_rows * kFilm) d_film[pend * kFilm + i] = sf[t];
      if (i < rows * kFilm) sf[t] = film[s0 * kFilm + i];
    }
    __syncthreads();

    const bool active = lane < rows;
    float* row = sf + lane * kFilmLd;
    for (int q = 0; q < kChanPerWarp; ++q) {
      const int c = warp * kChanPerWarp + q;
      const float g_in = active ? row[c] : 0.0f;
      const float b_in = active ? row[kC + c] : 0.0f;
      const float g_out = active ? row[2 * kC + c] : 0.0f;
      const float xin = active ? se[lane * kTileLd + c] : 0.0f;
      const float g = active ? sdy[lane * kTileLd + c] : 0.0f;
      const float x = g_in * xin + b_in;
      float y, dx, t[16];
      shaper_backward_lanes(x, g * g_out, sw_addr + woff(c * kLd), sg + c * kLd, lane, t, &y,
                            &dx);
      if (active) {
        se[lane * kTileLd + c] = dx * g_in;
        // FiLM cotangents (d gamma_in, d beta_in, d gamma_out, d beta_out)
        row[c] = dx * xin;
        row[kC + c] = dx;
        row[2 * kC + c] = g * y;
        row[3 * kC + c] = g;
      }
#pragma unroll
      for (int k = kLastTerms; k < 16; ++k) t[k] = 0.0f;
      const float s = lane_sum16(t, lane);
      if (lane < kLastTerms) sg[c * kLd + kPW1 + lane] += s;
    }
    __syncthreads();
    pend = s0;
    pend_rows = rows;
  }

  for (int i = threadIdx.x; i < pend_rows * kC; i += kThreads)
    d_exciter[pend * kC + i] = se[(i / kC) * kTileLd + i % kC];
  for (int i = threadIdx.x; i < pend_rows * kFilm; i += kThreads)
    d_film[pend * kFilm + i] = sf[(i / kFilm) * kFilmLd + i % kFilm];
  float* out = w_part + static_cast<long long>(blockIdx.x) * kPlane;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    out[i] = sg[(i - k * kC) * kLd + row_pos(k)];
  }
}

"""

SPLIT = r"""constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
constexpr int kHalf = kC / 2;                  // channels of one pass
constexpr int kChanPerWarp = kHalf / kWarps;
constexpr int kHalfLd = kHalf + 1;             // a half tile's row, padded
constexpr int kFilm = 4 * kC;
constexpr int kFilmHalf = 4 * kHalf;           // a sample's FiLM columns of one pass
constexpr int kFilmHalfLd = kFilmHalf + 1;
constexpr size_t kSmemBytes =
    static_cast<size_t>(2 * kC * kLd + 2 * kLanes * kHalfLd + kLanes * kFilmHalfLd) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
film_shaper_fl_bwd_kernel(const float* __restrict__ exciter,
                          const float* __restrict__ film,
                          const float* __restrict__ weights,
                          const float* __restrict__ dy,
                          float* __restrict__ d_exciter,
                          float* __restrict__ d_film,
                          float* __restrict__ w_part, int n_samples) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sg = sw + kC * kLd;
  float* se = sg + kC * kLd;                     // (32, 33)
  float* sdy = se + kLanes * kHalfLd;            // (32, 33)
  float* sf = sdy + kLanes * kHalfLd;            // (32, 129)
  for (int i = threadIdx.x; i < kC * kLd; i += kThreads) sw[i] = sg[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    sw[(i - k * kC) * kLd + row_pos(k)] = weights[i];
  }
  __syncthreads();

  const unsigned sw_addr = smem_addr(sw);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_chunk = (n_samples + kLanes - 1) / kLanes;
  long long pend = 0;
  int pend_rows = 0, pend_h = 0;

  for (int j = blockIdx.x; j < n_chunk; j += gridDim.x) {
    const long long s0 = static_cast<long long>(j) * kLanes;
    const int rows = min(kLanes, n_samples - j * kLanes);
    for (int h = 0; h < 2; ++h) {
      for (int i = threadIdx.x; i < kLanes * kHalf; i += kThreads) {
        const int r = i / kHalf, cc = i % kHalf;
        const int t = r * kHalfLd + cc;
        if (r < pend_rows) d_exciter[(pend + r) * kC + pend_h * kHalf + cc] = se[t];
        if (r < rows) {
          se[t] = exciter[(s0 + r) * kC + h * kHalf + cc];
          sdy[t] = dy[(s0 + r) * kC + h * kHalf + cc];
        }
      }
      for (int i = threadIdx.x; i < kLanes * kFilmHalf; i += kThreads) {
        const int r = i / kFilmHalf, col = i % kFilmHalf;
        const int g = (col / kHalf) * kC + col % kHalf;
        const int t = r * kFilmHalfLd + col;
        if (r < pend_rows) d_film[(pend + r) * kFilm + pend_h * kHalf + g] = sf[t];
        if (r < rows) sf[t] = film[(s0 + r) * kFilm + h * kHalf + g];
      }
      __syncthreads();

      const bool active = lane < rows;
      float* row = sf + lane * kFilmHalfLd;
      for (int q = 0; q < kChanPerWarp; ++q) {
        const int cc = warp * kChanPerWarp + q;
        const int c = h * kHalf + cc;
        const float g_in = active ? row[cc] : 0.0f;
        const float b_in = active ? row[kHalf + cc] : 0.0f;
        const float g_out = active ? row[2 * kHalf + cc] : 0.0f;
        const float xin = active ? se[lane * kHalfLd + cc] : 0.0f;
        const float g = active ? sdy[lane * kHalfLd + cc] : 0.0f;
        const float x = g_in * xin + b_in;
        float y, dx, t[16];
        shaper_backward_lanes(x, g * g_out, sw_addr + woff(c * kLd), sg + c * kLd, lane, t, &y,
                              &dx);
        if (active) {
          se[lane * kHalfLd + cc] = dx * g_in;
          row[cc] = dx * xin;
          row[kHalf + cc] = dx;
          row[2 * kHalf + cc] = g * y;
          row[3 * kHalf + cc] = g;
        }
#pragma unroll
        for (int k = kLastTerms; k < 16; ++k) t[k] = 0.0f;
        const float s = lane_sum16(t, lane);
        if (lane < kLastTerms) sg[c * kLd + kPW1 + lane] += s;
      }
      __syncthreads();
      pend = s0;
      pend_rows = rows;
      pend_h = h;
    }
  }

  for (int i = threadIdx.x; i < pend_rows * kHalf; i += kThreads) {
    const int r = i / kHalf, cc = i % kHalf;
    d_exciter[(pend + r) * kC + pend_h * kHalf + cc] = se[r * kHalfLd + cc];
  }
  for (int i = threadIdx.x; i < pend_rows * kFilmHalf; i += kThreads) {
    const int r = i / kFilmHalf, col = i % kFilmHalf;
    d_film[(pend + r) * kFilm + pend_h * kHalf + (col / kHalf) * kC + col % kHalf] =
        sf[r * kFilmHalfLd + col];
  }
  float* out = w_part + static_cast<long long>(blockIdx.x) * kPlane;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int k = i / kC;
    out[i] = sg[(i - k * kC) * kLd + row_pos(k)];
  }
}

"""

VARIANTS = {"sync": SYNC, "split": SPLIT}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab_fl")
    args = ap.parse_args()
    src = SRC.read_text()
    head, tail = src[: src.index(START)], src[src.index(END):]
    args.out.mkdir(parents=True, exist_ok=True)
    for name, body in VARIANTS.items():
        (args.out / f"{name}.cu").write_text(head + body + tail)
        print(args.out / f"{name}.cu")


if __name__ == "__main__":
    main()
