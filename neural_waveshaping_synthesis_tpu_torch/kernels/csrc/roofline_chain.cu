// The roofline's dependent chains, float32: K serial FMAs or K polynomial
// sines per element, the card's own compute ceilings for the shaper kernels.
//
// Replaces the TPU kernel scripts/roofline_shaper.py:171 pallas_chain (its
// pallas_call at :182) of the JAX package: a trivial kernel that runs one
// chain over a (rows, lanes) tile, so that scripts/roofline_shaper.py reads
// the chip's FMA and sine rates inside a hand-written kernel rather than
// through XLA. Its counterpart here feeds scripts/torch_roofline_shaper.py's
// cuda_* rows.
//
// What it computes, for element i of x and x0 (any shape, flat), one step
// being Fma (x <- fmaf(x, a, x0)) or Psin (x <- psin(x) + x0, psin being
// newt_shaper.cuh's polynomial sine, the instruction sequence kernels 1-8 run
// 25 times per (sample, channel): so the rate it reads is theirs):
//   ilp 1: K steps of one chain started at x; out = x
//   ilp 4: K steps of each of four independent chains started at x, x/2, x/4
//          and x/8 (the fma128_ilp4 row of the JAX script),
//          out = ((c0 + c1) + c2) + c3
//
// What bounds it on an H100: operations. Per element it reads 8 B and writes
// 4 B; at the script's K (256 FMAs, 32 sines) it does 512 (fma), 2,054
// (fma, ilp4), 608 (sin, 18 + 1 a step) or 2,438 (sin, ilp4) operations, an
// FMA counted as two: 43-203 operations a byte against the card's ridge of 20.
//
// What the design does about it: one element a thread, a grid of the blocks
// that fit on the card at once striding over the elements, so each of the
// 64 warps an SM holds carries one serial chain (ilp 4: four) and the
// schedulers hide the step's latency across warps. The chain runs in blocks
// of 64 FMAs (8 sines) unrolled, so the loop's own count, compare and branch
// take 3 issue slots in 64 (in ~150). One template, chain_kernel<Step, kIlp>,
// serves the four instances. A simple kernel, not carried over from the
// TPU's (1024, lanes) tiles: lanes 128 or 64 are one flat layout here, kept
// by the wrapper so that each JAX row has a counterpart.
#include <cuda_runtime.h>

#include "newt_shaper.cuh"

namespace {

constexpr int kThreads = 256;

struct Fma {
  static constexpr int kUnroll = 64;  // steps unrolled per loop pass
  float a;
  __device__ __forceinline__ float operator()(float x, float x0) const { return fmaf(x, a, x0); }
};

struct Psin {
  static constexpr int kUnroll = 8;
  __device__ __forceinline__ float operator()(float x, float x0) const {
    return newt::psin(x) + x0;
  }
};

template <typename Step, int kIlp>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x, const float* __restrict__ x0, float* __restrict__ out,
             long long n, int k, Step step) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = x[i], v0 = x0[i];
    float c[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) c[j] = j == 0 ? v : v * (1.0f / static_cast<float>(1 << j));
    int s = 0;
    for (; s + Step::kUnroll <= k; s += Step::kUnroll) {
#pragma unroll
      for (int u = 0; u < Step::kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kIlp; ++j) c[j] = step(c[j], v0);
      }
    }
    for (; s < k; ++s) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) c[j] = step(c[j], v0);
    }
    float sum = c[0];
#pragma unroll
    for (int j = 1; j < kIlp; ++j) sum += c[j];
    out[i] = sum;
  }
}

// launches chain_kernel<Step, kIlp> with the blocks for n elements: what
// fits on the card at once, fewer if n is small
template <typename Step, int kIlp>
cudaError_t launch(const float* x, const float* x0, float* out, long long n, int k, Step step,
                   cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<Step, kIlp>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  chain_kernel<Step, kIlp><<<grid, kThreads, 0, stream>>>(x, x0, out, n, k, step);
  return cudaGetLastError();
}

template <typename Step>
int run(const float* x, const float* x0, float* out, long long n, int k, int ilp, Step step,
        void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || (ilp != 1 && ilp != 4)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(ilp == 1 ? launch<Step, 1>(x, x0, out, n, k, step, st)
                                   : launch<Step, 4>(x, x0, out, n, k, step, st));
}

}  // namespace

// x, x0, out: n contiguous float32 on the current device; k >= 0 steps;
// ilp 1 (one chain) or 4 (four chains, summed). Launches on `stream` and
// returns the CUDA error (0 = launched).
extern "C" int roofline_fma_chain(const float* x, const float* x0, float* out, long long n,
                                  int k, int ilp, float a, void* stream) {
  return run(x, x0, out, n, k, ilp, Fma{a}, stream);
}

extern "C" int roofline_psin_chain(const float* x, const float* x0, float* out, long long n,
                                   int k, int ilp, void* stream) {
  return run(x, x0, out, n, k, ilp, Psin{}, stream);
}
