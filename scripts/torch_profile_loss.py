#!/usr/bin/env python3
"""Time the multi-resolution STFT loss, forward and backward, with the
PyTorch/CUDA port (the counterpart of ``scripts/profile_loss.py``).

    python3 scripts/torch_profile_loss.py [--batch-size 8] [--n-samples 64000]
        [--n-short 20 --n-long 120 --repeats 3] [--device cpu]

Rows, each timed by ``utils.profiling.differential_loop_ms`` (an eager
loop at ``--n-long`` and ``--n-short`` iterations between CUDA events, best
of ``--repeats``, the difference over the difference in lengths):

  loss_fwd                    ``multi_resolution_stft_loss(x, y)``
  loss_fwd_bwd                and its gradient into x
  res{n_fft}/{hop}_fwd_bwd    each resolution's ``stft_loss`` and its gradient

Then the float32 loss value beside a float64 oracle, the same loss of the
same inputs computed in float64 on the CPU, with the relative error.

The inputs are JAX's draws: x and y = 0.1 * N(0, 1) from ``default_rng(0)``,
(B, T) float32. Not ported: JAX's ``einsum`` / ``conv`` formulations of the
polyphase spectrogram and the MXU precision tiers (``HIGHEST`` / ``HIGH`` /
``DEFAULT``), which are TPU formulations with no counterpart in the port's
loss: it has one formulation, the cuFFT STFT (ROADMAP section 1, "Not to
port": the polyphase loss), in float32. Runs on the card unless ``--device
cpu`` is given; the loss launches no kernel of the port's own.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training.loss import (  # noqa: E402
    FFT_SIZES,
    HOP_SIZES,
    WIN_LENGTHS,
    multi_resolution_stft_loss,
    stft_loss,
)
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    differential_loop_ms,
)


def loss_inputs(batch_size: int, n_samples: int):
    """JAX's draws: (x, y), each (B, T) float32 = 0.1 * N(0, 1)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((batch_size, n_samples)) * 0.1).astype(np.float32)
    y = (rng.standard_normal((batch_size, n_samples)) * 0.1).astype(np.float32)
    return x, y


def main_impl(batch_size=8, n_samples=64000, n_short=20, n_long=120, repeats=3, device="cuda"):
    """Print every row and the value against the oracle -> {row: ms, "value":
    float32 value, "oracle": float64 value}."""
    dev = resolve_device(device)
    x_np, y_np = loss_inputs(batch_size, n_samples)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[profile_loss] device={name} B={batch_size} T={n_samples} loop {n_short}/{n_long} "
          f"best-of-{repeats}", flush=True)

    def fwd_bwd(f):
        xx = x.detach().requires_grad_(True)
        return torch.autograd.grad(f(xx), xx)[0]

    results = {}

    def timed(row, body):
        results[row] = differential_loop_ms(body, n_short, n_long, repeats, device=dev)
        print(f"  {row:<40} {results[row]:8.3f} ms", flush=True)

    def loss_fwd(c):
        with torch.no_grad():
            return multi_resolution_stft_loss(x, y)

    timed("loss_fwd", loss_fwd)
    timed("loss_fwd_bwd", lambda c: fwd_bwd(lambda xx: multi_resolution_stft_loss(xx, y)))
    for n_fft, hop, win in zip(FFT_SIZES, HOP_SIZES, WIN_LENGTHS):
        timed(f"res{n_fft}/{hop}_fwd_bwd",
              lambda c, n_fft=n_fft, hop=hop, win=win: fwd_bwd(
                  lambda xx: stft_loss(xx, y, n_fft, hop, win)))

    # the float32 value on the device against a float64 oracle on the CPU
    oracle = float(multi_resolution_stft_loss(torch.from_numpy(x_np).double(),
                                              torch.from_numpy(y_np).double()))
    with torch.no_grad():
        value = float(multi_resolution_stft_loss(x, y))
    print(f"  oracle loss value (float64, CPU) {oracle:.9f}")
    print(f"  value[float32, {dev.type}] {value:.9f}  rel_err {abs(value - oracle) / abs(oracle):.3e}")
    print("  (JAX's einsum/conv formulations and MXU precision tiers: TPU formulations, not "
          "ported; the port's loss is the cuFFT STFT)")
    results.update(value=value, oracle=oracle)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--n-samples", type=int, default=64000)
    ap.add_argument("--n-short", type=int, default=20)
    ap.add_argument("--n-long", type=int, default=120)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    main_impl(args.batch_size, args.n_samples, args.n_short, args.n_long, args.repeats,
              args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
