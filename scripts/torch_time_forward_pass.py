#!/usr/bin/env python3
"""Time the model's forward pass with the PyTorch/CUDA port (the
counterpart of ``scripts/time_forward_pass.py``, itself the reference's:
100 timed forwards of a 4-s input, scipy's describe stats, mean RTF and
90th-percentile RTF, where RTF = wall seconds / audio seconds; lower is
better).

    python3 scripts/torch_time_forward_pass.py [--batch-size 8] [--use-fast-newt]
        [--async-pipeline] [--profile-dir DIR] [-b "NEWT.fused = 'full_lane'"] [--device cpu]

The model is built from ``--gin-file`` and ``-b`` bindings with weights
drawn from a seeded generator (seed 0), or loaded from ``--checkpoint``; the
inputs are JAX's draws, ``default_rng(0)``: f0 = 200 + 200 U Hz and
control ~ N(0, 1). Each forward draws its phase offsets and noise from a
CPU generator seeded with its iteration. On the card the forward runs
kernel 1 (``NEWT.fused = "cr"``, the default) or, with ``--use-fast-newt``,
the FastNEWT lookup kernel 4; the launch counters must move or the script
exits non-zero. Runs on the card unless ``--device cpu`` is given.

It prints, after one untimed warm-up forward:

* the queued loop: the per-forward time of an eager loop of forwards by
  difference (``utils.profiling.differential_loop_ms``, CUDA events, one
  synchronisation per loop). It replaces JAX's "Device-only" line, a scan
  of N forwards in one dispatch: on the card it is the larger of the
  host's launch time and the card's compute time per forward, not
  device-only time;
* with ``--async-pipeline``, throughput mode: all iterations queued, one
  fetch of the last output at the end;
* otherwise the per-request host round trip: each forward's output copied
  to the host (the time a caller waits), with describe stats, mean RTF and
  p90 RTF, under ``--profile-dir``'s ``torch.profiler`` trace when given.
"""
import argparse
import itertools
import sys
import time
from pathlib import Path

import numpy as np
import scipy.stats
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    differential_loop_ms,
    require_launches,
    trace,
)

# the forward kernels' counters: kernel 1, 5, 7 and its xfull instance
FORWARD_KERNELS = ("film_shaper_cr.launches", "film_shaper_fl.launches",
                   "bank_film_shaper_xcr.launches", "bank_newt_xfull.launches")
LOOKUP_KERNEL = ("fast_newt_lookup.launches",)


def build_model(gin_files, bindings, checkpoint: str, device) -> NeuralWaveshaping:
    """The model of the gin files and bindings, seeded (0) or from a
    checkpoint, on ``device`` in eval mode, TF32 off on the card."""
    for path in gin_files:
        gin.parse_config_file(str(REPO / path) if not Path(path).is_absolute() else path)
    for binding in bindings:
        gin.parse_config(binding)
    gin.validate_config()
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    if checkpoint:
        model.load_params(load_checkpoint(checkpoint)[0])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return model.to(device).eval()


def forward_inputs(batch_size: int, frames: int):
    """JAX's draws: f0 (B, Tc) Hz and control (B, Tc, 2), float32."""
    rng = np.random.default_rng(0)
    f0 = (200.0 + 200.0 * rng.random((batch_size, frames))).astype(np.float32)
    control = rng.standard_normal((batch_size, frames, 2)).astype(np.float32)
    return f0, control


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/models/newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra binding applied after the files")
    ap.add_argument("--checkpoint", default="", help="optional reference-format .ckpt")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--length-in-seconds", type=float, default=4.0)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--use-fast-newt", action="store_true")
    ap.add_argument("--async-pipeline", action="store_true",
                    help="queue all iterations, sync once (throughput mode)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the timed loop here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/models/newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args.gin_file, args.gin_binding, args.checkpoint, device)
    hop, sr = model.control_hop, model.sample_rate
    tc = int(args.length_in_seconds * sr / hop)
    f0_np, control_np = forward_inputs(args.batch_size, tc)
    f0, control = torch.from_numpy(f0_np).to(device), torch.from_numpy(control_np).to(device)
    audio_seconds = tc * hop / sr
    with torch.inference_mode():
        table = model.newt.bake_lookup_table() if args.use_fast_newt else None

    @torch.inference_mode()
    def fwd(i: int) -> torch.Tensor:
        return model(f0, control, generator=torch.Generator().manual_seed(i), lookup_table=table)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[time_forward_pass] device={name} batch={args.batch_size} frames={tc} "
          f"fast_newt={args.use_fast_newt}", flush=True)
    before = launch_counts()
    fwd(0).cpu()  # warm-up: cuDNN plans, the kernels' build and load, the allocator

    seeds = itertools.count(1)
    n_long = max(args.iterations, 2)
    per = differential_loop_ms(lambda _: fwd(next(seeds)), max(n_long // 5, 1), n_long,
                               repeats=3, device=device) / 1e3
    print(f"Queued loop (per forward, by difference; the host's launch time where it sets "
          f"the pace, not device-only): {per * 1000:.3f} ms/forward, "
          f"RTF {per / audio_seconds:.6f} ({audio_seconds / per:.0f}x realtime)")

    if args.async_pipeline:
        t0 = time.perf_counter()
        out = None
        for i in range(args.iterations):
            out = fwd(i)
        out.cpu()  # the copy waits for the whole queue
        per = (time.perf_counter() - t0) / args.iterations
        print(f"Throughput mode: {per * 1000:.3f} ms/forward, "
              f"RTF {per / audio_seconds:.6f} ({audio_seconds / per:.0f}x realtime)")
    else:
        times = []
        with trace(args.profile_dir or None):
            for i in range(args.iterations):
                t0 = time.perf_counter()
                fwd(i).cpu().numpy()  # the host receives the audio
                times.append(time.perf_counter() - t0)
        times = np.asarray(times)
        print(scipy.stats.describe(times))
        rtf = times / audio_seconds
        print(f"Mean host-round-trip RTF: {rtf.mean():.6f} ({1.0 / rtf.mean():.0f}x realtime)")
        print(f"90th percentile RTF: {np.percentile(rtf, 90):.6f}")
    require_launches(before, LOOKUP_KERNEL if args.use_fast_newt else FORWARD_KERNELS, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
