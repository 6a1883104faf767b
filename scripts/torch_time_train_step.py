#!/usr/bin/env python3
"""The training step's time with the PyTorch/CUDA port (the counterpart of
``scripts/time_train_step.py``): forward, multi-resolution STFT loss,
backward, clip, Adam and the schedule, at a given batch.

    python3 scripts/torch_time_train_step.py [--batch-size 8] [--n-frames 500] [--steps 50]
        [--bf16] [--remat] [-b "NEWT.fused = 'full_lane'"] [--trace-dir DIR] [--device cpu]

The model is built from ``--gin-file`` (the recipe, ``gin/train/train_newt.gin``,
whose ``NEWT.fused = 'full_lane_cr'`` runs kernels 1 and 2 on the card) and
``-b`` bindings (``--bf16`` binds ``NeuralWaveshaping.compute_dtype =
'bfloat16'``, ``--remat`` ``NEWT.remat_shaper = True``) with weights from a
seeded generator (seed 0), and trained by ``Trainer.train_step``. The
batches are JAX's draws, ``default_rng(0)``: ``--steps`` batches of audio ~
0.1 N(0, 1), f0 = 220 x 2^U(0, 2) Hz and control ~ N(0, 1); step i takes
batch i, copies it to the card and draws its phase offsets and noise from
the trainer's CPU generator, as ``Trainer.fit`` does, so that host work is
in the step's time.

One untimed run of the ``--steps`` steps (the kernels' build and load,
cuDNN plans, the allocator) prints its first and last loss. Then
``--repeats`` runs of the steps, each queued without a synchronisation
between two CUDA events and read back once at its end: the losses stay on
the card until then, as JAX's single fetch of the ``(N,)`` losses. The
per-step time is the run's time over its steps; the best run is the
headline. This replaces JAX's one dispatch of an N-step ``lax.scan``: the
port has no multi-step program (its counterpart, a CUDA graph of the step,
is speed work not done), so the figure is the pace of the queued loop,
the host's launch time where the host sets it. ``--trace-dir`` writes a
``torch.profiler`` trace of the last run. The backward kernels' launch
counters must move on the card or the script exits non-zero. Runs on the
card unless ``--device cpu`` is given.
"""
import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    require_launches,
    trace,
)

# the backward kernels' counters: kernels 2, 6 and 8 (xcr and xfull)
BACKWARD_KERNELS = ("film_shaper_cr.bwd_launches", "film_shaper_fl.bwd_launches",
                    "bank_film_shaper_xcr.bwd_launches", "bank_newt_xfull.bwd_launches")


def parse_gin(gin_files: Sequence[str], bindings: Sequence[str], bf16=False, remat=False) -> None:
    """The gin files (relative to the repo), the flags' bindings, then the
    extra bindings, checked."""
    for path in gin_files:
        gin.parse_config_file(str(REPO / path) if not Path(path).is_absolute() else path)
    if bf16:
        gin.parse_config("NeuralWaveshaping.compute_dtype = 'bfloat16'")
    if remat:
        gin.parse_config("NEWT.remat_shaper = True")
    for binding in bindings:
        gin.parse_config(binding)
    gin.validate_config()


def train_batches(steps: int, batch_size: int, n_frames: int, hop: int) -> Dict[str, np.ndarray]:
    """JAX's draws: audio (N, B, Tc*hop), f0 (N, B, Tc), control (N, B, Tc,
    2), float32."""
    rng = np.random.default_rng(0)
    t_audio = n_frames * hop
    return {
        "audio": (rng.standard_normal((steps, batch_size, t_audio)) * 0.1).astype(np.float32),
        "f0": (220.0 * 2.0 ** rng.uniform(0, 2, (steps, batch_size, n_frames))).astype(np.float32),
        "control": rng.standard_normal((steps, batch_size, n_frames, 2)).astype(np.float32),
    }


def run_steps(trainer: Trainer, batches: Dict[str, np.ndarray],
              draws: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None) -> torch.Tensor:
    """One ``Trainer.train_step`` per batch, queued -> the (N,) losses, still
    on the device (reading them waits for the steps). ``draws`` injects each
    step's (phase_offset, noise) (tests)."""
    losses = []
    for i in range(len(batches["audio"])):
        batch = {k: v[i] for k, v in batches.items()}
        offset, noise = draws[i] if draws else (None, None)
        losses.append(trainer.train_step(batch, phase_offset=offset, noise=noise)["loss"])
    return torch.stack(losses)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/train/train_newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra bindings for A/Bs, e.g. \"NEWT.fused = 'full_lane'\"")
    ap.add_argument("--batch-size", type=int, default=8, help="clips per step (the recipe: 8)")
    ap.add_argument("--n-frames", type=int, default=500, help="control frames per clip (500 = 4 s)")
    ap.add_argument("--steps", "--scan-steps", dest="steps", type=int, default=50,
                    help="steps per timed run (JAX's --scan-steps)")
    ap.add_argument("--repeats", type=int, default=3, help="timed runs (after the warm-up run)")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute in the synthesis graph")
    ap.add_argument("--remat", action="store_true", help="recompute the shaper bank in backward")
    ap.add_argument("--trace-dir", default="", help="write a torch.profiler trace of the last run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/train/train_newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    parse_gin(args.gin_file, args.gin_binding, args.bf16, args.remat)
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainConfig(), device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[time_train_step] device={name} batch={args.batch_size} frames={args.n_frames} "
          f"steps={args.steps} bf16={args.bf16} NEWT.fused={model.newt.fused!r}", flush=True)
    batches = train_batches(args.steps, args.batch_size, args.n_frames, model.control_hop)
    before = launch_counts()

    t0 = time.perf_counter()
    first = run_steps(trainer, batches).cpu().numpy()
    print(f"[time_train_step] warm-up run {time.perf_counter() - t0:.1f}s, "
          f"loss[0]={first[0]:.4f} loss[-1]={first[-1]:.4f}", flush=True)
    if not np.all(np.isfinite(first)):
        raise SystemExit("non-finite losses")

    cuda = device.type == "cuda"
    per_step_ms = []
    for i in range(args.repeats):
        with trace(args.trace_dir if i == args.repeats - 1 else None):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            losses = run_steps(trainer, batches)
            if cuda:
                stop.record()
            losses.cpu()  # the one read back: it waits for every step
            ms = start.elapsed_time(stop) if cuda else (time.perf_counter() - t0) * 1e3
            per_step_ms.append(ms / args.steps)
    best = min(per_step_ms)
    audio_s = args.batch_size * args.n_frames * model.control_hop / float(model.sample_rate)
    print(f"[time_train_step] per-step ms over {args.repeats} runs of {args.steps} queued steps: "
          + ", ".join(f"{m:.2f}" for m in per_step_ms))
    print(f"[time_train_step] best {best:.2f} ms/step ({1000.0 / best:.2f} steps/s, "
          f"{audio_s / (best / 1000.0):.0f} audio-seconds/s)")
    require_launches(before, BACKWARD_KERNELS, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
