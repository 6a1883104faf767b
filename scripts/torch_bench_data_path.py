#!/usr/bin/env python3
"""In-memory (eager) against lazy (read from disk a batch at a time)
training throughput with the PyTorch/CUDA port (the counterpart of
``scripts/bench_data_path.py``).

    python3 scripts/torch_bench_data_path.py --dataset-path <shards>
        [--gin-file gin/train/train_newt.gin] [--batch-size 8] [--steps 384]
        [--log-every 64] [--warmup-windows 2] [--device cpu]

Method, as JAX's: ``Trainer.fit`` twice on one dataset directory, with
``GeneralDataModule(load_to_memory=True)`` (the training split read into
host memory once, batches gathered from it) and with ``load_to_memory=False``
(each batch's clips read from their ``.npy`` files), each from the same
seeded init (seed 0) with one validation, at the end. A :class:`RateCapture`
logger timestamps every ``train/steps_per_sec`` log window, and the
steady rate is the span rate after ``--warmup-windows`` leading windows
(the first carries the kernels' build and cuDNN's plans): steps elapsed
over wall time elapsed, not a median of window rates. It prints each run's
rate and window rates, then one JSON line with ``eager_steps_per_s``,
``lazy_steps_per_s`` and ``eager_over_lazy``.

JAX's third arm, ``lazy_i16`` (``TrainConfig.lazy_int16_wire``: lazy batches
sent to the device as int16), has no counterpart: the field is not ported
(ROADMAP section 3), so the script says so in place of a row. Runs on the
card unless ``--device cpu`` is given; on the card the training kernels'
launch counters must move or it exits non-zero.
"""
import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import require_launches  # noqa: E402
from torch_time_train_step import BACKWARD_KERNELS  # noqa: E402  (same folder)


class RateCapture:
    """A logger that timestamps every train-window log event.

    The steady rate is (last step - first step) / elapsed over the windows
    after the warm-up, not a median of per-window rates: a window's rate
    depends on when its log event fires, while the span rate is exact."""

    def __init__(self):
        self.windows = []

    def log_metrics(self, metrics, step):
        if "train/steps_per_sec" in metrics:
            self.windows.append((step, time.time(), float(metrics["train/steps_per_sec"])))

    def log_audio(self, name, audio, sample_rate, step):
        pass

    def span_rate(self, warmup_windows):
        w = self.windows[warmup_windows:]
        if len(w) < 2:
            w = self.windows
        if len(w) < 2:
            return float("nan")
        (s0, t0, _), (s1, t1, _) = w[0], w[-1]
        return (s1 - s0) / max(t1 - t0, 1e-9)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/train/train_newt.gin)")
    ap.add_argument("--dataset-path", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=384, help="steps per arm")
    ap.add_argument("--log-every", type=int, default=64, help="steps per log window")
    ap.add_argument("--warmup-windows", type=int, default=2,
                    help="leading windows discarded (the build, cuDNN's plans)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/train/train_newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    for path in args.gin_file:
        gin.parse_config_file(str(REPO / path) if not Path(path).is_absolute() else path)
    gin.validate_config()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[bench_data_path] device={name} batch={args.batch_size} steps={args.steps} "
          f"window={args.log_every}", flush=True)

    before = launch_counts()
    results = {}
    for mode, load in (("eager", True), ("lazy", False)):
        ckpt_dir = tempfile.mkdtemp(prefix=f"bench_data_{mode}_")
        try:
            cfg = TrainConfig(max_steps=args.steps, log_every_n_steps=args.log_every,
                              val_every_n_steps=10**9, checkpoint_dir=ckpt_dir)
            dm = GeneralDataModule(args.dataset_path, batch_size=args.batch_size,
                                   load_to_memory=load)
            capture = RateCapture()
            model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
            Trainer(model, cfg, device=device, loggers=[capture]).fit(dm)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        rate = capture.span_rate(args.warmup_windows)
        results[mode] = rate
        print(f"  {mode:<5} steady-state {rate:8.2f} steps/s "
              f"({rate * args.batch_size * 4:.0f} audio-s/s; window rates "
              f"{[round(r, 2) for _, _, r in capture.windows]})", flush=True)
    print("  lazy_i16: not measured: TrainConfig.lazy_int16_wire is not ported "
          "(ROADMAP section 3)")
    require_launches(before, BACKWARD_KERNELS, device)
    print(json.dumps({
        "eager_steps_per_s": round(results["eager"], 3),
        "lazy_steps_per_s": round(results["lazy"], 3),
        "eager_over_lazy": round(results["eager"] / max(results["lazy"], 1e-9), 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
