#!/usr/bin/env python3
"""Where the time of one training step goes on the card (PyTorch port).

    python3 scripts/profile_torch_train.py [--batch 8] [--seconds 4] [--runs 5] \
        [--fused cr|full_lane] [--fuse off|xcr|xfull] [--compute-dtype float32|bfloat16]

Takes ``Trainer.train_step``s of a seeded random init on a batch of
``--batch`` harmonic tones of ``--seconds`` each, with ``NEWT.fused`` set to
``--fused`` (``cr``: the control-rate kernels, the default; ``full_lane``:
the audio-rate kernels) and, with ``--fuse xcr`` or ``xfull``,
``NeuralWaveshaping.fuse_exciter`` (and ``fuse_out_mixer``) set: the
exciter-fused kernels) and the model's ``--compute-dtype``, warms up, then
traces
``--runs`` steps with ``torch.profiler`` and prints JSON lines: the
device kernels by total time, and the device's busy and idle share of the
traced wall time (busy = union of kernel and copy intervals), as
``profile_torch_render.py`` does for a render. Without a card it exits
non-zero.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from profile_torch_render import _requests  # noqa: E402  (same folder)

from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import busy_ms  # noqa: E402


def _tone_batch(requests):
    """Harmonic tones at the requests' f0, with (f0, loudness) controls
    roughly z-scored: a training batch of the requests' shape."""
    f0 = np.stack([f for f, _ in requests])
    loud = np.stack([l for _, l in requests])
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, 128, axis=1), axis=1) / 16000
    audio = 0.1 * sum(np.sin(k * phase) / k for k in range(1, 11))
    control = np.stack([(f0 - 400.0) / 200.0, (loud - 0.2) / 0.1], axis=-1)
    return {"audio": audio.astype(np.float32), "f0": f0, "control": control.astype(np.float32)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--fused", default="cr", choices=["cr", "full_lane"])
    ap.add_argument("--fuse", default="off", choices=["off", "xcr", "xfull"])
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0),
                                        compute_dtype=args.compute_dtype),
                      TrainConfig(), device="cuda")
    trainer.model.newt.fused = args.fused
    trainer.model.fuse_exciter = args.fuse != "off"
    trainer.model.fuse_out_mixer = args.fuse == "xfull"
    batch = _tone_batch(_requests(args.batch, args.seconds))
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy = busy_ms(device_events)
    by_name = {}
    for e in device_events:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch, "fused": args.fused,
        "fuse": args.fuse, "compute_dtype": args.compute_dtype,
        "seconds": args.seconds, "runs": args.runs,
        "wall_ms_per_step": wall_ms / args.runs,
        "device_busy_ms_per_step": busy / args.runs,
        "device_idle_share": 1.0 - busy / wall_ms,
        "device_events_per_step": len(device_events) / args.runs,
    }))
    for name, (ms, count) in top:
        print(json.dumps({"kernel": name[:120], "ms_per_step": ms / args.runs,
                          "calls_per_step": count / args.runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
