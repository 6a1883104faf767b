#!/usr/bin/env python3
"""Where a bfloat16 training step's time goes beside the float32 one (PyTorch port).

    python3 scripts/torch_profile_bf16_step.py [--batch 8] [--seconds 4] [--runs 5] \
        [--rounds 2] [--fused full_lane_cr|cr|none]

Builds two models from one seeded init, ``compute_dtype`` ``"float32"`` and
``"bfloat16"``, with ``NEWT.fused`` set to ``--fused`` (``none``: the chain),
and takes ``Trainer.train_step``s on a batch of ``--batch`` harmonic tones of
``--seconds`` each. After a warm-up it traces ``--runs`` steps of each with
``torch.profiler``, in ``--rounds`` rounds of turns (float32, bf16, bf16,
float32, ...), and prints one JSON line per trace: the wall time per step,
the device's busy time (union of kernel and copy intervals) and idle share,
the device kernels and the host's kernel launches per step. A last line
gives, per kernel name, the calls per step that the bf16 step adds or drops
against the float32 one. Without a card it exits non-zero.
"""
import argparse
import json
import sys
import time
from collections import Counter

import torch

from profile_torch_render import _requests  # noqa: E402  (same folder)
from profile_torch_train import _tone_batch  # noqa: E402

from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import busy_ms  # noqa: E402

_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def _trace(trainer, batch, runs):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in events if e.name in _LAUNCH_CALLS)
    busy = busy_ms(device)
    return {
        "wall_ms_per_step": wall_ms / runs,
        "device_busy_ms_per_step": busy / runs,
        "device_idle_share": 1.0 - busy / wall_ms,
        "device_events_per_step": len(device) / runs,
        "host_launches_per_step": launches / runs,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, Counter(e.name[:120] for e in device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--fused", default="full_lane_cr", choices=["full_lane_cr", "cr", "none"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    batch = _tone_batch(_requests(args.batch, args.seconds))
    trainers = {}
    for cd in ("float32", "bfloat16"):
        model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0), compute_dtype=cd)
        model.newt.fused = None if args.fused == "none" else args.fused
        trainers[cd] = Trainer(model, TrainConfig(), device="cuda")
        for _ in range(3):
            trainers[cd].train_step(batch)
    torch.cuda.synchronize()
    names = {}
    for r in range(args.rounds):
        order = ("float32", "bfloat16") if r % 2 == 0 else ("bfloat16", "float32")
        for cd in order:
            torch.cuda.reset_peak_memory_stats()
            line, by_name = _trace(trainers[cd], batch, args.runs)
            names[cd] = by_name
            print(json.dumps({"device": torch.cuda.get_device_name(0), "compute_dtype": cd,
                              "fused": args.fused, "batch": args.batch, "seconds": args.seconds,
                              "runs": args.runs, "round": r, **line}), flush=True)
    diff = {n: (names["bfloat16"][n] - names["float32"][n]) / args.runs
            for n in set(names["bfloat16"]) | set(names["float32"])
            if names["bfloat16"][n] != names["float32"][n]}
    print(json.dumps({"bf16_minus_f32_calls_per_step": dict(sorted(diff.items(), key=lambda kv: -abs(kv[1])))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
