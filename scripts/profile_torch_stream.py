#!/usr/bin/env python3
"""Where the time of one streaming step goes on the card (PyTorch port).

    python3 scripts/profile_torch_stream.py [--batch 256] [--frames 8] [--steps 20]

Streams ``--batch`` streams of the run120k_cr checkpoint in buffers of
``--frames`` control frames (8: 1024 samples) through the port's
``StreamingSynth.step``, warms up, then traces ``--steps`` chained steps
with ``torch.profiler`` and prints JSON lines: the steps' wall time, the
device's busy and idle share of it (busy = union of kernel and copy
intervals), the device events per step, then the device kernels by total
time. Without a card it exits non-zero.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.streaming import StreamingSynth  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import busy_ms  # noqa: E402

CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synth = Synthesizer.from_checkpoint(CKPT, device="cuda")
    ss = StreamingSynth(synth.model, args.frames)
    spec = ss.ir_partition_spectra()
    rng = np.random.default_rng(0)
    f0 = np.geomspace(rng.uniform(110, 220, args.batch), rng.uniform(440, 880, args.batch),
                      args.frames, axis=-1).astype(np.float32)
    f0_b, ctrl_b, _ = synth.prepare([(f, np.full_like(f, 0.2)) for f in f0])
    f0_d = torch.from_numpy(f0_b[:, : args.frames]).to("cuda")
    ctrl_d = torch.from_numpy(ctrl_b[:, : args.frames]).to("cuda")
    state = ss.init_state(args.batch, torch.Generator(device="cuda").manual_seed(0))
    for _ in range(5):
        _, state = ss.step(state, f0_d, ctrl_d, spec)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, state = ss.step(state, f0_d, ctrl_d, spec)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch,
        "frames": args.frames, "buffer_samples": args.frames * ss.hop, "steps": args.steps,
        "wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": busy / args.steps,
        "device_idle_share": 1.0 - busy / wall_ms,
        "device_events_per_step": len(device_events) / args.steps,
    }))
    for name, (ms, count) in top:
        print(json.dumps({"kernel": name[:120], "ms_per_step": ms / args.steps,
                          "calls_per_step": count / args.steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
