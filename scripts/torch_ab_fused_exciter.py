#!/usr/bin/env python3
"""A/B the exciter-fused kernels (xcr, xfull) against the unfused path on the
card: the PyTorch port's counterpart of ``scripts/ab_fused_exciter.py``.

    python3 scripts/torch_ab_fused_exciter.py [--tc 500] [--batches 1 8] [--iters 50]

Loads the in-repo run120k_cr checkpoint into the port's ``NeuralWaveshaping``
on the card and times its forward on random f0 (220-440 Hz) and controls at
``--tc`` control frames (500: 4 s) for each batch size, three ways:

* ``off``: the oscillator bank, the 101 -> 64 mixer, then NEWT's control-rate
  kernel (``film_shaper_fused_cr``);
* ``xcr``: ``fuse_exciter`` - the bank, the mixer and FiLM -> shapers -> FiLM
  in ``newt_fused_x.cu``;
* ``xfull``: also ``fuse_out_mixer`` - NEWT's 64 -> 1 mix in the kernel too.

Each arm is timed in turns (off, xcr, xfull, xfull, xcr, off) by CUDA events
around ``--iters`` forwards after a warm-up, and reported as ms per clip and
x real time, with the card's name and power limit. Prints one JSON line per
measurement. Without a card it exits non-zero.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer  # noqa: E402

CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")
ARMS = {"off": (False, False), "xcr": (True, False), "xfull": (True, True)}
ORDER = ["off", "xcr", "xfull", "xfull", "xcr", "off"]


def time_forward(model, f0, control, iters: int) -> float:
    """Mean ms of one forward over ``iters`` forwards, after 3 warm-up ones."""
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for _ in range(3):
            model(f0, control, generator=gen)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(f0, control, generator=gen)
        stop.record()
        torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tc", type=int, default=500, help="control frames per clip (125 per second)")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = Synthesizer.from_checkpoint(CKPT, device="cuda").model
    hop, sr = model.control_hop, model.sample_rate
    audio_s = args.tc * hop / sr
    rng = np.random.default_rng(0)
    for batch in args.batches:
        f0 = torch.from_numpy((220.0 + 220.0 * rng.random((batch, args.tc))).astype(np.float32)).cuda()
        control = torch.from_numpy(rng.standard_normal((batch, args.tc, 2)).astype(np.float32)).cuda()
        times = {}
        for arm in ORDER:
            model.fuse_exciter, model.fuse_out_mixer = ARMS[arm]
            times.setdefault(arm, []).append(time_forward(model, f0, control, args.iters))
        for arm, ms in times.items():
            per_clip = [t / batch for t in ms]
            print(json.dumps({"card": smi, "arm": arm, "batch": batch, "tc": args.tc,
                              "forward_ms": ms, "ms_per_clip": per_clip,
                              "x_realtime": [audio_s / (t / 1e3) for t in per_clip],
                              "order": ORDER}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
