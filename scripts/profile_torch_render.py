#!/usr/bin/env python3
"""Where the time of one offline render goes on the card (PyTorch port).

    python3 scripts/profile_torch_render.py [--batch 8] [--seconds 4] [--runs 3] [--fast-newt]
        [--fuse off|xcr|xfull] [--compute-dtype float32|bfloat16]

Renders ``--batch`` requests of ``--seconds`` each through the port's
``Synthesizer`` with the run120k_cr checkpoint (with ``--fast-newt``, the
same prepared batch through the model with the baked FastNEWT table, the
copy to the host included; with ``--fuse xcr`` or ``xfull``,
``NeuralWaveshaping.fuse_exciter`` and for xfull ``fuse_out_mixer`` set;
with ``--compute-dtype bfloat16`` the model's mixed precision), warms up,
then traces
``--runs`` renders with ``torch.profiler`` and prints JSON lines: the
device kernels by total time, and the device's busy and idle share of
the traced wall time (busy = union of kernel and copy intervals). Falls
back to nothing: without a card it exits non-zero.
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

CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")


def _requests(batch, seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * 125)
    out = []
    for _ in range(batch):
        lo, hi = np.sort(rng.uniform(110.0, 880.0, 2))
        loud = 0.2 + 0.08 * np.sin(np.linspace(0, 6, n))
        out.append((np.geomspace(lo, hi, n).astype(np.float32), loud.astype(np.float32)))
    return out


def _busy_ms(events):
    """Union of [start, end) intervals in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # us -> ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--fast-newt", action="store_true")
    ap.add_argument("--fuse", default="off", choices=["off", "xcr", "xfull"])
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synth = Synthesizer.from_checkpoint(CKPT, device="cuda")
    synth.model.fuse_exciter = args.fuse != "off"
    synth.model.fuse_out_mixer = args.fuse == "xfull"
    synth.model.compute_dtype = args.compute_dtype
    requests = _requests(args.batch, args.seconds)
    if args.fast_newt:
        f0_b, ctrl_b, _ = synth.prepare(requests)
        f0_t, ctrl_t = torch.from_numpy(f0_b).cuda(), torch.from_numpy(ctrl_b).cuda()
        with torch.inference_mode():
            table = synth.model.newt.bake_lookup_table()

        @torch.inference_mode()
        def render():
            gen = torch.Generator().manual_seed(0)
            return synth.model(f0_t, ctrl_t, generator=gen, lookup_table=table).cpu()
    else:
        def render():
            return synth.render(requests)
    for _ in range(3):
        render()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy = _busy_ms(device_events)
    by_name = {}
    for e in device_events:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch, "fast_newt": args.fast_newt,
        "fuse": args.fuse, "compute_dtype": args.compute_dtype,
        "seconds": args.seconds, "runs": args.runs,
        "wall_ms_per_render": wall_ms / args.runs,
        "device_busy_ms_per_render": busy / args.runs,
        "device_idle_share": 1.0 - busy / wall_ms,
        "device_events": len(device_events),
        "device_events_per_render": len(device_events) / args.runs,
    }))
    for name, (ms, count) in top:
        print(json.dumps({"kernel": name[:120], "ms_per_render": ms / args.runs,
                          "calls_per_render": count / args.runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
