#!/usr/bin/env python3
"""CREPE's CNN (full capacity, random weights) by convolution layout.

    python3 scripts/torch_crepe_layouts.py [--batches 256,501,512,1024,2048,4096]

On the card (float32, TF32 off unless stated), for each batch of windows:
the CUDA-event median ms and TFLOP/s of torchcrepe's (width, 1) 2-D
convolutions and of the same weights as 1-D convolutions (the layout
``models/crepe.py`` runs there), with ``cudnn.benchmark`` off and on, the 1-D
layout with TF32, and each layout's largest distance from the CPU's result
on 64 of the windows; then the device kernels that take the most time in one
2-D and one 1-D forward (profiler). On the CPU: the 1024-channel second
layer in both layouts against float64 (oneDNN runs the 1-D one). One JSON
object per line; needs a card for all but the CPU part.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch.models import crepe  # noqa: E402

FLOP_PER_FRAME = 2820046848  # chip_smoke.py CREPE_FULL_FLOP_PER_FRAME


def forward_2d(model, windows):
    """The model's forward with its convolutions in torchcrepe's 2-D layout."""
    x = windows[:, None, :]
    for i, (lo, hi) in enumerate(crepe._PADS, start=1):
        conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
        x = conv(F.pad(x, (lo, hi))[..., None])[..., 0]
        x = F.batch_norm(F.relu(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        x = F.max_pool1d(x, 2, 2)
    return torch.sigmoid(model.classifier(x.transpose(1, 2).reshape(x.shape[0], -1)))


def median_ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def cpu_layer_errors(seed=0) -> dict:
    """The 1024 -> 128-channel, width-64 layer on the CPU with the JAX
    suite's weight scale (0.05): each layout's largest distance from
    float64."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((0.05 * rng.standard_normal((128, 1024, 64, 1))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 1024, 191)).astype(np.float32))
    exact = F.conv1d(x.double(), w[..., 0].double())
    return {"layer": 2, "one_d": float((F.conv1d(x, w[..., 0]) - exact).abs().max()),
            "two_d": float((F.conv2d(x[..., None], w)[..., 0] - exact).abs().max()),
            "magnitude": float(exact.abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="256,501,512,1024,2048,4096")
    args = ap.parse_args(argv)
    print(json.dumps({"case": "cpu_layer_vs_float64", **cpu_layer_errors()}), flush=True)
    if not torch.cuda.is_available():
        print("torch_crepe_layouts: the card part needs CUDA", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    cpu_model = crepe.Crepe("full")
    model = crepe.Crepe("full").cuda()
    model.load_state_dict(cpu_model.state_dict())
    layouts = {"two_d": lambda x: forward_2d(model, x), "one_d": model}
    with torch.no_grad():
        for n in (int(b) for b in args.batches.split(",")):
            x = torch.randn(n, 1024, device="cuda")
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                ref = cpu_model(x[:64].cpu())
            row = {"case": "batch", "frames": n}
            for name, fn in layouts.items():
                for bench in (False, True):
                    with torch.backends.cudnn.flags(enabled=True, benchmark=bench, allow_tf32=False):
                        ms = median_ms(lambda: fn(x))
                        err = float((fn(x[:64]).cpu() - ref).abs().max())
                    key = f"{name}{'_benchmark' if bench else ''}"
                    row[key + "_ms"] = ms
                    row[key + "_tflop_per_s"] = FLOP_PER_FRAME * n / ms / 1e9
                row[name + "_vs_cpu"] = err
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                row["one_d_tf32_ms"] = median_ms(lambda: model(x))
            print(json.dumps(row), flush=True)
        from torch.profiler import ProfilerActivity, profile

        x = torch.randn(501, 1024, device="cuda")
        for name, fn in layouts.items():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                fn(x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn(x)
                    torch.cuda.synchronize()
            events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:4]
            total = sum(e.self_device_time_total for e in prof.key_averages())
            print(json.dumps({"case": "profile", "layout": name, "frames": 501, "device_ms": total / 1e3,
                              "top": [{"kernel": e.key[:80], "calls": e.count,
                                       "share": e.self_device_time_total / total} for e in events]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
