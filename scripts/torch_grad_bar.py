#!/usr/bin/env python3
"""Readings behind the card-vs-CPU gradient bar of one training step.

    python3 scripts/torch_grad_bar.py [--out FILE]

The float32 gradient of the multi-resolution STFT loss moves by ~1e-3 on
some leaves from rounding alone, so a training step on the card and on
the CPU can differ there by more than the 1e-3 normalised bar without a
fault. ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` therefore hold a
leaf beyond 1e-3 against a float64 witness (the same step on the CPU in
float64): the card's float32 gradient may be no farther from it than the
CPU's float32 gradient is, plus 1e-3.

This script measures what that rule sees. For each case (a seeded random
init and a harmonic-tone batch: the card test's 1-s tone and
``chip_smoke.py``'s 2-s clip of its synthetic dataset, each on a few
seeds) it takes one step's gradients on the card (float32, both CUDA
kernels), on the CPU in float32 and on the CPU in float64, and prints per
case, as JSON lines: every leaf beyond 1e-3 card vs CPU with its
card-vs-f64 and CPU-vs-f64 readings, and the largest excess
(card-vs-f64 - CPU-vs-f64) over all leaves. Then the same card step with
one output of the backward kernel scaled by 1.001 or 1.01 (d_exciter,
d_film_c or d_planes): a planted fault, which the rule must catch at
1.01. Needs a CUDA card; without one it exits non-zero.
"""
import argparse
import contextlib
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import write_tone_dataset  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import compute_loss  # noqa: E402

BAR = 1e-3
OUTPUTS = ("d_exciter", "d_film_c", "d_planes")


def tone_case(model_seed, rng_seed, tc=125):
    """The card test's inputs: a 1-s harmonic tone with (f0, 0) controls."""
    rng = np.random.default_rng(rng_seed)
    f0 = np.geomspace(220.0, 440.0, tc).astype(np.float32)
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, 128)) / 16000
    audio = 0.1 * sum(np.sin(k * phase) / k for k in range(1, 11))
    batch = {
        "f0": torch.from_numpy(f0[None]),
        "control": torch.from_numpy(
            np.stack([(f0 - 330.0) / 60.0, np.zeros(tc)], -1)[None].astype(np.float32)),
        "audio": torch.from_numpy(audio[None].astype(np.float32)),
    }
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    return model_seed, batch, offset, noise


def clip_case(dm, clip, model_seed, rng_seed, tc=250):
    """chip_smoke.py's inputs: 2 s of one clip of its synthetic dataset."""
    item = dm.dataset("train").batch(np.arange(clip, clip + 1))
    batch = {k: torch.from_numpy(np.ascontiguousarray(item[k][:, : tc * 128 if k == "audio" else tc]))
             for k in ("audio", "f0", "control")}
    rng = np.random.default_rng(rng_seed)
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    return model_seed, batch, offset, noise


def step_grads(base, batch, offset, noise, device, dtype):
    model = copy.deepcopy(base).to(device, dtype)
    loss = compute_loss(model, {k: v.to(device, dtype) for k, v in batch.items()},
                        phase_offset=offset.to(device, dtype), noise=noise.to(device, dtype))
    loss.backward()
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


@contextlib.contextmanager
def planted(output, scale):
    """The backward kernel with one of its outputs scaled: a fault."""
    launch = nf._launch_backward

    def faulty(*args):
        grads = list(launch(*args))
        grads[OUTPUTS.index(output)] *= scale
        return tuple(grads)

    nf._launch_backward = faulty
    try:
        yield
    finally:
        nf._launch_backward = launch


def relnorm(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def readings(card, cpu, exact):
    out = {}
    for n in cpu:
        out[n] = {"card_vs_cpu": relnorm(card[n], cpu[n]), "card_vs_f64": relnorm(card[n], exact[n]),
                  "cpu_vs_f64": relnorm(cpu[n], exact[n])}
    return out


def summary(r):
    over = {n: v for n, v in r.items() if v["card_vs_cpu"] > BAR}
    excess = {n: v["card_vs_f64"] - v["cpu_vs_f64"] for n, v in r.items()}
    worst_cvc = max(r, key=lambda n: r[n]["card_vs_cpu"])
    worst_ex = max(excess, key=excess.get)
    return {"worst_card_vs_cpu": [worst_cvc, r[worst_cvc]["card_vs_cpu"]],
            "max_excess": [worst_ex, excess[worst_ex]],
            "leaves_over_bar": over,
            "failed": sorted(n for n, v in over.items()
                             if v["card_vs_f64"] > v["cpu_vs_f64"] + BAR)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        dm = GeneralDataModule(write_tone_dataset(Path(tmp) / "data"), batch_size=8)
        cases = [(f"tone_1s_seed{s}", tone_case(s, 10 + s - 3)) for s in (3, 4, 5, 6)]
        cases += [(f"clip_2s_seed{s}", clip_case(dm, s - 1, s, 11 + s - 1)) for s in (1, 2, 3)]
        for label, (seed, batch, offset, noise) in cases:
            base = NeuralWaveshaping(generator=torch.Generator().manual_seed(seed))
            cpu = step_grads(base, batch, offset, noise, torch.device("cpu"), torch.float32)
            exact = step_grads(base, batch, offset, noise, torch.device("cpu"), torch.float64)
            card = step_grads(base, batch, offset, noise, dev, torch.float32)
            emit({"case": label, "fault": None, **summary(readings(card, cpu, exact))})
            for output in OUTPUTS:
                for scale in (1.001, 1.01):
                    with planted(output, scale):
                        bad = step_grads(base, batch, offset, noise, dev, torch.float32)
                    s = summary(readings(bad, cpu, exact))
                    emit({"case": label, "fault": f"{output} x {scale}",
                          "worst_card_vs_cpu": s["worst_card_vs_cpu"],
                          "max_excess": s["max_excess"], "failed": s["failed"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
