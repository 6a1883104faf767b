#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed as one JSON line; any failure raises, so the run
exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernel from ``kernels/csrc`` for sm_90a;
3. kernels: the kernel's wrapper on CUDA tensors against its plain
   PyTorch version on the same tensors (rtol=1e-4, atol=1e-5), and the
   kernel's FiLM interpolation bit for bit against ``linear_upsample``.
   The inputs are the ones the main path hands the kernel, caught with
   hooks in one forward of the served model per request set: the served
   batch (4 requests padded to 1024 frames), the single request and the
   timed batch of 8 (512 frames each); then two made-up shapes the TPU
   gate refused (odd Tc=37, hop=64);
4. serve: ``Synthesizer.from_checkpoint(..., device="cuda")`` renders a
   batch of four requests (2, 4, 4 and 7 s) and one 4-s request; the
   outputs must be finite and not silent, every render must have
   launched the kernel, and NEWT must not have run its plain chain on
   the card. Then one request rendered on the card and on the CPU from
   the same injected phase offsets and noise must agree within 1e-3
   normalised RMS;
5. timing: CUDA-event medians of 20 runs after warm-up — the kernel and
   its plain version on the batch-8 inputs of phase 3, the model's
   forward and the whole render at batch 1 and 8 x 4 s.

Then the kernels line (the numbers of phases 3-5 per kernel, with its
least possible time on an H100 from its bytes and operations) and, last,
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN (the GRU), so the card computes in float32 like the CPU reference.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer
from neural_waveshaping_synthesis_tpu_torch.kernels import _build
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample

REPO = Path(__file__).resolve().parent
CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")
HOP, SR = 128, 16000
RTOL, ATOL = 1e-4, 1e-5
N_TIMED = 20
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# f32 operations per (sample, channel) in newt_fused_cr.cu, an FMA as two:
# FiLM lerp 4*(2 mul + add) + division + (1-w) = 14; FiLM-in FMA + scale = 3;
# MLP 1->8->8->8->1 multiply-adds (8 + 64 + 64 + 8) * 2 = 288; 25 sines of
# (mul, rint, fma, mul, 6 fma, mul) = 18 each = 450; FiLM-out FMA = 2.
CR_FLOP_PER_ELEMENT = 14 + 3 + 288 + 450 + 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_median_ms(fn, n=N_TIMED, warmup=3):
    for _ in range(warmup):
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


def host_median_ms(fn, n=N_TIMED, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()  # ends in a device-to-host copy, which waits for the card
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def make_requests(seconds, seed):
    """f0 glides within 110-880 Hz and loudness contours at 125 Hz."""
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        n = int(s * SR / HOP)
        lo, hi = np.sort(rng.uniform(110.0, 880.0, 2))
        f0 = np.geomspace(lo, hi, n) * (1 + 0.01 * np.sin(np.linspace(0, 40 * s, n)))
        loud = 0.2 + 0.08 * np.sin(np.linspace(0, rng.uniform(2, 8) * s, n)) + 0.01 * rng.standard_normal(n)
        out.append((f0.astype(np.float32), loud.astype(np.float32)))
    return out


def main_path_kernel_inputs(synth, requests):
    """The (exciter, control-rate film) that the main path hands the
    kernel for these requests: one forward of the served model, with
    hooks on NEWT (its exciter) and on NEWT's FiLM MLP (its output)."""
    f0_b, ctrl_b, _ = synth.prepare(requests)
    got = {}
    hooks = [
        synth.model.newt.register_forward_pre_hook(
            lambda m, args: got.__setitem__("exciter", args[0].clone())),
        synth.model.newt.mlp.register_forward_hook(
            lambda m, args, out: got.__setitem__("film_c", out.clone())),
    ]
    try:
        with torch.inference_mode():
            synth.model(torch.from_numpy(f0_b).to(synth.device),
                        torch.from_numpy(ctrl_b).to(synth.device),
                        generator=torch.Generator().manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    return got["exciter"], got["film_c"]


def made_up_kernel_inputs(b, tc, hop, seed, device):
    rng = np.random.default_rng(seed)
    exc = (rng.standard_normal((b, tc * hop, 64)) * 0.5).astype(np.float32)
    film_c = rng.standard_normal((b, tc, 256)).astype(np.float32)
    return torch.from_numpy(exc).to(device), torch.from_numpy(film_c).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build the kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    _build.load("newt_fused_cr")
    emit({"phase": "build", "kernel": "newt_fused_cr", "seconds": time.perf_counter() - t0,
          "ptxas": _build.build_log("newt_fused_cr").strip().splitlines()[-3:]})

    # 3. kernel vs plain on the card, on the main path's own inputs
    synth = Synthesizer.from_checkpoint(CKPT, device="cuda")
    newt = synth.model.newt
    weights, packed = newt.shaping_fn.params(), newt._packed_shaper()
    batch = make_requests([2, 4, 4, 7], seed=1)
    single = make_requests([4], seed=2)
    timed = {"batch1_4s": make_requests([4], 5), "batch8_4s": make_requests([4] * 8, 6)}
    cases = [("serve_batch", *main_path_kernel_inputs(synth, batch)),
             ("serve_single", *main_path_kernel_inputs(synth, single)),
             ("timed_batch8", *main_path_kernel_inputs(synth, timed["batch8_4s"])),
             ("odd_tc", *made_up_kernel_inputs(1, 37, HOP, 1, dev)),
             ("hop_64", *made_up_kernel_inputs(2, 500, 64, 2, dev))]
    max_err = 0.0
    for label, exc, film_c in cases:
        b, ta, _ = exc.shape
        tc = film_c.shape[1]
        hop = ta // tc
        with torch.inference_mode():
            out = nf.film_shaper_cr(exc, film_c, weights, hop, packed=packed)
            ref = nf.film_shaper_cr_plain(exc, film_c, weights, hop)
        torch.cuda.synchronize()
        out, ref = out.cpu().numpy(), ref.cpu().numpy()
        err = float(np.max(np.abs(out - ref)))
        emit({"phase": "kernel", "name": "film_shaper_fused_cr", "case": label, "B": b,
              "Tc": tc, "hop": hop, "max_abs_err": err, "rtol": RTOL, "atol": ATOL})
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        max_err = max(max_err, err)
        # with gamma_out = 0 the output is the kernel's in-register beta_out
        # lerp, which must equal linear_upsample on the CPU bit for bit
        with torch.inference_mode():
            film_z = film_c.clone()
            film_z[..., 128:192] = 0.0
            lerp = nf.film_shaper_cr(exc, film_z, weights, hop, packed=packed).cpu()
            expect = linear_upsample(film_z.cpu(), ta)[..., 192:]
        n_diff = int((lerp != expect).sum())
        emit({"phase": "kernel_film_lerp", "case": label, "B": b, "Tc": tc, "hop": hop,
              "elements_not_bit_exact": n_diff})
        if n_diff:
            raise RuntimeError("in-kernel FiLM interpolation is not bit-exact")
    timed_exc, timed_film = cases[2][1], cases[2][2]
    del cases, out, ref, lerp, expect, film_z

    # 4. serve through the entry point a user calls
    nf.film_shaper_cr.launches = 0
    NEWT.cuda_chain_runs = 0
    renders = []
    for requests in (batch, single):
        before = nf.film_shaper_cr.launches
        audio = synth.render(requests, seed=0)
        if nf.film_shaper_cr.launches <= before:
            raise RuntimeError("a render on the card did not launch film_shaper_fused_cr")
        renders.append((requests, audio))
    launches = nf.film_shaper_cr.launches
    if NEWT.cuda_chain_runs:
        raise RuntimeError("NEWT ran its plain chain on the card on the main path")
    for requests, audio in renders:
        for (f0, _), a in zip(requests, audio):
            if a.shape != (f0.shape[0] * HOP,) or not np.all(np.isfinite(a)):
                raise RuntimeError(f"bad render: shape {a.shape}, finite {np.all(np.isfinite(a))}")
            if np.sqrt(np.mean(a**2)) < 1e-4:
                raise RuntimeError("silent render")
    emit({"phase": "serve", "requests_s": [2, 4, 4, 7, 4], "renders": len(renders),
          "kernel_launches": launches,
          "rms": [float(np.sqrt(np.mean(a**2))) for _, au in renders for a in au]})

    # card vs CPU, same injected randomness
    f0_b, ctrl_b, _ = synth.prepare(make_requests([2], seed=3))
    rng = np.random.default_rng(4)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, f0_b.shape[1] * HOP - 1).astype(np.float32)
    cpu_synth = Synthesizer.from_checkpoint(CKPT, device="cpu")
    outs = []
    for s in (synth, cpu_synth):
        with torch.inference_mode():
            y = s.model(torch.from_numpy(f0_b).to(s.device), torch.from_numpy(ctrl_b).to(s.device),
                        phase_offset=torch.from_numpy(offset).to(s.device),
                        noise=torch.from_numpy(noise).to(s.device))
        outs.append(y.cpu().numpy())
    card_vs_cpu = nrms(outs[0], outs[1])
    emit({"phase": "card_vs_cpu", "frames": int(f0_b.shape[1]), "nrms": card_vs_cpu, "bar": 1e-3})
    if not card_vs_cpu <= 1e-3:
        raise RuntimeError(f"card and CPU renders differ: nRMS {card_vs_cpu}")

    # 5. timing on the main path's batch-8 inputs, and end to end
    b, ta, _ = timed_exc.shape
    tc = timed_film.shape[1]
    hop = ta // tc
    with torch.inference_mode():
        kernel_ms = cuda_median_ms(
            lambda: nf.film_shaper_cr(timed_exc, timed_film, weights, hop, packed=packed))
        plain_ms = cuda_median_ms(
            lambda: nf.film_shaper_cr_plain(timed_exc, timed_film, weights, hop))
    n_el = b * ta * 64
    flop = n_el * CR_FLOP_PER_ELEMENT
    nbytes = 4 * (2 * n_el + timed_film.numel() + packed.numel())
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, flop / PEAK_F32_FLOP_PER_S) * 1e3
    bound_by = "operations" if flop / PEAK_F32_FLOP_PER_S >= nbytes / PEAK_BYTES_PER_S else "bytes"
    emit({"phase": "timing_kernel", "B": b, "Tc": tc, "hop": hop, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "flop": flop, "bytes": nbytes, "bound_ms": bound_ms,
          "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms})
    del timed_exc, timed_film

    for label, requests in timed.items():
        f0_b, ctrl_b, _ = synth.prepare(requests)
        f0_t, ctrl_t = torch.from_numpy(f0_b).to(dev), torch.from_numpy(ctrl_b).to(dev)
        gen = torch.Generator().manual_seed(0)
        with torch.inference_mode():
            forward_ms = cuda_median_ms(lambda: synth.model(f0_t, ctrl_t, generator=gen))
        render_ms = host_median_ms(lambda: synth.render(requests, seed=0))
        audio_s = len(requests) * 4.0
        emit({"phase": "timing_render", "case": label, "padded_frames": int(f0_b.shape[1]),
              "forward_ms": forward_ms, "render_ms": render_ms,
              "forward_x_realtime": audio_s / (forward_ms / 1e3),
              "render_x_realtime": audio_s / (render_ms / 1e3)})

    emit({"kernels": [{
        "name": "film_shaper_fused_cr", "route": "cuda",
        "source": "neural_waveshaping_synthesis_tpu_torch/kernels/csrc/newt_fused_cr.cu",
        "replaces": "neural_waveshaping_synthesis_tpu/kernels/newt_fused.py:779",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
