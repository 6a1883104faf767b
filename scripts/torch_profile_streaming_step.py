#!/usr/bin/env python3
"""Where a streaming buffer's milliseconds go, per stage of
``StreamingSynth.step``, with the PyTorch/CUDA port (the counterpart of
``scripts/profile_streaming_step.py``), at a number of concurrent streams
(the batch) and a buffer size.

    python3 scripts/torch_profile_streaming_step.py [--batch-streams 64] [--buffer-size 1024]
        [--probe full_step --probe shaper] [--device cpu]

Each probe is timed by ``utils.profiling.differential_loop_ms`` (an eager
loop at ``--n-long`` and ``--n-short`` iterations, CUDA events and one
synchronisation per loop, best of ``--repeats``, the difference over the
difference in lengths): on the card the queued loop's pace, the host's
launch time where the host sets it, not device-only time. ``full_step``
threads the real ``StreamState`` (the phase, the GRU state, the noise and
reverb carries move every iteration), so it is comparable to
``scripts/torch_time_buffer_sizes.py --streaming``'s queued-loop step and
to ``scripts/torch_serving_capacity.py``'s cadence. The stage probes are
JAX's by name, each on inputs drawn from ``default_rng(0)`` as JAX's
(f0 = 220 x 2^U(0, 2) Hz, control ~ N(0, 1), and the stage's own inputs):
``control_gru`` (the control encoder with the carried GRU state),
``film_and_noise_mlp``, ``oscillator_mixer`` (the bank with the carried
phase, and the harmonic mixer), ``shaper`` (NEWT's FiLM -> shaper -> FiLM
and mixer as the step runs it, ``NEWT.forward_stream``: on the card the
stream kernel 3, where JAX's probe times the plain chain on an audio-rate
FiLM), ``noise_filter_fir`` and ``reverb_fdl`` (one partitioned-convolution
step on the carried delay line). ``full_step`` and ``shaper`` must move the
stream kernel's launch counter on the card or the script exits non-zero.
The model is built from ``--gin-file`` with weights from a seeded generator
(seed 0). Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.ops.fir import (  # noqa: E402
    partitioned_convolve_step,
    windowed_fir_from_magnitude,
)
from neural_waveshaping_synthesis_tpu_torch.streaming import StreamingSynth  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    differential_loop_ms,
    require_launches,
)
from torch_time_buffer_sizes import STREAM_KERNEL  # noqa: E402  (same folder)
from torch_time_forward_pass import build_model  # noqa: E402


def probe_inputs(b: int, k: int, hop: int, c: int, emb_width: int, n_bins: int):
    """JAX's draws, ``default_rng(0)``: f0 (B, K), control (B, K, 2), an
    exciter (B, K*hop, C), a FiLM (B, K, 4C) (JAX's probe drew an
    audio-rate one, (B, K*hop, 4C); the port's shaper stage takes control-rate
    frames, so the first K rows of that draw), an embedding, a noise
    magnitude and a dry signal, float32 numpy arrays."""
    rng = np.random.default_rng(0)
    ta = k * hop
    f0 = 220.0 * 2.0 ** rng.uniform(0, 2, (b, k))
    control = rng.standard_normal((b, k, 2))
    exciter = rng.standard_normal((b, ta, c)) * 0.3
    film = rng.standard_normal((b, ta, 4 * c))[:, :k]
    emb = rng.standard_normal((b, k, emb_width))
    h_mag = np.abs(rng.standard_normal((b, k, n_bins)))
    dry = rng.standard_normal((b, ta)) * 0.1
    return [np.ascontiguousarray(a, np.float32)
            for a in (f0, control, exciter, film, emb, h_mag, dry)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/models/newt.gin)")
    ap.add_argument("--batch-streams", type=int, default=64, help="concurrent streams (batch)")
    ap.add_argument("--buffer-size", type=int, default=1024, help="samples per buffer")
    ap.add_argument("--n-short", type=int, default=20, help="short loop length")
    ap.add_argument("--n-long", type=int, default=120, help="long loop length")
    ap.add_argument("--repeats", type=int, default=3, help="timed loops per length (best kept)")
    ap.add_argument("--probe", action="append", default=[],
                    help="run only these probes (repeatable); default all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/models/newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args.gin_file, [], "", device)
    hop = model.control_hop
    if args.buffer_size % hop:
        raise SystemExit(f"--buffer-size must be a multiple of {hop}")
    k = args.buffer_size // hop
    synth = StreamingSynth(model, k)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[profile_streaming_step] device={name} streams={args.batch_streams} "
          f"buffer={args.buffer_size} (K={k} frames) loop {args.n_short}/{args.n_long} "
          f"x best-of-{args.repeats}", flush=True)

    b, c = args.batch_streams, model.newt.n_waveshapers
    state0 = synth.init_state(b, torch.Generator(device=device).manual_seed(1), device=device)
    spec = synth.ir_partition_spectra()
    f0, control, exciter, film, emb, h_mag, dry = (
        torch.from_numpy(a).to(device) for a in probe_inputs(
            b, k, hop, c, model.embedding.proj.w.shape[-1], model.noise_synth.ir_length // 2 + 1))
    f0_aud = f0.repeat_interleave(hop, dim=1)

    def oscillator_mixer(_):
        bank = model.osc(f0_aud, phase_offset=state0.phase_offset, initial_phase=state0.osc_phase)
        return model.harmonic_mixer(bank)

    def film_and_noise_mlp(_):
        return model.newt.film_params(emb), model.h_generator(emb)

    probes = {
        "full_step": (lambda s: synth.step(s, f0, control, spec)[1], state0, STREAM_KERNEL),
        "control_gru": (lambda _: model.get_embedding(control, state0.gru_h), None),
        "film_and_noise_mlp": (film_and_noise_mlp, None),
        "oscillator_mixer": (oscillator_mixer, None),
        "shaper": (lambda _: model.newt.forward_stream(exciter, state0.prev_film, film), None,
                   STREAM_KERNEL),
        "noise_filter_fir": (lambda _: windowed_fir_from_magnitude(h_mag), None),
        "reverb_fdl": (lambda _: partitioned_convolve_step(
            dry, state0.reverb_fdl, state0.reverb_tail, spec), None),
    }
    selected = args.probe or list(probes)
    unknown = [s for s in selected if s not in probes]
    if unknown:
        raise SystemExit(f"unknown probes {unknown}; available: {list(probes)}")

    width = max(len(s) for s in selected)
    results = {}
    with torch.inference_mode():
        for probe in selected:
            body, carry, *kernels = probes[probe]
            before = launch_counts()
            ms = differential_loop_ms(body, args.n_short, args.n_long, args.repeats, carry=carry,
                                      device=device)
            results[probe] = ms
            print(f"  {probe:<{width}}  {ms:8.3f} ms", flush=True)
            for group in kernels:
                require_launches(before, group, device)
    total = results.get("full_step")
    if total and total > 0:
        budget = 1000.0 * args.buffer_size / float(model.sample_rate)
        headroom = budget / total
        print(f"[profile_streaming_step] full step {total:.3f} ms for {b} streams (queued loop) - "
              f"{headroom:.1f}x inside the {budget:.1f} ms buffer budget "
              f"(~{b * headroom:.0f} streams at this batch's per-stream cost)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
