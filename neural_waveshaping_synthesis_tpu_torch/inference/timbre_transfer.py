"""Timbre transfer: any audio -> control signals -> NEWT synthesis
(counterpart of the JAX ``inference/timbre_transfer.py``, the reference
colab's workflow as a library).

1. :func:`extract_features`: mono float32, resampled to 16 kHz, YIN (or,
   with ``f0_extractor="crepe"`` and weights bound to
   ``extract_f0_with_crepe.weights_path``, CREPE) f0 and confidence (at
   most 1000 Hz) and perceptual loudness (n_fft 1024, hop 128), on the
   synthesizer's device; the extractors' other parameters take their gin
   bindings;
2. :func:`adjust_controls`: the colab's seven sliders
   (:class:`ControlAdjustments`), then z-scores with the checkpoint's
   statistics;
3. :func:`timbre_transfer` renders offline, with the shaper bank or, with
   ``use_fast_newt``, the baked FastNEWT table (the CUDA lookup kernel on
   the card); :func:`stream_timbre_transfer` renders buffer by buffer
   through ``PipelinedStreamer``.

Colab quirks kept (cell 15): the model gets the SHIFTED, SMOOTHED f0 in Hz
while the control stack gets the z-scored values; f0 is smoothed before it
is z-scored, loudness after; the floor subtracts, x*(x>floor) - floor,
going negative where it gates. Time-sharded rendering (``mesh``) is not
ported.
"""
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.preprocess import (
    convert_to_float32_audio,
    extract_f0_with_crepe,
    extract_f0_with_yin,
    extract_perceptual_loudness,
    make_monophonic,
    resample_audio,
)
from ..device import resolve_device
from ..streaming import PipelinedStreamer, StreamingSynth

FRAME_BUCKET = 256  # controls are zero-padded to a multiple of this many frames


def extract_features(
    audio: np.ndarray,
    sample_rate: float,
    target_sr: float = 16000,
    f0_extractor: str = "yin",
    maximum_frequency: float = 1000.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Audio of any PCM or float type, mono or stereo, at ``sample_rate``
    -> (audio at target_sr, f0, confidence, loudness) as float32 arrays,
    the last three at 1 + T // 128 frames (125 Hz). The extraction runs on
    ``device``: the card unless told otherwise (it raises without one)."""
    mono = make_monophonic(convert_to_float32_audio(np.asarray(audio)))
    x = torch.from_numpy(np.ascontiguousarray(mono)).to(resolve_device(device))
    if sample_rate != target_sr:
        x = resample_audio(x, sample_rate, target_sr)
    if f0_extractor == "crepe":
        f0, confidence = extract_f0_with_crepe(x, maximum_frequency=maximum_frequency)
    else:
        f0, confidence = extract_f0_with_yin(x, maximum_frequency=maximum_frequency)
    loudness = extract_perceptual_loudness(x, n_fft=1024, hop_length=128)
    return tuple(t.cpu().numpy() for t in (x, f0, confidence, loudness))


@dataclass(frozen=True)
class ControlAdjustments:
    """The colab's cell-15 sliders."""

    octave_shift: int = 0
    loudness_scale: float = 1.0
    loudness_floor: float = 0.0
    loudness_conf_filter: float = 0.0
    pitch_conf_filter: float = 0.0
    pitch_smoothing: int = 0
    loudness_smoothing: int = 0


def _box_smooth(x: np.ndarray, half_width: int) -> np.ndarray:
    """Zero-padded moving average of width 2*half_width+1 (the colab's
    conv1d with a ones kernel)."""
    if half_width == 0:
        return x
    w = 2 * half_width + 1
    return np.convolve(np.pad(x, (half_width, half_width)), np.ones(w) / w, mode="valid")


def adjust_controls(
    f0: np.ndarray,
    confidence: np.ndarray,
    loudness: np.ndarray,
    data_mean: np.ndarray,
    data_std: np.ndarray,
    adjustments: ControlAdjustments = ControlAdjustments(),
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (f0_hz (Tc,), control (Tc, 2)) float32, ready for the model. On
    the host in numpy, as in JAX: Tc values."""
    a = adjustments
    f0_filtered = f0 * (confidence > a.pitch_conf_filter)
    loud_filtered = loudness * (confidence > a.loudness_conf_filter)
    f0_shifted = f0_filtered * (2.0**a.octave_shift)
    loud_floored = loud_filtered * (loud_filtered > a.loudness_floor) - a.loudness_floor
    loud_scaled = loud_floored * a.loudness_scale

    loud_norm = (loud_scaled - data_mean[1, 0]) / data_std[1, 0]

    f0_hz = _box_smooth(f0_shifted, a.pitch_smoothing)
    loud_norm = _box_smooth(loud_norm, a.loudness_smoothing)
    f0_norm = (f0_hz - data_mean[0, 0]) / data_std[0, 0]

    control = np.stack([f0_norm, loud_norm], axis=-1).astype(np.float32)
    return f0_hz.astype(np.float32), control


def _controls(synth, audio, sample_rate, adjustments, f0_extractor):
    model = synth.model
    _, f0, confidence, loudness = extract_features(
        audio, sample_rate, model.sample_rate, f0_extractor, device=synth.device
    )
    return adjust_controls(f0, confidence, loudness, synth.data_mean, synth.data_std, adjustments)


def timbre_transfer(
    synth,
    audio: np.ndarray,
    sample_rate: float,
    adjustments: ControlAdjustments = ControlAdjustments(),
    f0_extractor: str = "yin",
    use_fast_newt: bool = False,
    seed: int = 0,
) -> Tuple[np.ndarray, float]:
    """The whole pipeline with an ``inference.Synthesizer`` -> (audio
    (Tc * hop,) float32, x real time).

    The controls are zero-padded to a multiple of ``FRAME_BUCKET`` frames
    and rendered at batch 1 on the synthesizer's device, with the phase
    offsets and noise drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (the same draws on every device). With ``use_fast_newt`` the
    shaper bank is baked into a 4096 x C table first. The speed is audio
    seconds over the wall time of one forward after a warm-up, the copy
    of the audio to the host included."""
    model = synth.model
    f0_hz, control = _controls(synth, audio, sample_rate, adjustments, f0_extractor)
    tc = f0_hz.shape[0]
    pad = (-tc) % FRAME_BUCKET
    f0_in = torch.from_numpy(np.pad(f0_hz, (0, pad))[None]).to(synth.device)
    ctrl_in = torch.from_numpy(np.pad(control, ((0, pad), (0, 0)))[None]).to(synth.device)

    with torch.inference_mode():
        table = model.newt.bake_lookup_table() if use_fast_newt else None

        def render():
            generator = torch.Generator(device="cpu").manual_seed(seed)
            y = model(f0_in, ctrl_in, generator=generator, lookup_table=table)
            return y.cpu().numpy()

        render()  # warm-up: kernel build and load, allocator, cuDNN plans
        t0 = time.perf_counter()
        out = render()
        wall = time.perf_counter() - t0

    hop = model.control_hop
    return out[0, : tc * hop], tc * hop / model.sample_rate / wall


def stream_timbre_transfer(
    synth,
    audio: np.ndarray,
    sample_rate: float,
    adjustments: ControlAdjustments = ControlAdjustments(),
    f0_extractor: str = "yin",
    seed: int = 0,
    buffer_size: int = 1024,
    pipeline_depth: int = 4,
) -> Tuple[np.ndarray, Dict]:
    """Timbre transfer rendered buffer by buffer through
    ``PipelinedStreamer`` (carried state, ``pipeline_depth`` buffers in
    flight), as a live client would consume it; the controls are
    extracted offline as in :func:`timbre_transfer`. The output differs
    from the offline render by the streaming semantics (per-stream phases,
    segment ramps, a linear reverb). FastNEWT has no streaming path, in
    JAX either.

    The stream's carried f0 is primed with the first frame, so buffer 0
    does not ramp up from 0 Hz. A warm-up pass runs first; the measured
    pass returns ``(audio (Tc * hop,), stats)``: buffer arrival cadence
    p50 / p95 on the host, first-buffer latency, x real time end to end
    and the buffer's budget."""
    model = synth.model
    hop = model.control_hop
    if buffer_size % hop:
        raise ValueError(
            f"buffer_size must be a multiple of control_hop ({hop}), got {buffer_size}"
        )
    frames = buffer_size // hop
    f0_hz, control = _controls(synth, audio, sample_rate, adjustments, f0_extractor)
    tc = f0_hz.shape[0]
    n_buffers = -(-tc // frames)
    pad = n_buffers * frames - tc
    f0_b = np.pad(f0_hz, (0, pad)).reshape(n_buffers, 1, frames)
    ctrl_b = np.pad(control, ((0, pad), (0, 0))).reshape(n_buffers, 1, frames, 2)
    ss = StreamingSynth(model, frames)

    def run():
        streamer = PipelinedStreamer(
            ss, batch=1, generator=torch.Generator(device=synth.device).manual_seed(seed),
            depth=pipeline_depth, device=synth.device,
        )
        prime = torch.from_numpy(f0_b[0, :, 0]).to(synth.device)
        streamer.state = streamer.state._replace(prev_f0=prime)
        chunks, pops = [], []
        t_start = time.perf_counter()
        for i in range(n_buffers):
            out = streamer.push(f0_b[i], ctrl_b[i])
            if out is not None:
                pops.append(time.perf_counter())
                chunks.append(out)
        for out in streamer.flush():
            pops.append(time.perf_counter())
            chunks.append(out)
        return chunks, np.asarray(pops), pops[0] - t_start, time.perf_counter() - t_start

    run()  # warm-up
    chunks, pops, first_latency, wall = run()

    out = np.concatenate([c[0] for c in chunks])[: tc * hop]
    cadence_ms = np.diff(pops) * 1000 if len(pops) > 1 else np.zeros(1)
    stats = {
        "buffer_size": buffer_size,
        "n_buffers": n_buffers,
        "pipeline_depth": pipeline_depth,
        "cadence_p50_ms": float(np.percentile(cadence_ms, 50)),
        "cadence_p95_ms": float(np.percentile(cadence_ms, 95)),
        "first_buffer_latency_ms": first_latency * 1000,
        "x_realtime": tc * hop / model.sample_rate / wall,
        "buffer_budget_ms": buffer_size / model.sample_rate * 1000,
    }
    return out, stats
