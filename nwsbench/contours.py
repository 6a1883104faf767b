"""The one generator of the benchmark's inputs: f0 and loudness contours of a
played instrument, and tones rendered under them, drawn from the seed by
the parameters of a cell's traffic mix.

A contour of request (or stream) r at control frame t, with its own draws
from the mix's ranges:

    f0(t)   = base * 2 ** ((glide * sin(2 pi g t / fr + a) + vib * sin(2 pi v t / fr + b)) / 1200)
    loud(t) = peak + swell * sin(2 pi s t / fr + c)          (dB)

base log-uniform over ``f0_hz``; glide and vibrato depths in cents over
``glide_cents`` and ``vibrato_cents``, their rates over ``glide_hz`` and
``vibrato_hz``; ``peak`` over ``loudness_db``, ``swell`` over ``swell_db``
at a rate over ``swell_hz``; fr the control rate. The model's control is
each contour z-scored by the mix's ``f0_norm`` and ``loudness_norm`` (mean,
std). Every contour is a closed form of t, so any frame of any request can
be drawn again from the seed alone.
"""
import math
from typing import Dict, Tuple

import numpy as np
import torch

from nwsbench.harness import seed_of

_FIELDS = ("f0_hz", "glide_cents", "glide_hz", "vibrato_cents", "vibrato_hz",
           "loudness_db", "swell_db", "swell_hz")


def draw_params(seed: int, stream: Tuple[int, ...], n: int, mix: Dict) -> Dict[str, np.ndarray]:
    """n contours' draws from (seed, *stream)."""
    rng = np.random.default_rng([seed, *stream])
    lo, hi = mix["f0_hz"]
    out = {"base": np.exp(rng.uniform(math.log(lo), math.log(hi), n))}
    for name in _FIELDS[1:]:
        out[name] = rng.uniform(*mix[name], n)
    for name in ("phase_glide", "phase_vibrato", "phase_swell"):
        out[name] = rng.uniform(0.0, 2 * math.pi, n)
    return out


def contour(params: Dict[str, np.ndarray], frames: np.ndarray, frame_rate: float
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(n,) draws, (T,) frame indices -> f0 (n, T) Hz and loudness (n, T) dB,
    float32."""
    t = frames[None, :].astype(np.float64) / frame_rate
    p = {k: v[:, None] for k, v in params.items()}
    cents = (p["glide_cents"] * np.sin(2 * np.pi * p["glide_hz"] * t + p["phase_glide"])
             + p["vibrato_cents"] * np.sin(2 * np.pi * p["vibrato_hz"] * t + p["phase_vibrato"]))
    f0 = p["base"] * np.exp2(cents / 1200.0)
    loud = p["loudness_db"] + p["swell_db"] * np.sin(2 * np.pi * p["swell_hz"] * t + p["phase_swell"])
    return f0.astype(np.float32), loud.astype(np.float32)


def controls(params: Dict[str, np.ndarray], frames: np.ndarray, frame_rate: float, mix: Dict
             ) -> Tuple[np.ndarray, np.ndarray]:
    """-> f0 (n, T) Hz and the normalised control (n, T, 2), float32."""
    f0, loud = contour(params, frames, frame_rate)
    (fm, fs), (lm, ls) = mix["f0_norm"], mix["loudness_norm"]
    ctrl = np.stack([(f0 - np.float32(fm)) / np.float32(fs),
                     (loud - np.float32(lm)) / np.float32(ls)], axis=-1)
    return f0, ctrl.astype(np.float32)


def tones(f0: np.ndarray, loud: np.ndarray, seed: int, hop: int, sample_rate: float,
          n_harmonics: int, device) -> np.ndarray:
    """Harmonic tones under (n, Tc) contours -> (n, Tc*hop) float32 audio:
    ``n_harmonics`` partials at 1/k^rolloff (rolloff drawn in [1, 2] per
    tone), each below Nyquist, at the loudness's amplitude, plus a
    -60 dB noise floor; made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, tc = f0.shape
    f0_t = torch.from_numpy(f0).to(device)
    amp = torch.from_numpy(np.power(10.0, loud / 20.0).astype(np.float32)).to(device)
    size = tc * hop
    f0_up = torch.nn.functional.interpolate(f0_t[:, None], size=size, mode="linear")[:, 0]
    amp_up = torch.nn.functional.interpolate(amp[:, None], size=size, mode="linear")[:, 0]
    phase = torch.remainder(2 * math.pi * torch.cumsum(f0_up.double(), -1) / sample_rate,
                            2 * math.pi).float()
    rolloff = 1.0 + torch.rand(n, 1, generator=gen, device=device)
    audio = torch.zeros(n, size, device=device)
    for k in range(1, n_harmonics + 1):
        weight = (k ** -rolloff) * (f0_up * k < sample_rate / 2)
        audio += weight * torch.sin(k * phase)
    audio = audio * amp_up + 1e-3 * (torch.rand(n, size, generator=gen, device=device) - 0.5)
    return audio.cpu().numpy()


def stream_offsets(seed: int, n: int, n_harmonics: int, device) -> torch.Tensor:
    """The (n, H) phase offsets of a stream traffic's n streams, uniform in
    [-pi, pi), from a ``device`` generator seeded from (seed, 5)."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 5))
    return torch.rand((n, n_harmonics), device=device, generator=gen) * (2 * np.pi) - np.pi


def stream_noise(seed: int, device) -> torch.Generator:
    """The ``device`` generator, seeded from (seed, 6), that draws each
    buffer's (n, K*hop) noise of a stream traffic, one buffer after another."""
    return torch.Generator(device=device).manual_seed(seed_of(seed, 6))
