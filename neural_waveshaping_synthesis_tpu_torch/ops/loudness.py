"""Perceptual loudness and RMS (counterpart of the JAX ``ops/loudness.py``,
which matches librosa).

Quirks kept:

* ``amplitude_to_db`` references the max over the WHOLE spectrogram of
  the call (librosa's ``ref=np.max``) and clips at 80 dB below the peak,
  so a batch of clips in one call shares one reference: call it per clip;
* the reference computes the A-weighting curve but never adds it, so
  ``apply_a_weighting`` defaults to False, as the shipped checkpoints
  were trained;
* the STFT is centred (reflect padding) with a periodic Hann window of
  ``n_fft`` samples.
"""
from typing import Optional

import torch

from .stft import stft
from .windows import hann_window


def amplitude_to_db(
    magnitude: torch.Tensor,
    amin: float = 1e-5,
    top_db: Optional[float] = 80.0,
) -> torch.Tensor:
    """Power dB of an amplitude spectrogram, referenced to its max and
    floored at ``top_db`` below it (librosa ``amplitude_to_db`` with
    ``ref=np.max``)."""
    power = torch.square(torch.clamp(magnitude, min=0.0))
    amin_p = amin * amin
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=amin_p))
    ref_p = torch.clamp(power.max(), min=amin_p)
    log_spec = log_spec - 10.0 * torch.log10(ref_p)
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def a_weighting(frequencies: torch.Tensor, min_db: float = -80.0) -> torch.Tensor:
    """IEC 61672 A-weighting curve in dB (librosa ``A_weighting``)."""
    f_sq = torch.square(frequencies)
    const = torch.tensor(
        [12194.217, 20.598997, 107.65265, 737.86223], device=frequencies.device
    ) ** 2.0
    weights = 2.0 + 20.0 * (
        torch.log10(const[0])
        + 2.0 * torch.log10(torch.clamp(f_sq, min=1e-20))
        - torch.log10(f_sq + const[0])
        - torch.log10(f_sq + const[1])
        - 0.5 * torch.log10(f_sq + const[2])
        - 0.5 * torch.log10(f_sq + const[3])
    )
    return torch.clamp(weights, min=min_db)


def extract_perceptual_loudness(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    n_fft: int = 1024,
    hop_length: int = 128,
    epsilon: float = 1e-5,
    normalise: bool = True,
    apply_a_weighting: bool = False,
) -> torch.Tensor:
    """Frame-rate loudness of ``(..., T)`` audio -> ``(..., 1 + T // hop)``:
    the mean over frequency bins of the dB spectrogram, mapped by
    (x + 80) / 80 when ``normalise``."""
    window = hann_window(n_fft, periodic=True, device=audio.device)
    mag = torch.abs(stft(audio, n_fft, hop_length, window=window))
    db = amplitude_to_db(mag, amin=epsilon, top_db=80.0)
    if apply_a_weighting:
        freqs = torch.fft.rfftfreq(n_fft, 1.0 / sample_rate, device=audio.device)
        db = db + a_weighting(freqs)
    loudness = db.mean(dim=-1)
    if normalise:
        loudness = (loudness + 80.0) / 80.0
    return loudness


def extract_rms(audio: torch.Tensor, window_size: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """Centred (zero-padded) frame RMS of ``(..., T)`` audio."""
    half = window_size // 2
    padded = torch.nn.functional.pad(audio, (half, half))
    frames = padded.unfold(-1, window_size, hop_length)
    return torch.sqrt(torch.mean(torch.square(frames), dim=-1))
