"""YIN fundamental-frequency estimation (counterpart of the JAX
``ops/f0.py`` ``yin_f0``).

Every frame's difference function is computed at once through a batched
FFT autocorrelation, on the audio's device. Returns (f0, periodicity) per
frame, the (f0, confidence) contract of the CREPE extractor. The
probabilistic variant (``pyin_f0``) is not ported yet.
"""
from typing import Tuple

import torch

from .stft import _reflect_pad, frame_signal


def _difference_function(frames: torch.Tensor, tau_max: int) -> torch.Tensor:
    """YIN eq. (6) difference function d(tau), tau < ``tau_max``, of
    ``(..., F, W)`` frames, through an FFT autocorrelation."""
    w = frames.shape[-1]
    n = 1
    while n < 2 * w:
        n *= 2
    spec = torch.fft.rfft(frames, n=n, dim=-1)
    acf = torch.fft.irfft(spec * torch.conj(spec), n=n, dim=-1)[..., :tau_max]

    # energies of x[0 : W - tau] and x[tau : W] from one cumulative sum
    csum = torch.cumsum(torch.square(frames), dim=-1)
    total = csum[..., -1:]
    tau = torch.arange(tau_max, device=frames.device)
    e_head = csum[..., w - 1 - tau]
    before = csum[..., torch.clamp(tau - 1, min=0)]
    e_tail = total - torch.where(tau > 0, before, torch.zeros_like(before))
    return e_head + e_tail - 2.0 * acf


def _cmndf(d: torch.Tensor) -> torch.Tensor:
    """Cumulative mean-normalised difference (YIN eq. 8), d'(0) = 1."""
    tau = torch.arange(1, d.shape[-1], device=d.device)
    running = torch.cumsum(d[..., 1:], dim=-1)
    normed = d[..., 1:] * tau / torch.clamp(running, min=1e-12)
    return torch.cat([torch.ones_like(d[..., :1]), normed], dim=-1)


def yin_f0(
    audio: torch.Tensor,
    sample_rate: float = 16000.0,
    frame_length: int = 1024,
    hop_length: int = 128,
    fmin: float = 50.0,
    fmax: float = 2000.0,
    threshold: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """YIN pitch track of ``(..., T)`` audio -> (f0 Hz, periodicity in
    [0, 1]), each ``(..., 1 + T // hop)`` (centred frames, reflect
    padding). f0 is the best candidate even where the frame is unvoiced:
    consumers gate on periodicity = 1 - d'(tau*)."""
    padded = _reflect_pad(audio, frame_length // 2)
    frames = frame_signal(padded, frame_length, hop_length)  # (..., F, W)

    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(sample_rate / fmin) + 1, frame_length - 1)
    cm = _cmndf(_difference_function(frames, tau_max + 1))  # (..., F, tau_max + 1)

    lags = torch.arange(tau_max + 1, device=audio.device)
    inf = torch.tensor(float("inf"), device=audio.device)
    masked = torch.where((lags >= tau_min) & (lags <= tau_max), cm, inf)

    # the first tau below the threshold that is also a local trough, else
    # the global minimum; argmax/argmin return the first such index
    next_cm = torch.cat([masked[..., 1:], inf.expand_as(masked[..., :1])], dim=-1)
    below = (masked < threshold) & (masked <= next_cm)
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)
    global_min = torch.argmin(masked, dim=-1)
    tau_star = torch.where(below.any(dim=-1), first_below, global_min)

    # parabolic interpolation around tau_star for sub-sample precision
    def at(lag):
        return torch.gather(cm, -1, lag[..., None])[..., 0]

    y0 = at(torch.clamp(tau_star - 1, 0, tau_max))
    y1 = at(tau_star)
    y2 = at(torch.clamp(tau_star + 1, 0, tau_max))
    denom = y0 - 2.0 * y1 + y2
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (y0 - y2) / safe, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    tau_refined = torch.clamp(tau_star.to(torch.float32) + delta, tau_min, tau_max)

    f0 = sample_rate / tau_refined
    periodicity = torch.clamp(1.0 - y1, 0.0, 1.0)
    return f0, periodicity
