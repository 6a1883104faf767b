"""YIN and probabilistic YIN fundamental-frequency estimation
(counterpart of the JAX ``ops/f0.py``: ``yin_f0``, ``pyin_f0``).

Every frame's difference function is computed at once through a batched
FFT autocorrelation, on the audio's device. Returns (f0, periodicity) per
frame, the (f0, confidence) contract of the CREPE extractor.

PyTorch has no regularised incomplete beta function (``torch.special``
stops at ``gammainc``), which pYIN's threshold prior needs: :func:`betainc`
is the port's own, a continued fraction in float64.
"""
import math
from typing import Tuple

import numpy as np
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


_BETAINC_EPS = 1e-14  # the continued fraction's relative step at convergence
_BETAINC_TINY = 1e-300
_BETAINC_MAX_TERMS = 2000
_BETAINC_CHECK_EVERY = 8  # terms between convergence checks (one host sync each)


def betainc(a: float, b: float, x: torch.Tensor) -> torch.Tensor:
    """Regularised incomplete beta function I_x(a, b) of ``x`` in [0, 1]
    for scalar a, b > 0, in float64 on ``x``'s device (the CDF of
    Beta(a, b); ``scipy.special.betainc(a, b, x)``).

    The continued fraction of Numerical Recipes' ``betacf``, evaluated by
    the modified Lentz method, on the side where it converges fast: for
    x > (a + 1) / (a + b + 2) it computes 1 - I_{1-x}(b, a). Terms are
    added until every element's last step changes it by less than 1e-14."""
    if not (a > 0 and b > 0):
        raise ValueError(f"betainc needs a, b > 0, got {a}, {b}")
    x = x.to(torch.float64)
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, torch.full_like(x, b), torch.full_like(x, a))
    q = torch.where(swap, torch.full_like(x, a), torch.full_like(x, b))
    z = torch.clamp(torch.where(swap, 1.0 - x, x), 0.0, 1.0)

    def guard(v):
        return torch.where(torch.abs(v) < _BETAINC_TINY, torch.full_like(v, _BETAINC_TINY), v)

    c = torch.ones_like(z)
    d = 1.0 / guard(1.0 - (p + q) * z / (p + 1.0))
    h = d.clone()
    for m in range(1, _BETAINC_MAX_TERMS + 1):
        m2 = 2.0 * m
        even = m * (q - m) * z / ((p - 1.0 + m2) * (p + m2))
        d = 1.0 / guard(1.0 + even * d)
        c = guard(1.0 + even / c)
        h = h * d * c
        odd = -(p + m) * (p + q + m) * z / ((p + m2) * (p + 1.0 + m2))
        d = 1.0 / guard(1.0 + odd * d)
        c = guard(1.0 + odd / c)
        step = d * c
        h = h * step
        if m % _BETAINC_CHECK_EVERY == 0 and bool((torch.abs(step - 1.0) < _BETAINC_EPS).all()):
            break
    else:
        raise RuntimeError(f"betainc({a}, {b}) did not converge in {_BETAINC_MAX_TERMS} terms")
    log_beta = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    front = torch.exp(log_beta + p * torch.log(z) + q * torch.log1p(-z)) / p
    out = front * h
    out = torch.where(swap, 1.0 - out, out)
    return torch.where(x <= 0.0, torch.zeros_like(out), torch.where(x >= 1.0, torch.ones_like(out), out))


def pyin_f0(
    audio: torch.Tensor,
    sample_rate: float = 16000.0,
    frame_length: int = 1024,
    hop_length: int = 128,
    fmin: float = 65.0,
    fmax: float = 2000.0,
    beta_a: float = 2.0,
    beta_b: float = 18.0,
    viterbi_window: int = 12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probabilistic YIN (Mauch & Dixon) of 1-D audio -> (f0 Hz,
    periodicity), each (1 + T // hop,), on the audio's device.

    The candidates are the troughs of d' over integer lags. YIN's
    absolute-threshold rule picks the first lag whose d' dips below a
    threshold theta; with a Beta(a, b) prior on theta, a trough at lag L
    is the pick exactly when d'(L) < theta <= (the least d' of the
    troughs at smaller lags), so its mass is CDF(prefix min) - CDF(d'(L)).
    The lags' masses are summed onto the 360-bin 20-cent CREPE grid (a
    one-hot product built on the host), decoded by Viterbi, and the f0
    refined by a parabola through d' around the lag nearest the decoded
    bin. Periodicity is 1 - d' at that lag. See the JAX function for the
    accuracy it reaches on synthetic ground truth."""
    from ..models.crepe import N_BINS, bins_to_cents, cents_to_frequency, viterbi_decode

    padded = _reflect_pad(audio, frame_length // 2)
    frames = frame_signal(padded, frame_length, hop_length)  # (F, W)

    tau_min = max(int(sample_rate / fmax), 2)
    tau_max = min(int(sample_rate / fmin) + 1, frame_length - 2)
    cm = _cmndf(_difference_function(frames, tau_max + 2))  # (F, tau_max + 2)

    # troughs of d'; every other lag is +inf: no mass, no effect on the
    # running minimum
    center = cm[:, tau_min : tau_max + 1]
    left = cm[:, tau_min - 1 : tau_max]
    right = cm[:, tau_min + 1 : tau_max + 2]
    inf = torch.tensor(float("inf"), device=audio.device)
    cand = torch.where((center <= left) & (center < right), center, inf)
    prefix_min = torch.cat([inf.expand_as(cand[:, :1]), torch.cummin(cand, dim=1).values[:, :-1]], dim=1)
    cdf = betainc(beta_a, beta_b, torch.clamp(torch.stack([prefix_min, cand]), 0.0, 1.0))
    cdf = cdf.to(torch.float32)
    mass = torch.clamp(cdf[0] - cdf[1], min=0.0)  # (F, n_lags)

    # the lags' bins on the 20-cent grid, a one-hot (n_lags, 360) product
    lag_freqs = sample_rate / np.arange(tau_min, tau_max + 1)
    lag_bins = np.clip(
        np.round((1200.0 * np.log2(lag_freqs / 10.0) - 1997.3794084376191) / 20.0).astype(np.int64),
        0, N_BINS - 1)
    onehot = np.zeros((lag_bins.shape[0], N_BINS), np.float32)
    onehot[np.arange(lag_bins.shape[0]), lag_bins] = 1.0
    probs = torch.matmul(mass, torch.from_numpy(onehot).to(audio.device))

    bins = viterbi_decode(probs, window=viterbi_window)

    # parabolic refinement of d' around the lag nearest the decoded bin
    bin_freq = cents_to_frequency(bins_to_cents(bins.to(torch.float32)))
    bin_lag = torch.clamp(torch.round(sample_rate / bin_freq).to(torch.int64), tau_min, tau_max)

    def at(lag):
        return torch.gather(cm, -1, lag[:, None])[:, 0]

    y0, y1, y2 = at(bin_lag - 1), at(bin_lag), at(bin_lag + 1)
    denom = y0 - 2.0 * y1 + y2
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (y0 - y2) / safe, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    f0 = sample_rate / (bin_lag.to(torch.float32) + delta)
    periodicity = torch.clamp(1.0 - y1, 0.0, 1.0)
    return f0, periodicity
