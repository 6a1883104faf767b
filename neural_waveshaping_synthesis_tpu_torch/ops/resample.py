"""Polyphase Kaiser-windowed sinc resampling as framing + one matrix
product (counterpart of the JAX ``ops/resample.py``).

For a rational ratio up/down, output sample n = r + m*up (class r) reads
an input window that starts m*down samples in, at a class-specific
offset inside a window shared by all classes. So the whole resample is

    frames = frame_signal(x, window_len, hop=down)   # (..., M, window_len) view
    Y      = frames @ W.T                            # (..., M, up)
    y      = Y.reshape(..., M * up)[..., :out_len]

where row r of W holds class r's polyphase filter at its offset. The
prototype low-pass is a Kaiser-windowed sinc at cutoff min(1/up, 1/down)
of the upsampled Nyquist, designed on the host in float64 and cached.
The product is one ``torch.matmul`` (cuBLAS on the card), as the JAX
package leaves its einsum to XLA.
"""
import math
from fractions import Fraction
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stft import frame_signal


@lru_cache(maxsize=None)
def _design(up: int, down: int, num_zeros: int, beta: float) -> Tuple[np.ndarray, int, int]:
    """-> (W (up, window_len) float32, lo, window_len).

    W[r] is the filter for output class ``n = r (mod up)``, placed at the
    class's input offset within the shared window, which starts ``lo``
    samples from the frame's origin (lo <= 0)."""
    cutoff = min(1.0 / up, 1.0 / down)
    half_len = int(math.ceil(num_zeros / cutoff))
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n) * np.kaiser(len(n), beta) * up
    n_taps = len(taps)

    # y[n] = sum_j taps[n*down + half_len - j*up] * x[j]; for class r the
    # input offsets j - m*down that a tap reaches span [j_lo, j_hi] below
    lo = min(-(-(r * down + half_len - (n_taps - 1)) // up) for r in range(up))
    hi = max((r * down + half_len) // up for r in range(up))
    window_len = hi - lo + 1

    w = np.zeros((up, window_len), dtype=np.float64)
    for r in range(up):
        base = r * down + half_len
        j_lo = -(-(base - (n_taps - 1)) // up)
        for j in range(j_lo, base // up + 1):
            w[r, j - lo] = taps[base - j * up]
    return w.astype(np.float32), lo, window_len


@lru_cache(maxsize=None)
def _filter_on(device: torch.device, up: int, down: int, num_zeros: int, beta: float) -> torch.Tensor:
    """The design's W as a tensor on ``device``, copied there once."""
    return torch.from_numpy(_design(up, down, num_zeros, beta)[0]).to(device)


def resample_kaiser(
    audio: torch.Tensor,
    original_sr: float,
    target_sr: float,
    num_zeros: int = 32,
    beta: float = 14.0,
) -> torch.Tensor:
    """Resample ``(..., T)`` audio from original_sr to target_sr, on the
    audio's device. Output length floor(T * target / original), as
    resampy; the same rate returns the input."""
    if original_sr == target_sr:
        return audio
    frac = Fraction(int(round(target_sr)), int(round(original_sr)))
    up, down = frac.numerator, frac.denominator

    _, lo, window_len = _design(up, down, num_zeros, beta)
    t = audio.shape[-1]
    out_len = int(t * target_sr / original_sr)
    m = -(-out_len // up)  # frames needed

    # frame m starts at input index lo + m*down and needs window_len samples
    pad_left = max(0, -lo)
    needed = (m - 1) * down + window_len
    pad_right = max(0, needed + lo - t) + down
    x = F.pad(audio.to(torch.float32), (pad_left, pad_right))[..., lo + pad_left :]
    frames = frame_signal(x, window_len, down)[..., :m, :]
    y = torch.matmul(frames, _filter_on(audio.device, up, down, num_zeros, beta).T)  # (..., m, up)
    return y.reshape(*y.shape[:-2], m * up)[..., :out_len]
