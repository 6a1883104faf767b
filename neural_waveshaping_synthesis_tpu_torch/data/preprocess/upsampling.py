"""Frame-rate -> sample-rate interpolators on the host, in numpy (a copy of
the JAX package's ``data/preprocess/upsampling.py``, which imports no JAX;
the port keeps its own so that it imports nothing of that package).

Numerical contract with the reference ``data/utils/upsampling.py:20-79``
(signatures and gin names are the config surface; the shipped configs
leave ``interpolate_fn`` unset, so these are selected only by a binding
such as ``extract_f0_with_yin.interpolate_fn = @linear_interpolation``):
  * a frame grid of n values maps onto ``n*hop + window - hop`` padded
    samples, with frame i centered at its analysis window;
  * linear/cubic evaluate an interpolant of the frame values on that
    grid, then crop ``window//2`` leading samples to ``original_length``;
  * overlap-add turns each frame value into a windowed grain on the hop
    grid and center-crops.
"""
from typing import Optional

import numpy as np
import scipy.interpolate
import scipy.signal.windows

from ... import minigin as gin


def get_padded_length(frames: int, window_length: int, hop_length: int) -> int:
    return frames * hop_length + window_length - hop_length


def _evaluate_on_sample_grid(
    signal: np.ndarray, window_length: int, hop_length: int, kind: str
) -> np.ndarray:
    """Evaluate an interpolant of the frame values on the dense grid."""
    n = signal.size
    frame_x = np.linspace(0, n - 1, n)
    sample_x = np.linspace(0, n - 1, get_padded_length(n, window_length, hop_length))
    if kind == "linear":
        return np.interp(sample_x, frame_x, signal)
    return scipy.interpolate.interp1d(frame_x, signal, kind=kind)(sample_x)


def _crop_aligned(
    x: np.ndarray, lead: int, original_length: Optional[int]
) -> np.ndarray:
    return x[lead:][:original_length] if original_length else x


@gin.configurable
def linear_interpolation(
    signal: np.ndarray,
    window_length: int,
    hop_length: int,
    original_length: Optional[int] = None,
) -> np.ndarray:
    dense = _evaluate_on_sample_grid(signal, window_length, hop_length, "linear")
    return _crop_aligned(dense, window_length // 2, original_length)


@gin.configurable
def cubic_spline_interpolation(
    signal: np.ndarray,
    window_length: int,
    hop_length: int,
    original_length: Optional[int] = None,
) -> np.ndarray:
    dense = _evaluate_on_sample_grid(signal, window_length, hop_length, "cubic")
    return _crop_aligned(dense, window_length // 2, original_length)


@gin.configurable
def overlap_add_upsample(
    signal: np.ndarray,
    window_length: int,
    hop_length: int,
    window_fn: str = "hann",
    window_scale: int = 2,
    original_length: Optional[int] = None,
) -> np.ndarray:
    """Windowed OLA upsampling, vectorized: grain k of frame i lands on
    hop-block i+k, so the python loop runs over window_scale (tiny),
    not over frames."""
    window = scipy.signal.windows.get_window(window_fn, hop_length * window_scale)
    grains = signal[:, None] * window[None, :]  # (n, scale*hop)
    parts = grains.reshape(signal.size, window_scale, hop_length)
    blocks = np.zeros((signal.size + window_scale - 1, hop_length))
    for k in range(window_scale):
        blocks[k : k + signal.size] += parts[:, k]
    ola = blocks.reshape(-1)

    padded_length = get_padded_length(signal.size, window_length, hop_length)
    out = np.zeros(padded_length)
    out[: min(ola.size, padded_length)] = ola[:padded_length]
    lead = (padded_length - original_length) // 2 if original_length else 0
    return _crop_aligned(out, lead, original_length)
