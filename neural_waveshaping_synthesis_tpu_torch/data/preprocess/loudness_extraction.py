"""Loudness extraction on a clip (counterpart of the JAX
``data/preprocess/loudness_extraction.py``), gin-configurable, on the
audio's device.

``extract_perceptual_loudness`` zero-pads the clip to the 32768-sample
quantum, computes ``ops.loudness.extract_perceptual_loudness`` and trims
to 1 + T // hop frames. The defaults (2048 / 512) are the reference's;
the data gin file and timbre transfer ask for 1024 / 128. The reference's
A-weighting quirk (the curve computed but never added) is kept by
``apply_a_weighting=False``. ``extract_rms`` frames the clip as it is, as
JAX's does. ``interpolate_fn`` runs on the host (numpy) and its result
goes back to the audio's device.
"""
from typing import Callable, Optional

import torch

from ... import minigin as gin
from ...ops.loudness import extract_perceptual_loudness as _loudness_op
from ...ops.loudness import extract_rms as _rms_op
from .bucketing import pad_to_quantum
from .f0_extraction import _interpolate


@gin.configurable
def extract_perceptual_loudness(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    epsilon: float = 1e-5,
    normalise: bool = True,
    apply_a_weighting: bool = False,
    interpolate_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """(T,) audio -> (1 + T // hop_length,) loudness on its device."""
    padded, true_len = pad_to_quantum(torch.as_tensor(audio, dtype=torch.float32))
    loudness = _loudness_op(
        padded, sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length, epsilon=epsilon,
        normalise=normalise, apply_a_weighting=apply_a_weighting,
    )[..., : 1 + true_len // hop_length]
    if interpolate_fn:
        loudness = _interpolate(loudness, interpolate_fn, n_fft, hop_length, true_len)
    return loudness


@gin.configurable
def extract_rms(
    audio: torch.Tensor,
    window_size: int = 2048,
    hop_length: int = 512,
    sample_rate: Optional[float] = 16000.0,
    interpolate_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """(T,) audio -> centred frame RMS, (1 + T // hop_length,). ``sample_rate``
    is taken for the reference's signature and not used."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    root = _rms_op(audio, window_size, hop_length)
    if interpolate_fn:
        root = _interpolate(root, interpolate_fn, window_size, hop_length, audio.shape[-1])
    return root
