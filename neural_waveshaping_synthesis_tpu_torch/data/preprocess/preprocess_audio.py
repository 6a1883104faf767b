"""Audio loading and resampling (counterpart of the JAX
``data/preprocess/preprocess_audio.py``; segmentation and dataset
creation are not ported yet).

* integer PCM scales to [-1, 1] by the dtype's positive max;
* stereo collapses by keep_left / keep_right / sum (mean) / diff, and
  whichever axis is 2 long is the channel axis;
* resampling is ``ops.resample.resample_kaiser`` on the audio's device.
"""
from typing import Tuple, Union

import numpy as np
import torch
from scipy.io import wavfile

from ...ops.resample import resample_kaiser


def convert_to_float32_audio(audio: np.ndarray) -> np.ndarray:
    """PCM int -> [-1, 1] float32 by the dtype's positive max; float input
    passes through (cast to float32)."""
    if np.issubdtype(audio.dtype, np.floating):
        return audio.astype(np.float32, copy=False)
    return audio.astype(np.float32) / np.iinfo(audio.dtype).max


_DOWNMIX = {
    "keep_left": lambda ch: ch[0],
    "keep_right": lambda ch: ch[1],
    "sum": lambda ch: ch.mean(axis=0),
    "diff": lambda ch: ch[0] - ch[1],
}


def make_monophonic(audio: np.ndarray, strategy: str = "keep_left") -> np.ndarray:
    """Collapse mono or stereo audio, in either orientation, to 1-D."""
    if audio.ndim == 1:
        return audio
    if audio.ndim != 2:
        raise ValueError(f"audio must be 1-D or 2-D, got shape {audio.shape}")
    if 1 in audio.shape:  # one channel stored 2-D
        return audio.reshape(-1)
    if audio.shape[1] == 2:  # time-major stereo -> channel-major
        audio = audio.T
    if audio.shape[0] != 2:
        raise ValueError(f"expected mono or stereo audio, got {min(audio.shape)} channels")
    if strategy not in _DOWNMIX:
        raise ValueError(f"unknown downmix strategy {strategy!r}")
    return _DOWNMIX[strategy](audio)


def load_mono_audio(path: str, strategy: str = "keep_left") -> Tuple[int, np.ndarray]:
    """wav file -> (its sample rate, mono float32 signal)."""
    sr, raw = wavfile.read(path)
    return sr, make_monophonic(convert_to_float32_audio(raw), strategy)


def resample_audio(
    audio: Union[np.ndarray, torch.Tensor], original_sr: float, target_sr: float
) -> torch.Tensor:
    """(T,) audio -> (floor(T * target / original),) float32 on the audio's
    device (a numpy array lands on the CPU). The JAX version pads to a
    length bucket for its compiler; the padding only appends zeros past
    the end, so the port resamples the clip as it is."""
    return resample_kaiser(torch.as_tensor(audio, dtype=torch.float32), original_sr, target_sr)
