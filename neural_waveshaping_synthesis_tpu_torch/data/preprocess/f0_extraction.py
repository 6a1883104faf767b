"""F0 extraction on a clip (counterpart of the JAX
``data/preprocess/f0_extraction.py``).

* ``extract_f0_with_yin``: zero-pad to the 32768-sample quantum, run
  ``ops.f0.yin_f0`` (16 kHz, frames of 1024 hopped by 128, 50 Hz up,
  threshold 0.1: the reference's settings) on the audio's device, trim to
  1 + T // 128 frames.
* ``extract_f0_with_crepe`` raises: the CREPE network
  (``models/crepe.py``) is not ported, and the repo holds no pretrained
  weights for it. pYIN is not ported either.
"""
from typing import Tuple

import torch

from ...ops.f0 import yin_f0
from .bucketing import pad_to_quantum


def extract_f0_with_crepe(*args, **kwargs):
    raise NotImplementedError(
        "the CREPE extractor is not ported (models/crepe.py, ROADMAP.md queue 1, "
        "Preprocessing); use f0_extractor='yin'"
    )


def extract_f0_with_yin(
    audio: torch.Tensor, maximum_frequency: float = 2000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T,) audio on any device -> (f0 Hz, periodicity), each
    (1 + T // 128,), on that device."""
    padded, true_len = pad_to_quantum(torch.as_tensor(audio, dtype=torch.float32))
    f0, periodicity = yin_f0(padded, fmax=maximum_frequency)
    n_frames = 1 + true_len // 128
    return f0[..., :n_frames], periodicity[..., :n_frames]
