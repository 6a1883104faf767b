"""Loudness extraction on a clip (counterpart of the JAX
``data/preprocess/loudness_extraction.py``): zero-pad to the 32768-sample
quantum, compute ``ops.loudness.extract_perceptual_loudness``, trim to
1 + T // hop frames. The defaults (2048 / 512) are the reference's;
timbre transfer asks for 1024 / 128. The op's other settings keep their
defaults: 16 kHz, normalised, no A-weighting (as the reference)."""
import torch

from ...ops.loudness import extract_perceptual_loudness as _loudness_op
from .bucketing import pad_to_quantum


def extract_perceptual_loudness(
    audio: torch.Tensor, n_fft: int = 2048, hop_length: int = 512
) -> torch.Tensor:
    """(T,) audio on any device -> (1 + T // hop_length,) loudness there."""
    padded, true_len = pad_to_quantum(torch.as_tensor(audio, dtype=torch.float32))
    loudness = _loudness_op(padded, n_fft=n_fft, hop_length=hop_length)
    return loudness[..., : 1 + true_len // hop_length]
