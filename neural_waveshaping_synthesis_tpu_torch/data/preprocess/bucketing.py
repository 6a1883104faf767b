"""Zero-padding of a clip before feature extraction (counterpart of the
JAX ``data/preprocess/bucketing.py``).

The JAX extractors pad every clip to a multiple of 32768 samples so that
a corpus compiles a handful of programs, and trim the frames back. The
padding is not neutral: the last frames' reflect padding sees zeros
instead of the clip's own tail. The port pads the same way, so that its
features are the JAX package's.
"""
from typing import Tuple

import torch
import torch.nn.functional as F

QUANTUM = 32768  # ~2 s at 16 kHz


def pad_to_quantum(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last axis up to a multiple of ``QUANTUM`` samples ->
    (padded, original length)."""
    t = x.shape[-1]
    pad = (-t) % QUANTUM
    return (F.pad(x, (0, pad)) if pad else x), t
