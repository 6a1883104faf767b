"""MFCC extraction on a clip (counterpart of the JAX
``data/preprocess/mfcc_extraction.py``), gin-configurable, on the audio's
device: zero-pad to the 32768-sample quantum, ``ops.mel.mfcc``, trim to
1 + T // hop frames. Stored as control channels 3-18 for the shard
format; the model never reads them (a reference quirk)."""
import torch

from ... import minigin as gin
from ...ops.mel import mfcc as _mfcc_op
from .bucketing import pad_to_quantum


@gin.configurable
def extract_mfcc(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    n_fft: int = 1024,
    hop_length: int = 128,
    n_mfcc: int = 16,
) -> torch.Tensor:
    """(T,) audio -> (n_mfcc, 1 + T // hop_length) on its device."""
    padded, true_len = pad_to_quantum(torch.as_tensor(audio, dtype=torch.float32))
    coeffs = _mfcc_op(padded, sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length,
                      n_mfcc=n_mfcc)
    return coeffs[..., : 1 + true_len // hop_length]
