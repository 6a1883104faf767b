"""F0 extraction on a clip (counterpart of the JAX
``data/preprocess/f0_extraction.py``): three gin-configurable extractors
with the same (f0, confidence) contract, each running on the audio's
device and returning tensors there (a numpy array lands on the CPU).

* ``extract_f0_with_crepe``: the reference's extractor, CREPE
  (``models/crepe.py``) with Viterbi decoding; it needs pretrained weights,
  a torchcrepe ``.pth`` or the JAX package's ``.npz`` cache, through
  ``weights_path`` or ``$CREPE_WEIGHTS``. The repo holds none.
* ``extract_f0_with_yin``: YIN, the dependency-free default.
* ``extract_f0_with_pyin``: probabilistic YIN with an HMM decode.

YIN and pYIN zero-pad the clip to the 32768-sample quantum and trim the
frames back to 1 + T // hop, as the JAX extractors do. ``interpolate_fn``
(one of ``upsampling.py``'s, numpy) runs on the host and its result goes
back to the audio's device.
"""
import os
from functools import lru_cache
from typing import Callable, Optional, Tuple

import torch

from ... import minigin as gin
from ...models import crepe as crepe_mod
from ...ops.f0 import pyin_f0, yin_f0
from .bucketing import pad_to_quantum

CREPE_WINDOW_LENGTH = 1024


def _interpolate(x: torch.Tensor, interpolate_fn: Callable, window: int, hop: int,
                 length: int) -> torch.Tensor:
    out = interpolate_fn(x.cpu().numpy(), window, hop, original_length=length)
    return torch.as_tensor(out, device=x.device)


@lru_cache(maxsize=4)
def _get_crepe(capacity: str, weights_path: Optional[str], device: str) -> crepe_mod.Crepe:
    if not weights_path:
        raise FileNotFoundError(
            "CREPE pretrained weights are required for "
            "extract_f0_with_crepe. Provide a torchcrepe .pth via the "
            "gin binding extract_f0_with_crepe.weights_path or the "
            "CREPE_WEIGHTS env var, or select @extract_f0_with_yin "
            "(or @extract_f0_with_pyin) as "
            "preprocess_audio.f0_extractor."
        )
    return crepe_mod.load_weights(weights_path, capacity).to(device)


@gin.configurable
def extract_f0_with_crepe(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    hop_length: int = 128,
    minimum_frequency: float = 50.0,
    maximum_frequency: float = 2000.0,
    full_model: bool = True,
    batch_size: int = 2048,
    weights_path: Optional[str] = None,
    decoder: str = "viterbi",
    interpolate_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T,) 16-kHz audio -> (f0, confidence), each (1 + T // hop,)."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    weights_path = weights_path or os.environ.get("CREPE_WEIGHTS")
    model = _get_crepe("full" if full_model else "tiny", weights_path, str(audio.device))
    f0, confidence = crepe_mod.predict(
        model, audio, sample_rate=sample_rate, hop_length=hop_length,
        fmin=minimum_frequency, fmax=maximum_frequency, batch_size=batch_size, decoder=decoder,
    )
    if interpolate_fn:
        n = audio.shape[-1]
        f0 = _interpolate(f0, interpolate_fn, CREPE_WINDOW_LENGTH, hop_length, n)
        confidence = _interpolate(confidence, interpolate_fn, CREPE_WINDOW_LENGTH, hop_length, n)
    return f0, confidence


@gin.configurable
def extract_f0_with_pyin(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    minimum_frequency: float = 65.0,
    maximum_frequency: float = 2093.0,
    frame_length: int = 1024,
    hop_length: int = 128,
    fill_na: Optional[float] = None,
    voicing_threshold: float = 0.5,
    beta_a: float = 2.0,
    beta_b: float = 18.0,
    interpolate_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probabilistic YIN (``ops.f0.pyin_f0``) -> (f0, periodicity). With
    ``fill_na`` set, f0 takes that value where the periodicity is below
    ``voicing_threshold`` (pYIN's unvoiced fill). Bindings on
    ``extract_f0_with_yin.*`` do not apply here."""
    padded, true_len = pad_to_quantum(torch.as_tensor(audio, dtype=torch.float32))
    n_frames = 1 + true_len // hop_length
    f0, periodicity = pyin_f0(
        padded, sample_rate=sample_rate, frame_length=frame_length, hop_length=hop_length,
        fmin=minimum_frequency, fmax=maximum_frequency, beta_a=beta_a, beta_b=beta_b,
    )
    f0, periodicity = f0[:n_frames], periodicity[:n_frames]
    if interpolate_fn:
        f0 = _interpolate(f0, interpolate_fn, frame_length, hop_length, true_len)
        periodicity = _interpolate(periodicity, interpolate_fn, frame_length, hop_length, true_len)
    if fill_na is not None:
        f0 = torch.where(periodicity < voicing_threshold,
                         torch.full_like(f0, float(fill_na)), f0)
    return f0, periodicity


@gin.configurable
def extract_f0_with_yin(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    hop_length: int = 128,
    frame_length: int = 1024,
    minimum_frequency: float = 50.0,
    maximum_frequency: float = 2000.0,
    threshold: float = 0.1,
    interpolate_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """YIN (``ops.f0.yin_f0``) -> (f0, periodicity), each (1 + T // hop,)."""
    padded, true_len = pad_to_quantum(torch.as_tensor(audio, dtype=torch.float32))
    n_frames = 1 + true_len // hop_length
    f0, periodicity = yin_f0(
        padded, sample_rate=sample_rate, frame_length=frame_length, hop_length=hop_length,
        fmin=minimum_frequency, fmax=maximum_frequency, threshold=threshold,
    )
    f0, periodicity = f0[..., :n_frames], periodicity[..., :n_frames]
    if interpolate_fn:
        f0 = _interpolate(f0, interpolate_fn, frame_length, hop_length, true_len)
        periodicity = _interpolate(periodicity, interpolate_fn, frame_length, hop_length, true_len)
    return f0, periodicity
