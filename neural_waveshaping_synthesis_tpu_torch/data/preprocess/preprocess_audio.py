"""Per-file preprocessing: wav -> mono float32 16 kHz -> control features
-> confidence-filtered segment stacks (counterpart of the JAX
``data/preprocess/preprocess_audio.py``, after the reference
``data/utils/preprocess_audio.py:16-237``).

* integer PCM scales to [-1, 1] by the dtype's positive max;
* stereo collapses by keep_left / keep_right / sum (mean) / diff, and
  whichever axis is 2 long is the channel axis;
* optional corpus-peak normalisation is a separate first pass over the
  raw (pre-resample) audio;
* resampling (``ops.resample.resample_kaiser``) and the features (f0 and
  confidence, loudness, MFCC, on the 125-Hz control grid) run on
  ``device``: the card unless the caller passes ``device="cpu"``;
* segmentation and the confidence filter are numpy on the host, as in
  JAX: windows of ``segment_length_in_seconds`` hopped by
  ``hop_length_in_seconds``; a segment survives iff its mean confidence
  exceeds the threshold.
"""
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from scipy.io import wavfile

from ... import minigin as gin
from ...device import resolve_device
from ...ops.resample import resample_kaiser
from .f0_extraction import extract_f0_with_crepe
from .loudness_extraction import extract_perceptual_loudness
from .mfcc_extraction import extract_mfcc


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


# -- segmentation -------------------------------------------------------------

def segment_signal(
    signal: np.ndarray,
    sample_rate: float,
    segment_length_in_seconds: float,
    hop_length_in_seconds: float,
) -> np.ndarray:
    """Frame along the last axis -> (..., segment_len, n_segments)."""
    seg = int(sample_rate * segment_length_in_seconds)
    hop = int(sample_rate * hop_length_in_seconds)
    t = signal.shape[-1]
    n = 1 + (t - seg) // hop if t >= seg else 0
    if n <= 0:
        return np.zeros(signal.shape[:-1] + (seg, 0), signal.dtype)
    idx = np.arange(seg)[:, None] + hop * np.arange(n)[None, :]
    return signal[..., idx]


def filter_segments(threshold: float, key_segments: np.ndarray, segments):
    """Keep segments whose mean key (confidence) exceeds threshold.
    key_segments: (seg_len, n); the segment axis is last, so 2-D streams
    mask on axis 1 and 3-D (MFCC) on axis 2."""
    mask = key_segments.mean(axis=0) > threshold
    return [x[..., mask] for x in segments]


# -- per-file pipeline ----------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def preprocess_single_audio_file(
    file: str,
    control_decimation_factor: float,
    target_sr: float = 16000.0,
    segment_length_in_seconds: float = 4.0,
    hop_length_in_seconds: float = 2.0,
    confidence_threshold: float = 0.85,
    f0_extractor: Callable = extract_f0_with_crepe,
    loudness_extractor: Callable = extract_perceptual_loudness,
    mfcc_extractor: Callable = extract_mfcc,
    normalisation_factor: Optional[float] = None,
    verbose: bool = True,
    device="cuda",
):
    """One wav -> (audio, f0, confidence, loudness, mfcc) segment stacks,
    numpy, each on a LEADING segment axis: audio (n, seg_samples), the
    control streams (n, seg_frames), mfcc (n, 16, seg_frames); n may be 0
    when every window fails the confidence filter. The features are
    computed on ``device``."""
    if verbose:
        print(f"[preprocess] {file}")
    sr, audio = load_mono_audio(file)
    if normalisation_factor:
        audio = audio / normalisation_factor
    x = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32)).to(resolve_device(device))
    if sr != target_sr:
        x = resample_audio(x, sr, target_sr)

    f0, confidence = f0_extractor(x)
    control_sr = target_sr / (control_decimation_factor or 1)

    # (signal, rate) in the output order of the 5-tuple
    streams = (
        (x, target_sr),
        (f0, control_sr),
        (confidence, control_sr),
        (loudness_extractor(x), control_sr),
        (mfcc_extractor(x), control_sr),
    )
    windows = [
        segment_signal(_host(s), rate, segment_length_in_seconds, hop_length_in_seconds)
        for s, rate in streams
    ]
    keep = windows[2].mean(axis=0) > confidence_threshold
    if verbose and not keep.any():
        print("[preprocess]   no segments above confidence threshold")
    # trailing segment axis -> leading, filtered
    return tuple(np.moveaxis(w[..., keep], -1, 0) for w in windows)


def _corpus_peak(files, verbose: bool) -> float:
    """Max |sample| over the raw mono corpus (normalise_audio's first pass)."""
    peak = 0.0
    for file in files:
        _, audio = load_mono_audio(file)
        peak = max(peak, float(np.abs(audio).max()))
    if verbose:
        print(f"[preprocess] corpus peak over {len(files)} files: {peak:.4f}")
    return peak


@gin.configurable
def preprocess_audio(
    files: list,
    control_decimation_factor: float = 128,
    target_sr: float = 16000,
    segment_length_in_seconds: float = 4.0,
    hop_length_in_seconds: float = 2.0,
    confidence_threshold: float = 0.85,
    f0_extractor: Callable = extract_f0_with_crepe,
    loudness_extractor: Callable = extract_perceptual_loudness,
    normalise_audio: bool = False,
    verbose: bool = True,
    device="cuda",
):
    """Generator of per-file segment stacks (see
    ``preprocess_single_audio_file`` for the layout), the features
    computed on ``device``."""
    norm = _corpus_peak(files, verbose) if normalise_audio else None
    for file in files:
        yield preprocess_single_audio_file(
            file,
            control_decimation_factor=control_decimation_factor,
            target_sr=target_sr,
            segment_length_in_seconds=segment_length_in_seconds,
            hop_length_in_seconds=hop_length_in_seconds,
            confidence_threshold=confidence_threshold,
            f0_extractor=f0_extractor,
            loudness_extractor=loudness_extractor,
            normalisation_factor=norm,
            verbose=verbose,
            device=device,
        )
