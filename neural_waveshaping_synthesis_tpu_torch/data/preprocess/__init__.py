"""Feature extraction for timbre transfer: audio loading, resampling, YIN
f0 and perceptual loudness, on the audio's device (counterpart of the
JAX ``data/preprocess`` package; CREPE, pYIN, MFCC, segmentation and
dataset creation are not ported yet)."""
from .bucketing import pad_to_quantum
from .f0_extraction import extract_f0_with_crepe, extract_f0_with_yin
from .loudness_extraction import extract_perceptual_loudness
from .preprocess_audio import (
    convert_to_float32_audio,
    load_mono_audio,
    make_monophonic,
    resample_audio,
)

__all__ = [
    "pad_to_quantum",
    "extract_f0_with_crepe",
    "extract_f0_with_yin",
    "extract_perceptual_loudness",
    "convert_to_float32_audio",
    "load_mono_audio",
    "make_monophonic",
    "resample_audio",
]
