"""Offline preprocessing: wav -> features -> segments -> ``.npy`` shards
(counterpart of the JAX ``data/preprocess`` package, whose shard format
it writes). The feature extractors (CREPE, YIN and pYIN f0, loudness,
MFCC) and the resampler run on the audio's device; segmentation,
filtering, statistics and the split are numpy on the host. Timbre
transfer reuses the loading, resampling and extractors."""
from .bucketing import pad_to_quantum
from .create_dataset import create_dataset
from .f0_extraction import (
    extract_f0_with_crepe,
    extract_f0_with_pyin,
    extract_f0_with_yin,
)
from .loudness_extraction import extract_perceptual_loudness, extract_rms
from .mfcc_extraction import extract_mfcc
from .preprocess_audio import (
    convert_to_float32_audio,
    filter_segments,
    load_mono_audio,
    make_monophonic,
    preprocess_audio,
    preprocess_single_audio_file,
    resample_audio,
    segment_signal,
)
from .upsampling import (
    cubic_spline_interpolation,
    linear_interpolation,
    overlap_add_upsample,
)

__all__ = [
    "pad_to_quantum",
    "extract_f0_with_crepe",
    "extract_f0_with_pyin",
    "extract_f0_with_yin",
    "extract_perceptual_loudness",
    "extract_rms",
    "extract_mfcc",
    "convert_to_float32_audio",
    "load_mono_audio",
    "make_monophonic",
    "resample_audio",
    "preprocess_audio",
    "preprocess_single_audio_file",
    "segment_signal",
    "filter_segments",
    "create_dataset",
    "linear_interpolation",
    "cubic_spline_interpolation",
    "overlap_add_upsample",
]
