"""DSP ops on tensors: the port's counterparts of the JAX ``ops`` modules
that synthesis, streaming, the training loss and preprocessing use."""
from .f0 import betainc, pyin_f0, yin_f0
from .fastmath import fast_cos, fast_sin
from .fir import (
    fft_convolve_circular,
    fft_convolve_full,
    fir_noise_filter,
    partition_ir_spectra,
    partitioned_convolve_step,
    windowed_fir_from_magnitude,
)
from .oscillator import (
    bank_from_phase,
    bank_from_wrapped_phase,
    draw_phase_offset,
    final_phase,
    harmonic_oscillator_bank,
    phase_accumulate,
    wrap_phase,
)
from .mel import dct_ii, mel_filterbank, mfcc, power_to_db
from .stft import frame_signal, istft, overlap_add, spectrogram_magnitude, stft
from .upsample import cubic_upsample, linear_upsample, overlap_add_upsample, segment_interp
from .windows import hann_window

__all__ = [
    "betainc",
    "pyin_f0",
    "yin_f0",
    "dct_ii",
    "mel_filterbank",
    "mfcc",
    "power_to_db",
    "cubic_upsample",
    "overlap_add_upsample",
    "fast_sin",
    "fast_cos",
    "fft_convolve_circular",
    "fft_convolve_full",
    "fir_noise_filter",
    "partition_ir_spectra",
    "partitioned_convolve_step",
    "windowed_fir_from_magnitude",
    "bank_from_phase",
    "draw_phase_offset",
    "final_phase",
    "harmonic_oscillator_bank",
    "phase_accumulate",
    "bank_from_wrapped_phase",
    "wrap_phase",
    "frame_signal",
    "istft",
    "overlap_add",
    "spectrogram_magnitude",
    "stft",
    "linear_upsample",
    "segment_interp",
    "hann_window",
]
