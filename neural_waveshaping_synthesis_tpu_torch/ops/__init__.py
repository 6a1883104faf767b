"""DSP ops on tensors: the port's counterparts of the JAX ``ops`` modules
that synthesis, streaming and the training loss use."""
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
from .stft import frame_signal, istft, overlap_add, spectrogram_magnitude, stft
from .upsample import linear_upsample, segment_interp
from .windows import hann_window

__all__ = [
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
