"""Signal generators: harmonic exciter, FIR noise synth, learned reverb
(counterpart of the JAX ``models/generators.py``)."""
from typing import Optional

import torch
import torch.nn as nn

from .. import minigin as gin
from ..ops.fir import fft_convolve_circular, fir_noise_filter
from ..ops.oscillator import final_phase, harmonic_oscillator_bank
from .modules import Params, _load


@gin.configurable
class HarmonicOscillator(nn.Module):
    """Antialiased sinusoidal harmonic bank."""

    def __init__(self, n_harmonics: int = 101, sample_rate: float = 16000):
        super().__init__()
        self.n_harmonics, self.sample_rate = n_harmonics, sample_rate

    def forward(
        self,
        f0: torch.Tensor,
        phase_offset: Optional[torch.Tensor] = None,
        initial_phase: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, T) audio-rate f0 in Hz -> (B, T, n_harmonics); a stream
        passes its carried (B,) phase as ``initial_phase``."""
        return harmonic_oscillator_bank(
            f0, self.n_harmonics, self.sample_rate, phase_offset, initial_phase
        )

    def carry_phase(
        self, f0: torch.Tensor, initial_phase: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The (B,) float64 phase carry after this buffer of f0."""
        return final_phase(f0, self.sample_rate, initial_phase)


@gin.configurable
class FIRNoiseSynth(nn.Module):
    """Time-varying windowed-FIR filtered noise."""

    def __init__(self, ir_length: int = 256, hop_length: int = 128):
        super().__init__()
        self.ir_length, self.hop_length = ir_length, hop_length

    def forward(
        self,
        h_re: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, n_frames, ir_length//2+1) magnitude response -> (B, hop*n_frames)."""
        return fir_noise_filter(h_re, self.hop_length, generator, noise)


@gin.configurable
class Reverb(nn.Module):
    """Learned impulse-response reverb with a pinned leading zero.

    The IR parameter has sr*length-1 samples (randn*1e-6 at init); a
    constant zero is prepended at apply time so the dry signal's first
    sample passes untouched. The convolution is CIRCULAR at
    max(len(x), len(ir)), the reference's wrap-around quirk."""

    def __init__(self, length_in_seconds: int = 2, sr: int = 16000, generator=None):
        super().__init__()
        n = sr * length_in_seconds - 1
        self.ir = nn.Parameter(torch.randn(n, generator=generator) * 1e-6)

    def params(self) -> Params:
        return {"ir": self.ir}

    def load_params(self, p: Params) -> None:
        _load(self.ir, p["ir"])

    def impulse_response(self) -> torch.Tensor:
        return torch.cat([self.ir.new_zeros(1), self.ir])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T): dry + circular FFT convolution with the IR."""
        return x + fft_convolve_circular(x, self.impulse_response())
