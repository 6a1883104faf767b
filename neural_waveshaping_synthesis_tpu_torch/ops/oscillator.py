"""Harmonic oscillator bank (counterpart of the JAX ``ops/oscillator.py``).

Layout: ``f0`` is ``(B, T)`` audio-rate Hz; the bank is channels-last
``(B, T, H)``, ready for the H -> 64 harmonic mixer.
"""
import math
from typing import Optional

import torch

from .fastmath import fast_sin

TAU = 2.0 * math.pi


def phase_accumulate(f0: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Integrated phase in radians, ``tau * cumsum(f0) / sr`` along the
    last axis, returned in float64.

    The first sample already advances by f0[0]/sr, as in the reference
    recursion. The sum runs in float64: a float32 cumulative sum reduces
    in a different order on the card than on the CPU (and in JAX), and
    at audio rate the f32 sums of a few seconds of f0 differ by whole
    Hz-samples — tenths of a radian at the upper harmonics. The f64 sum
    agrees across devices to float32 rounding once :func:`bank_from_phase`
    wraps it to [0, tau)."""
    return TAU * torch.cumsum(f0.to(torch.float64), dim=-1) / sample_rate


def draw_phase_offset(
    n_harmonics: int,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The reference's fresh per-forward phase draw: uniform [-pi, pi),
    one offset per harmonic, shared across the batch.

    Drawn on the generator's own device (the default generator's when
    ``generator`` is None), then moved to ``device``: a CPU generator
    gives the same offsets whichever device renders."""
    gen_device = generator.device if generator is not None else None
    u = torch.rand(n_harmonics, generator=generator, device=gen_device, dtype=dtype)
    return (u * TAU - math.pi).to(device)


def wrap_phase(phase: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An integrated phase track wrapped to [0, tau), then cast to
    ``dtype``: the phase :func:`bank_from_phase` expands."""
    return torch.remainder(phase, TAU).to(dtype)


def bank_from_wrapped_phase(
    phase: torch.Tensor,
    f0: torch.Tensor,
    n_harmonics: int,
    sample_rate: float,
    phase_offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`bank_from_phase` from a phase already wrapped to [0, tau)
    in f0's dtype (:func:`wrap_phase`): what the exciter-fused kernels
    compute per sample (``kernels/newt_fused.py``)."""
    k = torch.arange(1, n_harmonics + 1, dtype=f0.dtype, device=f0.device)
    if phase_offset is None:
        phase_offset = torch.zeros(n_harmonics, dtype=f0.dtype, device=f0.device)
    if phase_offset.dim() == 1:
        phase_offset = phase_offset[None, None, :]
    else:
        phase_offset = phase_offset[:, None, :]
    harmonic_phase = phase[..., None] * k + phase_offset
    antialias = (f0[..., None] * k) < (sample_rate / 2.0)
    return fast_sin(harmonic_phase) * antialias.to(f0.dtype)


def bank_from_phase(
    phase: torch.Tensor,
    f0: torch.Tensor,
    n_harmonics: int,
    sample_rate: float,
    phase_offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Antialiased harmonic bank from an already-integrated phase track.

    Args: phase (B, T) radians (any float dtype); f0 (B, T) Hz, whose
    dtype the bank takes; phase_offset (H,) or (B, H), zeros if None.
    Returns (B, T, H) with the harmonics at or above Nyquist zeroed.

    The phase is wrapped mod tau BEFORE the harmonic expansion: k is an
    integer, so sin(k*(phi mod tau) + o) == sin(k*phi + o), while the
    argument stays below tau*H instead of growing with clip length."""
    return bank_from_wrapped_phase(
        wrap_phase(phase, f0.dtype), f0, n_harmonics, sample_rate, phase_offset
    )


def harmonic_oscillator_bank(
    f0: torch.Tensor,
    n_harmonics: int,
    sample_rate: float,
    phase_offset: Optional[torch.Tensor] = None,
    initial_phase: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T) audio-rate f0 in Hz -> (B, T, H) antialiased sinusoids.

    ``initial_phase``: (B,) carried phase accumulator for streaming
    (:func:`final_phase` of the previous buffer), added to the integrated
    phase in float64."""
    phase = phase_accumulate(f0, sample_rate)
    if initial_phase is not None:
        phase = phase + initial_phase.to(torch.float64)[:, None]
    return bank_from_phase(phase, f0, n_harmonics, sample_rate, phase_offset)


def final_phase(
    f0: torch.Tensor, sample_rate: float, initial_phase: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The phase accumulator after the last sample of (B, T) f0, wrapped to
    [0, tau): the carry of a stream, (B,) float64.

    JAX keeps this carry in float32; the port sums and carries it in
    float64 (as :func:`phase_accumulate`), so a stream on the card and on
    the CPU keep the same phase however long they run."""
    total = TAU * torch.sum(f0.to(torch.float64), dim=-1) / sample_rate
    if initial_phase is not None:
        total = total + initial_phase.to(torch.float64)
    return torch.remainder(total, TAU)
