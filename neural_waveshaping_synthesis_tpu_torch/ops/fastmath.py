"""Polynomial sine/cosine (counterpart of the JAX ``ops/fastmath.py``).

One round-to-nearest-even period reduction ``x - TAU*round(x/TAU)`` and
an odd (sine) / even (cosine) polynomial on [-pi, pi]. The coefficients
are the JAX package's f64 Chebyshev-node least-squares fits, copied
verbatim; evaluated in float32 they round exactly as the JAX code's
weak-typed Python constants do. ``torch.round`` rounds half to even, as
``jnp.round`` does (the CUDA kernel uses ``rintf`` for the same reason).

Max absolute error against exact sine: 1.2e-9 for the polynomial on
[-pi, pi]; in float32 about 6e-7 for shaper-sized arguments (~N(0, 3))
and 1.8e-4 at the oscillator's wrapped-phase bound tau*101, where f32's
representation of the argument already carries that much.

float64 inputs take exact ``torch.sin``/``torch.cos``: the polynomial's
fit error would dominate f64 precision.
"""
import math

import torch

TAU = 2.0 * math.pi
_INV_TAU = 1.0 / TAU

_SIN_ODD_COEFFS = (
    0.9999999944601012,
    -0.16666664569899559,
    0.008333310293322599,
    -0.0001984015186074305,
    2.7529394880216866e-06,
    -2.4676487473365142e-08,
    1.344997356671708e-10,
)
_COS_EVEN_COEFFS = (
    1.0000000001125011,
    -0.49999999861565086,
    0.041666663506715884,
    -0.0013888863097880472,
    2.4800554530106417e-05,
    -2.7534810390540134e-07,
    2.060362708310104e-09,
    -9.7225364605847e-12,
)


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """Range-reduce to [-pi, pi] (round half to even, then one multiply-add)."""
    return x - TAU * torch.round(x * _INV_TAU)


def _horner(s: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(s, coeffs[-1])
    for c in coeffs[-2::-1]:
        p = p * s + c
    return p


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Polynomial sine for float32 (and narrower); float64 takes ``torch.sin``."""
    if x.dtype == torch.float64:
        return torch.sin(x)
    r = _reduce(x)
    return r * _horner(r * r, _SIN_ODD_COEFFS)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """Polynomial cosine; float64 takes ``torch.cos`` (see :func:`fast_sin`)."""
    if x.dtype == torch.float64:
        return torch.cos(x)
    r = _reduce(x)
    return _horner(r * r, _COS_EVEN_COEFFS)
