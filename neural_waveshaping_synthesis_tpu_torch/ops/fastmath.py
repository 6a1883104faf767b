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

Gradients are the JAX package's custom ones: d fast_sin = fast_cos and
d fast_cos = -fast_sin (``torch.autograd.Function``s that save only the
input), not autograd through the polynomial.
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


def _sin_poly(x: torch.Tensor) -> torch.Tensor:
    r = _reduce(x)
    return r * _horner(r * r, _SIN_ODD_COEFFS)


def _cos_poly(x: torch.Tensor) -> torch.Tensor:
    r = _reduce(x)
    return _horner(r * r, _COS_EVEN_COEFFS)


class _FastSin(torch.autograd.Function):
    """d fast_sin = fast_cos: the JAX ``custom_jvp``. Autograd through the
    Horner chain would differentiate the polynomial and ``round`` instead
    (up to ~9e-7 away) and keep every intermediate; this saves ``x`` only."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sin_poly(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _FastCos.apply(x) * g


class _FastCos(torch.autograd.Function):
    """d fast_cos = -fast_sin, as in JAX."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _cos_poly(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return -_FastSin.apply(x) * g


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Polynomial sine for float32 (and narrower); float64 takes
    ``torch.sin``. Its gradient is :func:`fast_cos`."""
    if x.dtype == torch.float64:
        return torch.sin(x)
    return _FastSin.apply(x)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """Polynomial cosine; float64 takes ``torch.cos`` (see :func:`fast_sin`).
    Its gradient is ``-fast_sin``."""
    if x.dtype == torch.float64:
        return torch.cos(x)
    return _FastCos.apply(x)
