"""The port's DSP ops against the JAX package's, on the same numpy inputs.

Tolerances are stated per test; "bit-exact" means assert_array_equal.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.ops import fastmath as jfm
from neural_waveshaping_synthesis_tpu.ops import fir as jfir
from neural_waveshaping_synthesis_tpu.ops import oscillator as josc
from neural_waveshaping_synthesis_tpu.ops.stft import istft as j_istft, stft as j_stft
from neural_waveshaping_synthesis_tpu.ops.upsample import linear_upsample as j_linear_upsample
from neural_waveshaping_synthesis_tpu.ops.windows import hann_window as j_hann_window
from neural_waveshaping_synthesis_tpu_torch.ops import (
    bank_from_phase,
    draw_phase_offset,
    fast_cos,
    fast_sin,
    fft_convolve_circular,
    fir_noise_filter,
    hann_window,
    istft,
    linear_upsample,
    phase_accumulate,
    stft,
    windowed_fir_from_magnitude,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("sigma", [3.0, 50.0, 600.0])
def test_fast_sin_cos_match_jax(sigma):
    """Same reduction and coefficients in f32; the only freedom is how
    each compiler evaluates the Horner chain: 1e-6 absolute at shaper
    and mid-range arguments. At the oscillator's bound (~600 rad) the
    f32 period subtraction itself carries ~6e-5, so both sides are held
    there to 1e-4 of each other."""
    x = (np.random.default_rng(0).standard_normal(4096) * sigma).astype(np.float32)
    atol = 1e-6 if sigma < 100 else 1e-4
    np.testing.assert_allclose(
        fast_sin(_t(x)).numpy(), np.asarray(jfm.fast_sin(jnp.asarray(x))), rtol=0, atol=atol
    )
    np.testing.assert_allclose(
        fast_cos(_t(x)).numpy(), np.asarray(jfm.fast_cos(jnp.asarray(x))), rtol=0, atol=atol
    )


def test_fast_sin_cos_gradients_are_the_jax_custom_ones():
    """d fast_sin = fast_cos and d fast_cos = -fast_sin, as the JAX
    custom_jvp (not autograd through the polynomial and round, up to
    ~9e-7 away): equal to the port's own fast_cos/-fast_sin, and to
    jax.grad within 1e-6 (the two compilers' Horner chains)."""
    x = np.concatenate([
        np.random.default_rng(7).standard_normal(2048) * 3.0,
        np.random.default_rng(8).uniform(0, 2 * np.pi * 101, 2048),
    ]).astype(np.float32)
    for fn, dfn, jfn in ((fast_sin, fast_cos, jfm.fast_sin), (fast_cos, None, jfm.fast_cos)):
        xt = _t(x).requires_grad_()
        fn(xt).sum().backward()
        expect = dfn(_t(x)) if dfn is not None else -fast_sin(_t(x))
        assert torch.equal(xt.grad, expect)
        ref = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a)))(jnp.asarray(x)))
        np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=0, atol=1e-6)


def test_fast_sin_round_half_to_even_and_f64_rule():
    """x/tau exactly at k+0.5 rounds to the even k (torch.round, like
    jnp.round); float64 takes the exact sine."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5], dtype=torch.float32) * (2 * math.pi)
    ref = np.asarray(jfm.fast_sin(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(fast_sin(x).numpy(), ref, rtol=0, atol=1e-6)
    x64 = torch.linspace(-20, 20, 101, dtype=torch.float64)
    assert torch.equal(fast_sin(x64), torch.sin(x64))
    assert torch.equal(fast_cos(x64), torch.cos(x64))


@pytest.mark.parametrize("periodic", [True, False])
def test_hann_window_matches_jax(periodic):
    np.testing.assert_allclose(
        hann_window(256, periodic).numpy(),
        np.asarray(j_hann_window(256, periodic)),
        rtol=0, atol=1e-7,
    )


@pytest.mark.parametrize("hop", [8, 128, 5])
def test_linear_upsample_bit_exact(hop):
    """The CUDA kernel's in-register FiLM lerp is held bit-exact to this
    function on the card, so it must be bit-exact to the JAX one here."""
    x = np.random.default_rng(hop).standard_normal((2, 7, 12)).astype(np.float32)
    out = linear_upsample(_t(x), 7 * hop).numpy()
    ref = np.asarray(j_linear_upsample(jnp.asarray(x), 7 * hop))
    np.testing.assert_array_equal(out, ref)


def test_linear_upsample_non_integer_ratio():
    """The gather form for out_len not a multiple of in_len: 1e-6."""
    x = np.random.default_rng(1).standard_normal((2, 7, 3)).astype(np.float32)
    out = linear_upsample(_t(x), 40).numpy()
    ref = np.asarray(j_linear_upsample(jnp.asarray(x), 40))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("offset_rank", [1, 2])
def test_bank_from_phase_with_injected_offset(offset_rank):
    """Same f32 phase and offsets into both banks: 1e-5 absolute (the
    polynomial sine at arguments up to tau*101, see above)."""
    rng = np.random.default_rng(2)
    b, t, h = 2, 300, 101
    f0 = rng.uniform(60.0, 900.0, (b, t)).astype(np.float32)
    phase = np.cumsum(f0, axis=1).astype(np.float32) * np.float32(2 * np.pi / 16000)
    shape = (h,) if offset_rank == 1 else (b, h)
    offset = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    out = bank_from_phase(_t(phase), _t(f0), h, 16000.0, _t(offset)).numpy()
    ref = np.asarray(
        josc.bank_from_phase(jnp.asarray(phase), jnp.asarray(f0), h, 16000.0, jnp.asarray(offset))
    )
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # antialias mask: harmonics at or above Nyquist are exactly zero
    k = np.arange(1, h + 1)
    assert np.all(out[f0[..., None] * k >= 8000.0] == 0.0)


def test_phase_accumulate_float64_against_jax():
    """The port sums in float64; JAX in float32. Over 2048 samples of
    f0 ~ 440 Hz the f32 sum drifts by ~1e-4 of its value at most."""
    f0 = np.random.default_rng(3).uniform(100, 800, (2, 2048)).astype(np.float32)
    out = phase_accumulate(_t(f0), 16000.0)
    assert out.dtype == torch.float64
    exact = 2 * np.pi * np.cumsum(f0.astype(np.float64), axis=-1) / 16000.0
    np.testing.assert_allclose(out.numpy(), exact, rtol=1e-12)
    ref = np.asarray(josc.phase_accumulate(jnp.asarray(f0), 16000.0))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)


def test_draw_phase_offset_range_and_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = draw_phase_offset(101, g1, torch.device("cpu"))
    b = draw_phase_offset(101, g2, torch.device("cpu"))
    assert torch.equal(a, b) and a.shape == (101,)
    assert float(a.min()) >= -math.pi and float(a.max()) < math.pi


@pytest.mark.parametrize("center,window", [(True, None), (False, None), (True, "hann")])
def test_stft_istft_match_jax(center, window):
    """Framing, reflect padding and the squared-window normalisation:
    FFT rounding only — 1e-4 absolute on the spectra (each bin sums 256
    samples), 1e-5 on the resynthesised signal."""
    x = np.random.default_rng(4).standard_normal((2, 1000)).astype(np.float32)
    w = None if window is None else hann_window(256)
    jw = None if window is None else j_hann_window(256)
    spec = stft(_t(x), 256, 128, window=w, center=center)
    jspec = j_stft(jnp.asarray(x), 256, 128, window=jw, center=center)
    np.testing.assert_allclose(spec.numpy(), np.asarray(jspec), rtol=1e-5, atol=1e-4)
    y = istft(spec, 256, 128, window=w, center=center)
    jy = j_istft(jspec, 256, 128, window=jw, center=center)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_fir_noise_filter_with_injected_noise():
    """The noise branch end to end (windowed FIR from magnitudes, STFT of
    the shared noise, iSTFT) on the same noise: 1e-5."""
    rng = np.random.default_rng(5)
    b, frames, hop = 2, 9, 128
    h_re = rng.standard_normal((b, frames, 129)).astype(np.float32)
    noise = rng.uniform(0, 1, hop * frames - 1).astype(np.float32)
    out = fir_noise_filter(_t(h_re), hop, noise=_t(noise)).numpy()
    ref = np.asarray(jfir.fir_noise_filter(jnp.asarray(h_re), hop, None, noise=jnp.asarray(noise)))
    assert out.shape == (b, hop * frames)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    fir = windowed_fir_from_magnitude(_t(h_re)).numpy()
    np.testing.assert_allclose(
        fir, np.asarray(jfir.windowed_fir_from_magnitude(jnp.asarray(h_re))), rtol=1e-5, atol=1e-5
    )


def test_fir_noise_filter_draws_from_generator():
    h_re = torch.randn(1, 4, 129, generator=torch.Generator().manual_seed(0))
    a = fir_noise_filter(h_re, 128, torch.Generator().manual_seed(1))
    b = fir_noise_filter(h_re, 128, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (1, 512)


@pytest.mark.parametrize("t,t_ir", [(300, 1000), (1000, 300)])
def test_fft_convolve_circular(t, t_ir):
    """Circular at max(T, T_ir), trimmed to T: 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, t)).astype(np.float32)
    ir = (rng.standard_normal(t_ir) * 0.1).astype(np.float32)
    out = fft_convolve_circular(_t(x), _t(ir)).numpy()
    ref = np.asarray(jfir.fft_convolve_circular(jnp.asarray(x), jnp.asarray(ir)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
