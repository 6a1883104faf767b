"""Timbre transfer's feature extraction in the port against the JAX
package, on the CPU: the Kaiser resampler, perceptual loudness, YIN and
``extract_features`` end to end. Inputs come from numpy with a seed (and
the repo's own 16-kHz wav)."""
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.inference import extract_features as j_extract_features
from neural_waveshaping_synthesis_tpu.ops import f0 as j_f0
from neural_waveshaping_synthesis_tpu.ops.loudness import (
    extract_perceptual_loudness as j_loudness,
    extract_rms as j_rms,
)
from neural_waveshaping_synthesis_tpu.ops import resample as j_resample_mod
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import (
    load_mono_audio,
    make_monophonic,
    pad_to_quantum,
    resample_audio,
)
from neural_waveshaping_synthesis_tpu_torch.inference import extract_features
from neural_waveshaping_synthesis_tpu_torch.ops import f0 as t_f0
from neural_waveshaping_synthesis_tpu_torch.ops.loudness import extract_perceptual_loudness, extract_rms

WAV = str(Path(__file__).resolve().parents[1] / "logs" / "audio" / "val_original_step20.wav")
SR = 16000


def _tone(seconds, sr=SR, f0=330.0, vibrato=0.0, harmonics=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    freq = f0 * (1 + vibrato * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(freq) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, harmonics + 1))
    x = 0.4 * x / np.abs(x).max() + 1e-3 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def _design_jax_filter(sr):
    """Design the JAX resampler's filter outside any trace. Its design
    cache keeps the arrays it makes, and one made inside a ``jax.jit``
    trace is a tracer that breaks the next trace at that rate pair (a
    fault of the JAX package, ROADMAP.md section 3); so start afresh."""
    frac = Fraction(SR, sr)
    j_resample_mod._design.cache_clear()
    j_resample_mod._design(frac.numerator, frac.denominator, 32, 14.0)


@pytest.mark.parametrize("sr", [44100, 48000, 22050, 16000])
def test_resample_matches_jax(sr):
    """Port vs ``resample_kaiser`` to 16 kHz, the identity included: the
    same length, atol 1e-5 (float32 products summed in another order).
    Observed when written: <= 5.4e-7."""
    x = (np.random.default_rng(sr).standard_normal(int(1.3 * sr)) * 0.3).astype(np.float32)
    _design_jax_filter(sr)
    ref = np.asarray(jax.jit(lambda a: j_resample_mod.resample_kaiser(a, sr, SR))(jnp.asarray(x)))
    out = resample_audio(x, sr, SR).numpy()
    assert out.shape == ref.shape == (int(len(x) * SR / sr),)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop", [(1024, 128), (2048, 512)])
@pytest.mark.parametrize("a_weighting", [False, True])
def test_loudness_matches_jax(n_fft, hop, a_weighting):
    """Normalised perceptual loudness, port vs JAX op: atol 1e-5.
    Observed when written: <= 2.1e-7."""
    x = _tone(1.7, harmonics=5, seed=1)
    ref = np.asarray(j_loudness(jnp.asarray(x), n_fft=n_fft, hop_length=hop,
                                apply_a_weighting=a_weighting))
    out = extract_perceptual_loudness(torch.from_numpy(x), n_fft=n_fft, hop_length=hop,
                                      apply_a_weighting=a_weighting).numpy()
    assert out.shape == ref.shape == (1 + len(x) // hop,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_rms_matches_jax():
    x = _tone(0.7, seed=2)
    np.testing.assert_allclose(extract_rms(torch.from_numpy(x)).numpy(),
                               np.asarray(j_rms(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_pad_to_quantum():
    x = torch.ones(40000)
    padded, n = pad_to_quantum(x)
    assert n == 40000 and padded.shape == (65536,) and float(padded[40000:].abs().sum()) == 0
    same, n = pad_to_quantum(torch.ones(32768))
    assert n == 32768 and same.shape == (32768,)


def _frames(x, length=1024, hop=128):
    padded = np.pad(x, length // 2, mode="reflect")
    n = 1 + (len(padded) - length) // hop
    return np.stack([padded[i * hop : i * hop + length] for i in range(n)]).astype(np.float32)


def test_difference_function_and_cmndf_match_jax():
    """On random frames: d(tau) rtol 1e-5 for tau >= 1; d(0) is a
    cancellation of two frame energies (~2e3), so it is held at 1e-6 of
    the frame's energy instead. cmndf rtol 1e-5 on the same d."""
    frames = np.random.default_rng(3).standard_normal((6, 1024)).astype(np.float32)
    ref = np.asarray(j_f0._difference_function(jnp.asarray(frames), 322))
    out = t_f0._difference_function(torch.from_numpy(frames), 322).numpy()
    energy = np.sum(frames**2, axis=-1)
    np.testing.assert_allclose(out[:, 1:], ref[:, 1:], rtol=1e-5)
    assert np.all(np.abs(out[:, 0] - ref[:, 0]) <= 1e-6 * energy)
    np.testing.assert_allclose(t_f0._cmndf(torch.from_numpy(ref.copy())).numpy(),
                               np.asarray(j_f0._cmndf(jnp.asarray(ref))), rtol=1e-5)


def _tau_star(cm, tau_min=16, tau_max=321, threshold=0.1):
    """The YIN pick, in numpy, from a (F, tau_max + 1) cmndf."""
    lags = np.arange(cm.shape[-1])
    masked = np.where((lags >= tau_min) & (lags <= tau_max), cm, np.inf)
    nxt = np.concatenate([masked[:, 1:], np.full_like(masked[:, :1], np.inf)], axis=-1)
    below = (masked < threshold) & (masked <= nxt)
    return np.where(below.any(-1), np.argmax(below, -1), np.argmin(masked, -1))


def _yin_both(x):
    frames = _frames(x)
    cm_j = np.asarray(j_f0._cmndf(j_f0._difference_function(jnp.asarray(frames), 322)))
    cm_t = t_f0._cmndf(t_f0._difference_function(torch.from_numpy(frames), 322)).numpy()
    ref = [np.asarray(a) for a in jax.jit(
        lambda a: j_f0.yin_f0(a, fmax=1000.0))(jnp.asarray(x))]
    out = [a.numpy() for a in t_f0.yin_f0(torch.from_numpy(x), fmax=1000.0)]
    return cm_j, cm_t, ref, out


@pytest.mark.parametrize("signal", ["tone", "vibrato_harmonics", "wav"])
def test_yin_matches_jax_on_voiced_audio(signal):
    """The same tau* on every frame, f0 rtol 1e-5, periodicity atol 1e-5
    (fmax 1000 Hz, as timbre transfer asks)."""
    if signal == "wav":
        x = load_mono_audio(WAV)[1]
    else:
        x = _tone(1.5, vibrato=0.02 if signal != "tone" else 0.0,
                  harmonics=6 if signal != "tone" else 1, seed=4)
    cm_j, cm_t, (f0_j, per_j), (f0_t, per_t) = _yin_both(x)
    np.testing.assert_array_equal(_tau_star(cm_t), _tau_star(cm_j))
    np.testing.assert_allclose(f0_t, f0_j, rtol=1e-5)
    np.testing.assert_allclose(per_t, per_j, rtol=0, atol=1e-5)


def test_yin_on_white_noise_agrees_but_for_near_ties():
    """On noise the pick is a threshold and argmin decision among many
    shallow dips: at least 99 % of frames agree, and on each frame that
    does not, the two candidates' cmndf lie within 1e-5 of each other."""
    x = (np.random.default_rng(5).standard_normal(SR) * 0.3).astype(np.float32)
    cm_j, cm_t, (f0_j, _), (f0_t, _) = _yin_both(x)
    differ = ~np.isclose(f0_t, f0_j, rtol=1e-5)
    assert differ.mean() <= 0.01, differ.sum()
    tau_j, tau_t = _tau_star(cm_j), _tau_star(cm_t)
    for i in np.flatnonzero(differ):
        assert abs(cm_j[i, tau_j[i]] - cm_j[i, tau_t[i]]) <= 1e-5, i


def _stereo_int16_tone():
    sr = 44100
    t = np.arange(int(1.5 * sr)) / sr
    left = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 660 * t)
    right = 0.3 * np.sin(2 * np.pi * 495 * t)
    return (np.stack([left, right], axis=-1) * 32767).astype(np.int16), sr


@pytest.mark.parametrize("source", ["wav_16k", "stereo_int16_44k"])
def test_extract_features_matches_jax(source):
    """The whole extraction (int PCM -> float, downmix, resample, 32768
    padding, YIN at 1000 Hz, loudness at 1024 / 128): audio atol 1e-5, f0
    rtol 1e-5 with the same tau*, confidence and loudness atol 1e-5."""
    if source == "wav_16k":
        from scipy.io import wavfile

        sr, audio = wavfile.read(WAV)
    else:
        audio, sr = _stereo_int16_tone()
    _design_jax_filter(sr)
    ref = j_extract_features(audio, sr)
    out = extract_features(audio, sr, device="cpu")
    for name, a, b in zip(("audio", "f0", "confidence", "loudness"), out, ref):
        assert a.shape == b.shape and a.dtype == np.float32, name
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-5)
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[3], ref[3], rtol=0, atol=1e-5)
    assert len(out[1]) == 1 + len(out[0]) // 128


def test_downmix_orientations_and_crepe():
    stereo = np.stack([np.arange(5.0), -np.arange(5.0)])
    np.testing.assert_array_equal(make_monophonic(stereo.T), np.arange(5.0))
    np.testing.assert_array_equal(make_monophonic(stereo, "diff"), 2 * np.arange(5.0))
    with pytest.raises(ValueError):
        make_monophonic(np.zeros((3, 10)))
    with pytest.raises(NotImplementedError):
        extract_features(np.zeros(4000, np.float32), 16000, f0_extractor="crepe", device="cpu")
