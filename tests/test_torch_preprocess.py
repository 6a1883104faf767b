"""The port's preprocessing against the JAX package on the CPU: mel
filterbank, DCT and MFCC; the numpy interpolators and the tensor
upsamplers; ``betainc`` against scipy; pYIN; the extractors' gin surface;
segmentation, filtering, statistics and the split; ``create_dataset``'s
shard tree end to end; and the dataset CLIs. Inputs come from numpy with
a seed, at a few seconds of audio."""
import importlib
import importlib.util
import os
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import scipy.special
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu import minigin as jgin
from neural_waveshaping_synthesis_tpu.data.preprocess import f0_extraction as j_f0x
from neural_waveshaping_synthesis_tpu.data.preprocess import loudness_extraction as j_loudx
from neural_waveshaping_synthesis_tpu.data.preprocess import mfcc_extraction as j_mfccx
from neural_waveshaping_synthesis_tpu.data.preprocess import upsampling as j_ups
from neural_waveshaping_synthesis_tpu.models import crepe as j_crepe
from neural_waveshaping_synthesis_tpu.ops import f0 as j_f0
from neural_waveshaping_synthesis_tpu.ops import mel as j_mel
from neural_waveshaping_synthesis_tpu.ops import upsample as j_upsample
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import f0_extraction as t_f0x
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import loudness_extraction as t_loudx
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import mfcc_extraction as t_mfccx
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import upsampling as t_ups
from neural_waveshaping_synthesis_tpu_torch.models import crepe as t_crepe
from neural_waveshaping_synthesis_tpu_torch.ops import f0 as t_f0
from neural_waveshaping_synthesis_tpu_torch.ops import mel as t_mel
from neural_waveshaping_synthesis_tpu_torch.ops import upsample as t_upsample
from neural_waveshaping_synthesis_tpu_torch.ops.loudness import extract_perceptual_loudness as t_loud_op
from neural_waveshaping_synthesis_tpu_torch.utils import seed_all

# the packages export functions of these modules' names
j_create_mod = importlib.import_module("neural_waveshaping_synthesis_tpu.data.preprocess.create_dataset")
j_pre = importlib.import_module("neural_waveshaping_synthesis_tpu.data.preprocess.preprocess_audio")
t_create_mod = importlib.import_module("neural_waveshaping_synthesis_tpu_torch.data.preprocess.create_dataset")
t_pre = importlib.import_module("neural_waveshaping_synthesis_tpu_torch.data.preprocess.preprocess_audio")

REPO = Path(__file__).resolve().parents[1]
DATA_GIN = str(REPO / "gin" / "data" / "urmp_4second_crepe.gin")
SR = 16000


@pytest.fixture(autouse=True)
def clean_gin():
    """Both registries' bindings are process-wide: start and leave every
    test with none. The JAX filterbank and DCT caches keep what they make,
    and one made inside a ``jax.jit`` trace is a tracer that breaks the
    next trace (the fault the JAX resampler's cache has, ROADMAP.md
    section 3), so they are filled outside any trace first."""
    gin.clear_config()
    jgin.clear_config()
    for fn in (j_mel.mel_filterbank, j_mel.dct_ii):
        fn.cache_clear()
    for n_fft in (512, 1024):
        j_mel.mel_filterbank(16000, n_fft, 128)
    j_mel.dct_ii(16, 128)
    yield
    gin.clear_config()
    jgin.clear_config()
    for fn in (j_mel.mel_filterbank, j_mel.dct_ii):
        fn.cache_clear()


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread for each test. The Viterbi recursion's per-frame
    ops and ``betainc``'s continued-fraction terms are small, and under the
    tier-1 run's parallel workers torch's intra-op threads thrash on them: a
    513-frame decode took 38-42 s in each of six concurrent processes at 8
    threads on 8 cores, and 0.14-0.21 s at one thread
    (``scripts/torch_viterbi_threads.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(seconds, hz=330.0, harmonics=3, noise=1e-3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = sum(np.sin(2 * np.pi * hz * k * t) / k for k in range(1, harmonics + 1))
    return (0.4 * x / np.abs(x).max() + noise * rng.standard_normal(t.shape)).astype(np.float32)


# -- mel, DCT, MFCC -------------------------------------------------------------

@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 1024, 128, 0.0, None), (22050, 2048, 80, 30.0, 8000.0), (44100, 512, 40, 0.0, None)])
def test_mel_filterbank_and_dct_are_bit_exact(sr, n_fft, n_mels, fmin, fmax):
    np.testing.assert_array_equal(t_mel._hz_to_mel(np.array([0.0, 440.0, 1000.0, 7999.0])),
                                  j_mel._hz_to_mel(np.array([0.0, 440.0, 1000.0, 7999.0])))
    np.testing.assert_array_equal(t_mel._mel_to_hz(np.linspace(0, 60, 13)),
                                  j_mel._mel_to_hz(np.linspace(0, 60, 13)))
    np.testing.assert_array_equal(t_mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax).numpy(),
                                  np.asarray(j_mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)))
    np.testing.assert_array_equal(t_mel.dct_ii(16, n_mels).numpy(), np.asarray(j_mel.dct_ii(16, n_mels)))


def test_power_to_db_floors_below_the_whole_tensors_max():
    """``top_db`` is taken against the max of the whole tensor, as JAX's:
    a batch in one call shares one floor. atol 1e-5 dB."""
    power = np.abs(np.random.default_rng(1).standard_normal((2, 7, 5))) ** 4
    power[1] *= 1e-12
    out = t_mel.power_to_db(torch.from_numpy(power.astype(np.float32))).numpy()
    ref = np.asarray(j_mel.power_to_db(jnp.asarray(power.astype(np.float32))))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert out.min() == pytest.approx(out.max() - 80.0)


@pytest.mark.parametrize("seconds,n_fft,hop", [(1.3, 1024, 128), (0.7, 512, 64)])
def test_extract_mfcc_matches_jax(seconds, n_fft, hop):
    """The quantum pad, the centred STFT, mel, dB and DCT, trimmed to
    1 + T // hop frames: atol 1e-3 on the dB-scale coefficients."""
    x = _tone(seconds, harmonics=6, noise=1e-2, seed=2)
    ref = np.asarray(j_mfccx.extract_mfcc(x, n_fft=n_fft, hop_length=hop))
    out = t_mfccx.extract_mfcc(torch.from_numpy(x), n_fft=n_fft, hop_length=hop).numpy()
    assert out.shape == ref.shape == (16, 1 + len(x) // hop)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


# -- interpolators and upsamplers ---------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("linear_interpolation", {}), ("cubic_spline_interpolation", {}),
    ("overlap_add_upsample", {}), ("overlap_add_upsample", {"window_scale": 3}),
    ("linear_interpolation", {"original_length": 3000}),
    ("overlap_add_upsample", {"original_length": 3000})])
def test_numpy_interpolators_are_bit_exact(name, kwargs):
    sig = np.random.default_rng(3).standard_normal(27)
    out = getattr(t_ups, name)(sig, 1024, 128, **kwargs)
    np.testing.assert_array_equal(out, getattr(j_ups, name)(sig, 1024, 128, **kwargs))
    assert t_ups.get_padded_length(27, 1024, 128) == j_ups.get_padded_length(27, 1024, 128)


@pytest.mark.parametrize("t,out_len", [(9, 9 * 128), (5, 333), (1, 16)])
def test_cubic_upsample_matches_jax(t, out_len):
    x = np.random.default_rng(4).standard_normal((2, t, 3)).astype(np.float32)
    ref = np.asarray(j_upsample.cubic_upsample(jnp.asarray(x), out_len))
    out = t_upsample.cubic_upsample(torch.from_numpy(x), out_len).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("t,window,hop", [(9, 256, 128), (4, 100, 30), (1, 64, 64)])
def test_overlap_add_upsample_matches_jax(t, window, hop):
    x = np.random.default_rng(5).standard_normal((2, t, 3)).astype(np.float32)
    ref = np.asarray(j_upsample.overlap_add_upsample(jnp.asarray(x), window, hop))
    out = t_upsample.overlap_add_upsample(torch.from_numpy(x), window, hop).numpy()
    assert out.shape == ref.shape == (2, t * hop, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


# -- betainc, pYIN -----------------------------------------------------------------

@pytest.mark.parametrize("a,b", [(2.0, 18.0), (0.5, 0.5), (2.7, 13.3), (1.0, 1.0), (30.5, 70.25),
                                 (0.1, 5.0), (18.0, 2.0)])
def test_betainc_matches_scipy(a, b):
    """The port's own regularised incomplete beta (PyTorch has none):
    rtol 1e-6 against ``scipy.special.betainc``, on a grid with both ends,
    random points, and the values pYIN clips to [0, 1]. Observed when
    written: <= 4.2e-14."""
    x = np.concatenate([np.linspace(0.0, 1.0, 513), np.random.default_rng(6).random(500),
                        [1e-12, 1 - 1e-12]])
    out = t_f0.betainc(a, b, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, scipy.special.betainc(a, b, x), rtol=1e-6, atol=1e-300)
    with pytest.raises(ValueError):
        t_f0.betainc(0.0, 1.0, torch.from_numpy(x))


_T = 3 * SR
_t = np.arange(_T) / SR


def _golden(name):
    """tests/test_pyin_golden.py's signals."""
    if name.startswith("steady"):
        return 0.4 * np.sin(2 * np.pi * float(name[6:]) * _t)
    if name == "vibrato":
        fv = 440 * 2 ** (0.05 / 1.2 * np.sin(2 * np.pi * 6 * _t))
        return 0.4 * np.sin(2 * np.pi * np.cumsum(fv) / SR)
    snr_db = float(name[5:])
    rng = np.random.default_rng(0)
    sig = sum(np.sin(2 * np.pi * 330 * k * _t) / k for k in range(1, 11))
    sig /= np.abs(sig).max()
    n = rng.standard_normal(_T)
    n *= np.sqrt((sig**2).mean() / (n**2).mean() / 10 ** (snr_db / 10))
    return sig + n


@pytest.mark.parametrize("name", ["steady110", "steady440", "steady1760", "vibrato",
                                  "noise20", "noise5"])
def test_pyin_matches_jax_on_the_golden_signals(name, monkeypatch):
    """The same decoded bins on >= 99 % of frames (a near tie of the
    observation may flip, as YIN's may), f0 rtol 1e-5 and periodicity
    atol 1e-5 where they agree. Observed when written: every frame."""
    bins = {}

    def keep(side, fn):
        def wrapped(probs, *args, **kwargs):
            out = fn(probs, *args, **kwargs)
            bins[side] = np.asarray(out)
            return out
        return wrapped

    monkeypatch.setattr(j_crepe, "viterbi_decode", keep("jax", j_crepe.viterbi_decode))
    monkeypatch.setattr(t_crepe, "viterbi_decode", keep("port", t_crepe.viterbi_decode))
    x = _golden(name).astype(np.float32)
    f0_j, per_j = (np.asarray(a) for a in j_f0.pyin_f0(jnp.asarray(x), SR))
    f0_t, per_t = (a.numpy() for a in t_f0.pyin_f0(torch.from_numpy(x), SR))
    same = bins["port"] == bins["jax"]
    assert same.mean() >= 0.99, (~same).sum()
    np.testing.assert_allclose(f0_t[same], f0_j[same], rtol=1e-5)
    np.testing.assert_allclose(per_t[same], per_j[same], rtol=0, atol=1e-5)


def test_extract_f0_with_pyin_matches_jax_with_its_options():
    """The extractor's quantum pad, trim, non-default Beta prior and
    ``fill_na`` / ``voicing_threshold`` against JAX's: f0 (NaN where
    filled) and periodicity on a tone that falls silent half way."""
    rng = np.random.default_rng(3)
    x = np.where(_t < 1.5, 0.4 * np.sin(2 * np.pi * 330 * _t), 1e-5 * rng.standard_normal(_T))
    x = x[: int(2.2 * SR)].astype(np.float32)
    kw = dict(fill_na=np.nan, voicing_threshold=0.5, beta_a=2.5, beta_b=11.5, maximum_frequency=1500.0)
    f0_j, per_j = j_f0x.extract_f0_with_pyin(x, **kw)
    f0_t, per_t = (a.numpy() for a in t_f0x.extract_f0_with_pyin(torch.from_numpy(x), **kw))
    assert f0_t.shape == (1 + len(x) // 128,)
    np.testing.assert_array_equal(np.isnan(f0_t), np.isnan(f0_j))
    assert 0.2 < np.isnan(f0_t).mean() < 0.6
    np.testing.assert_allclose(f0_t, f0_j, rtol=1e-5)
    np.testing.assert_allclose(per_t, per_j, rtol=0, atol=1e-5)


# -- the extractors' gin surface -----------------------------------------------------

def test_the_data_gin_file_binds_only_registered_configurables():
    gin.parse_config_file(DATA_GIN)
    assert len([k for k in gin._BINDINGS]) == 19
    assert gin.validate_config(strict=True) == []


def test_extractors_match_jax_under_the_data_gin_file():
    """With the data gin file parsed in both packages, each extractor as
    preprocessing calls it (audio alone) against JAX's: YIN f0 rtol 1e-5
    and periodicity atol 1e-5, loudness atol 1e-5, MFCC atol 1e-3; RMS
    and a YIN with ``interpolate_fn`` too."""
    gin.parse_config_file(DATA_GIN)
    jgin.parse_config_file(DATA_GIN)
    x = _tone(1.1, harmonics=4, seed=7)
    (f0_j, per_j), (f0_t, per_t) = j_f0x.extract_f0_with_yin(x), t_f0x.extract_f0_with_yin(torch.from_numpy(x))
    np.testing.assert_allclose(f0_t.numpy(), f0_j, rtol=1e-5)
    np.testing.assert_allclose(per_t.numpy(), per_j, rtol=0, atol=1e-5)
    loud_t = t_loudx.extract_perceptual_loudness(torch.from_numpy(x)).numpy()
    loud_j = j_loudx.extract_perceptual_loudness(x)
    assert loud_t.shape == loud_j.shape == (1 + len(x) // 128,)
    np.testing.assert_allclose(loud_t, loud_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_mfccx.extract_mfcc(torch.from_numpy(x)).numpy(),
                               j_mfccx.extract_mfcc(x), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_loudx.extract_rms(torch.from_numpy(x)).numpy(),
                               j_loudx.extract_rms(x), rtol=1e-6, atol=1e-7)
    up_t = t_f0x.extract_f0_with_yin(torch.from_numpy(x), interpolate_fn=t_ups.linear_interpolation)
    up_j = j_f0x.extract_f0_with_yin(x, interpolate_fn=j_ups.linear_interpolation)
    assert up_t[0].shape == (len(x),) and isinstance(up_t[0], torch.Tensor)
    np.testing.assert_allclose(up_t[0].numpy(), up_j[0], rtol=1e-5)


def test_timbre_transfers_calls_keep_their_bits():
    """``inference/timbre_transfer.py``'s two calls (YIN at 1000 Hz,
    loudness at 1024 / 128) give the bits of the computation they made
    before the extractors took JAX's signatures, with no gin file and with
    the data gin file parsed (its bindings reach the extractors, as in
    JAX; the explicit arguments win); a bound minimum frequency above the
    tone's reaches YIN."""
    from neural_waveshaping_synthesis_tpu_torch.data.preprocess.bucketing import pad_to_quantum
    from neural_waveshaping_synthesis_tpu_torch.ops.f0 import yin_f0

    x = torch.from_numpy(_tone(2.3, harmonics=5, noise=3e-2, seed=8))
    padded, n = pad_to_quantum(x)
    f0_before, per_before = (a[: 1 + n // 128] for a in yin_f0(padded, fmax=1000.0))
    loud_before = t_loud_op(padded, n_fft=1024, hop_length=128)[: 1 + n // 128]
    for gin_file in (None, DATA_GIN):
        if gin_file:
            gin.parse_config_file(gin_file)
            gin.parse_config("extract_perceptual_loudness.n_fft = 2048\n"
                             "extract_f0_with_yin.maximum_frequency = 500.0")
        f0, per = t_f0x.extract_f0_with_yin(x, maximum_frequency=1000.0)
        loud = t_loudx.extract_perceptual_loudness(x, n_fft=1024, hop_length=128)
        assert torch.equal(f0, f0_before) and torch.equal(per, per_before)
        assert torch.equal(loud, loud_before)
    gin.parse_config("extract_f0_with_yin.minimum_frequency = 400.0")
    f0 = t_f0x.extract_f0_with_yin(x, maximum_frequency=1000.0)[0]
    assert f0.min() >= 16000 / (int(16000 / 400.0) + 1) and f0_before.max() < 340.0


def test_crepe_without_weights_raises_jaxs_error(monkeypatch):
    monkeypatch.delenv("CREPE_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError) as port:
        t_f0x.extract_f0_with_crepe(torch.zeros(4000))
    with pytest.raises(FileNotFoundError) as jax_:
        j_f0x.extract_f0_with_crepe(np.zeros(4000, np.float32))
    assert str(port.value) == str(jax_.value)


# -- segmentation, statistics, split ----------------------------------------------------

@pytest.mark.parametrize("length,seg,hop", [(10, 4, 2), (3, 4, 2), (17, 4, 4), (8, 4, 4)])
def test_segment_signal_and_filter_segments_match_jax(length, seg, hop):
    x = np.random.default_rng(length).standard_normal((2, length))
    out = t_pre.segment_signal(x, 1.0, seg, hop)
    ref = j_pre.segment_signal(x, 1.0, seg, hop)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    key = np.abs(out[0])
    for a, b in zip(t_pre.filter_segments(0.7, key, (out[0], out)),
                    j_pre.filter_segments(0.7, key, (ref[0], ref))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,proportions", [(1, (0.8, 0.1, 0.1)), (7, (0.8, 0.1, 0.1)),
                                           (23, (0.5, 0.25, 0.25)), (101, (3, 1)), (0, (1, 1))])
@pytest.mark.parametrize("seed", [0, 11])
def test_split_counts_and_assignment_match_jax(n, proportions, seed):
    splits = ["s%d" % i for i in range(len(proportions))]
    assert t_create_mod.split_counts(n, proportions) == j_create_mod.split_counts(n, proportions)
    np.testing.assert_array_equal(
        t_create_mod.assign_splits(n, splits, proportions, np.random.default_rng(seed)),
        j_create_mod.assign_splits(n, splits, proportions, np.random.default_rng(seed)))


def test_corpus_stats_match_jax():
    """The unweighted mean of segment means and the length-weighted RMS
    pool of stds (the reference's quirk), over files of unequal segment
    counts: bit for bit, and the pool differs from the corpus std."""
    rng = np.random.default_rng(9)
    stats = (t_create_mod.CorpusStats(), j_create_mod.CorpusStats())
    for n in (3, 0, 5):
        audio, control = rng.standard_normal((n, 40)), rng.standard_normal((n, 19, 6)) + rng.random((n, 19, 1))
        for s in stats:
            s.add(audio, control)
    np.testing.assert_array_equal(stats[0].control_mean, stats[1].control_mean)
    np.testing.assert_array_equal(stats[0].control_std, stats[1].control_std)
    assert stats[0].peak == stats[1].peak and stats[0].count == 8


def test_seed_all_seeds_every_generator():
    import random

    gen = seed_all(3)
    draws = (random.random(), np.random.random(), torch.rand(1).item(), torch.rand(1, generator=gen).item())
    gen = seed_all(3)
    assert draws == (random.random(), np.random.random(), torch.rand(1).item(),
                     torch.rand(1, generator=gen).item())


# -- create_dataset end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    """JAX tests/test_preprocess.py's corpus (a 10-s harmonic tone that
    keeps its segments and 10 s of noise that fails the confidence
    filter) plus a 6-s 44.1-kHz int16 stereo tone, so that resampling and
    the downmix run."""
    root = tmp_path_factory.mktemp("wavs")
    t = np.arange(10 * SR) / SR
    tone = (0.5 * np.sin(2 * np.pi * 330 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)
    wavfile.write(root / "tone.wav", SR, (tone * 32767).astype(np.int16))
    noise = (np.random.default_rng(0).standard_normal(10 * SR) * 0.02).astype(np.float32)
    wavfile.write(root / "noise.wav", SR, (noise * 32767).astype(np.int16))
    t44 = np.arange(6 * 44100) / 44100
    stereo = np.stack([0.6 * np.sin(2 * np.pi * 247 * t44) + 0.1 * np.sin(2 * np.pi * 494 * t44),
                       0.3 * np.sin(2 * np.pi * 370 * t44)], axis=-1)
    wavfile.write(root / "stereo44k.wav", 44100, (stereo * 32767).astype(np.int16))
    return root


_BUILD_GIN = ("preprocess_audio.f0_extractor = @extract_f0_with_yin\n"
              "preprocess_audio.hop_length_in_seconds = 2\n"
              "preprocess_audio.verbose = False\n")


def _design_jax_filter(sr):
    from fractions import Fraction

    from neural_waveshaping_synthesis_tpu.ops import resample as j_resample_mod

    frac = Fraction(SR, sr)
    j_resample_mod._design.cache_clear()
    j_resample_mod._design(frac.numerator, frac.denominator, 32, 14.0)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*.npy"))


def test_create_dataset_writes_jaxs_tree(wav_corpus, tmp_path):
    """Both packages' ``create_dataset`` through the data gin file with YIN, hop 2 s: the same
    files in each split, the same keep mask per file, statistics rtol
    1e-4, audio shards atol 1e-5, control shards f0 rtol 1e-5 (kept
    segments), loudness and confidence atol 1e-5 and MFCC atol 1e-3 in
    physical units (the shards are z-scored, so each channel's difference
    is multiplied back by its std)."""
    files = [str(wav_corpus / f) for f in ("noise.wav", "stereo44k.wav", "tone.wav")]
    gin.parse_config_file(DATA_GIN)
    gin.parse_config(_BUILD_GIN)
    jgin.parse_config_file(DATA_GIN)
    jgin.parse_config(_BUILD_GIN)
    _design_jax_filter(44100)
    j_create_mod.create_dataset(files, str(tmp_path / "jax"), split_proportions=(0.5, 0.25, 0.25))
    t_create_mod.create_dataset(files, str(tmp_path / "port"), split_proportions=(0.5, 0.25, 0.25),
                                device="cpu")
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    names = _tree(jax_)
    assert _tree(port) == names
    assert sum("stereo44k" in n for n in names) == 2 * 2 and not any("noise" in n for n in names)
    assert sum("tone" in n for n in names) == 2 * 4
    mean_p, std_p = np.load(port / "data_mean.npy"), np.load(port / "data_std.npy")
    mean_j, std_j = np.load(jax_ / "data_mean.npy"), np.load(jax_ / "data_std.npy")
    assert mean_p.shape == std_p.shape == (19, 1)
    np.testing.assert_allclose(mean_p, mean_j, rtol=1e-4)
    np.testing.assert_allclose(std_p, std_j, rtol=1e-4)
    for name in names:
        if name.startswith("data_"):
            continue
        a, b = np.load(port / name), np.load(jax_ / name)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, name
        if "/audio/" in name:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
            continue
        a, b = a * std_j + mean_j, b * std_j + mean_j
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(a[1:3], b[1:3], rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a[3:], b[3:], rtol=0, atol=1e-3, err_msg=name)


def test_preprocess_single_file_keep_mask_matches_jax(wav_corpus):
    """Per file, the segments each package keeps and their shapes, with
    normalisation by a corpus peak and a threshold between the tone's and
    the noise's confidence."""
    gin.parse_config_file(DATA_GIN)
    jgin.parse_config_file(DATA_GIN)
    _design_jax_filter(44100)
    kw = dict(control_decimation_factor=128, hop_length_in_seconds=1.0, verbose=False,
              normalisation_factor=1.3)
    for name in ("tone.wav", "noise.wav", "stereo44k.wav"):
        path = str(wav_corpus / name)
        out = t_pre.preprocess_single_audio_file(
            path, f0_extractor=t_f0x.extract_f0_with_yin, device="cpu",
            loudness_extractor=t_loudx.extract_perceptual_loudness, **kw)
        ref = j_pre.preprocess_single_audio_file(
            path, f0_extractor=j_f0x.extract_f0_with_yin,
            loudness_extractor=partial(j_loudx.extract_perceptual_loudness), **kw)
        assert [o.shape for o in out] == [r.shape for r in ref], name
        assert out[0].shape[0] == {"tone.wav": 7, "noise.wav": 0, "stereo44k.wav": 3}[name]
        np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-5)


# -- the CLIs ---------------------------------------------------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_create_dataset_cli_then_two_training_steps(wav_corpus, tmp_path):
    """``scripts/torch_create_dataset.py --device cpu`` (0.256-s segments),
    then two ``scripts/torch_train.py --device cpu`` steps on its output:
    finite losses, and the URMP script on stems named as URMP names them."""
    out = tmp_path / "shards"
    rc = _script("torch_create_dataset").main([
        "--data-directory", str(wav_corpus), "--output-directory", str(out), "--device", "cpu",
        "--f0-extractor", "yin", "-b", "preprocess_audio.verbose = False",
        "-b", "preprocess_audio.segment_length_in_seconds = 0.256",
        "-b", "preprocess_audio.hop_length_in_seconds = 0.256"])
    assert rc == 0
    n = {s: len(os.listdir(out / s / "audio")) for s in ("train", "val", "test")}
    assert n == {"train": 50, "val": 6, "test": 6}
    assert np.load(out / "train" / "control" / os.listdir(out / "train" / "control")[0]).shape == (19, 32)
    gin.clear_config()
    import csv

    rc = _script("torch_train").main([
        "--dataset-path", str(out), "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--log-dir", str(tmp_path / "logs"), "-b", "TrainConfig.max_steps = 2",
        "-b", "GeneralDataModule.batch_size = 2", "-b", "TrainConfig.log_every_n_steps = 1",
        "-b", "TrainConfig.val_every_n_steps = 100"])
    assert rc == 0
    with open(tmp_path / "logs" / "metrics.csv") as f:
        losses = [float(r["train/loss"]) for r in csv.DictReader(f) if r["train/loss"]]
    assert len(losses) == 2 and np.all(np.isfinite(losses))

    gin.clear_config()
    stems = tmp_path / "urmp" / "01_Jupiter_vn_vc"
    stems.mkdir(parents=True)
    sr, tone = wavfile.read(wav_corpus / "tone.wav")
    wavfile.write(stems / "AuSep_1_vn_01_Jupiter.wav", sr, tone)
    wavfile.write(stems / "AuSep_2_vc_01_Jupiter.wav", sr, tone[: 5 * SR])
    rc = _script("torch_create_urmp_dataset").main([
        "--data-directory", str(tmp_path / "urmp"), "--output-directory", str(tmp_path / "by_ins"),
        "--instruments", "vn,vc,fl", "--device", "cpu", "--f0-extractor", "yin",
        "-b", "preprocess_audio.verbose = False"])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "by_ins")) == ["vc", "vn"]
    assert len(_tree(tmp_path / "by_ins" / "vn")) == 2 + 2 * 2
