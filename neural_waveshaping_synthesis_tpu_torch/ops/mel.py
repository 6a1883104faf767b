"""Mel filterbank, DCT-II and MFCC (counterpart of the JAX ``ops/mel.py``,
librosa 0.8's ``feature.mfcc``: Slaney mel scale and normalisation,
orthonormal DCT-II, ``power_to_db`` with ref 1.0 and an 80-dB floor).

The filterbank and the DCT matrix are built in float64 numpy, as in JAX,
and only then cast to float32, so they are the JAX package's bit for bit.
The MFCC itself runs on the audio's device: a centred STFT with a
periodic Hann window, the mel product and the DCT product.
"""
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .stft import stft
from .windows import hann_window


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa's ``htk=False`` default)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@lru_cache(maxsize=None)
def _mel_filterbank_np(
    sample_rate: float, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]
) -> np.ndarray:
    if fmax is None:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def mel_filterbank(
    sample_rate: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Slaney-normalised triangular mel filterbank ``(n_mels, n_fft//2+1)``,
    float32 on ``device``."""
    return torch.from_numpy(_mel_filterbank_np(sample_rate, n_fft, n_mels, fmin, fmax)).to(device)


@lru_cache(maxsize=None)
def _dct_ii_np(n_out: int, n_in: int) -> np.ndarray:
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis.astype(np.float32)


def dct_ii(n_out: int, n_in: int, device=None) -> torch.Tensor:
    """Orthonormal DCT-II matrix ``(n_out, n_in)`` (scipy.fft.dct
    norm='ortho'), float32 on ``device``."""
    return torch.from_numpy(_dct_ii_np(n_out, n_in)).to(device)


def power_to_db(
    power: torch.Tensor, amin: float = 1e-10, top_db: Optional[float] = 80.0
) -> torch.Tensor:
    """librosa ``power_to_db`` with ref=1.0; ``top_db`` is taken below the
    max of the WHOLE tensor, so a batch in one call shares one floor."""
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def mfcc(
    audio: torch.Tensor,
    sample_rate: float = 16000,
    n_fft: int = 1024,
    hop_length: int = 128,
    n_mfcc: int = 16,
    n_mels: int = 128,
) -> torch.Tensor:
    """MFCCs of ``(..., T)`` audio -> ``(..., n_mfcc, 1 + T // hop)``,
    channel-first as the 19-channel control shards store them."""
    window = hann_window(n_fft, periodic=True, device=audio.device)
    spec = stft(audio, n_fft, hop_length, window=window, center=True)
    power = spec.real * spec.real + spec.imag * spec.imag  # (..., frames, bins)
    fb = mel_filterbank(sample_rate, n_fft, n_mels, device=audio.device)  # (mels, bins)
    mel_db = power_to_db(torch.matmul(power, fb.T))  # (..., frames, mels)
    return torch.matmul(dct_ii(n_mfcc, n_mels, device=audio.device), mel_db.transpose(-1, -2))
