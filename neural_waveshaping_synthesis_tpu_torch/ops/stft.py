"""Framed STFT / iSTFT with the JAX ``ops/stft.py`` semantics: what the
FIR noise branch and the multi-resolution STFT loss need.

Signals are time-last ``(..., T)``; spectrograms ``(..., n_frames,
n_bins)``, frames before bins as in the JAX code. ``center=True``
reflect-pads n_fft//2 per side; ``window=None`` is rectangular; a window
(or ``win_length``) shorter than ``n_fft`` is zero-padded to n_fft,
centered, as ``torch.stft`` does; ``istft`` normalises by the
overlap-added squared window, guarded at 1e-11.

The JAX loss takes its spectrogram from a polyphase matmul DFT
(``polyphase_dft_magnitude``), a layout device for the TPU's matrix unit
with the same values; the port takes the framed ``torch.fft.rfft``.
"""
from typing import Optional

import torch
import torch.nn.functional as F


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), complete frames only:
    n_frames = 1 + (T - frame_length) // hop_length."""
    return x.unfold(-1, frame_length, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int, out_length: int) -> torch.Tensor:
    """Sum frames ``(..., n_frames, L)`` at hop-spaced offsets into
    ``(..., out_length)``: ceil(L/hop) shifted hop-block adds."""
    *batch, n_frames, length = frames.shape
    r = -(-length // hop_length)
    padded = F.pad(frames, (0, r * hop_length - length))
    parts = padded.reshape(*batch, n_frames, r, hop_length)
    blocks = frames.new_zeros((*batch, n_frames + r - 1, hop_length))
    for i in range(r):
        blocks[..., i : i + n_frames, :] += parts[..., :, i, :]
    flat = blocks.reshape(*batch, (n_frames + r - 1) * hop_length)
    if flat.shape[-1] < out_length:
        flat = F.pad(flat, (0, out_length - flat.shape[-1]))
    return flat[..., :out_length]


def _expand_window(
    window: Optional[torch.Tensor],
    n_fft: int,
    win_length: Optional[int],
    device: torch.device,
) -> torch.Tensor:
    """An (n_fft,) window (the JAX ``_expand_window``): a window shorter
    than n_fft is zero-padded to n_fft, centered; no window means
    rectangular, ones(win_length) padded the same way when win_length <
    n_fft, else ones(n_fft)."""
    if window is None:
        length = win_length if win_length is not None and win_length < n_fft else n_fft
        window = torch.ones(length, dtype=torch.float32, device=device)
    wl = window.shape[-1]
    if window.dim() != 1 or wl > n_fft:
        raise ValueError(f"window must be 1-D with at most n_fft={n_fft} samples")
    if wl < n_fft:
        left = (n_fft - wl) // 2
        window = F.pad(window, (left, n_fft - wl - left))
    return window


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    lead = x.shape[:-1]
    flat = x.reshape(1, -1, x.shape[-1])
    return F.pad(flat, (pad, pad), mode="reflect").reshape(*lead, -1)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
) -> torch.Tensor:
    """Complex STFT of ``(..., T)`` -> ``(..., n_frames, n_fft//2+1)``."""
    w = _expand_window(window, n_fft, win_length, x.device)
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop_length)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1)


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
) -> torch.Tensor:
    """Inverse STFT of ``(..., n_frames, n_bins)`` -> ``(..., T)``:
    windowed overlap-add over the overlap-added squared window.
    ``center=False`` keeps the full ``n_fft + hop*(n_frames-1)`` samples."""
    w = _expand_window(window, n_fft, None, spec.device)
    n_frames = spec.shape[-2]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w
    out_len = n_fft + hop_length * (n_frames - 1)
    y = overlap_add(frames, hop_length, out_len)
    wsq = overlap_add((w * w).expand(n_frames, n_fft), hop_length, out_len)
    y = y / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    if center:
        y = y[..., n_fft // 2 : out_len - n_fft // 2]
    return y


def spectrogram_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """|STFT| (centered) with the loss's numerical floor:
    sqrt(max(|X|^2, 1e-8)), as auraloss clamps the power at 1e-8 before
    the square root."""
    spec = stft(x, n_fft, hop_length, win_length, window)
    power = spec.real * spec.real + spec.imag * spec.imag
    return torch.sqrt(torch.clamp(power, min=1e-8))
