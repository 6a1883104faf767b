"""Time-varying FIR noise and circular FFT convolution (counterpart of
the JAX ``ops/fir.py``).

Quirks of the reference that its checkpoints bake in, kept here:
the noise excitation is uniform [0, 1) (not zero-mean), one vector of
``hop*n_frames - 1`` samples shared across the batch; the reverb's
convolution is circular at ``max(T, len(ir))``, so the tail wraps.
"""
from typing import Optional

import torch

from .stft import istft, stft
from .windows import hann_window


def windowed_fir_from_magnitude(h_re: torch.Tensor) -> torch.Tensor:
    """``(..., n_frames, n_bins)`` zero-phase magnitude response ->
    complex response of the windowed linear-phase FIR (irfft -> roll by
    ir_length/2 -> periodic Hann -> rfft); ir_length = 2*(n_bins-1)."""
    n_bins = h_re.shape[-1]
    ir_length = 2 * (n_bins - 1)
    h = torch.fft.irfft(h_re, n=ir_length, dim=-1)
    h = torch.roll(h, ir_length // 2, dims=-1)
    window = hann_window(ir_length, periodic=True, device=h_re.device)
    return torch.fft.rfft(h * window, n=ir_length, dim=-1)


def fir_noise_filter(
    h_re: torch.Tensor,
    hop_length: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Filtered-noise synthesis: ``(B, n_frames, n_bins)`` magnitude
    responses -> ``(B, hop_length * n_frames)`` audio.

    ``noise``: an explicit ``(hop*n_frames - 1,)`` excitation; when None
    it is drawn uniform [0, 1) from ``generator`` on the generator's own
    device (the default generator when None), then moved to ``h_re``'s."""
    b, n_frames, n_bins = h_re.shape
    n_fft = 2 * (n_bins - 1)
    h_z = windowed_fir_from_magnitude(h_re)
    if noise is None:
        gen_device = generator.device if generator is not None else None
        noise = torch.rand(
            hop_length * n_frames - 1, generator=generator, device=gen_device,
            dtype=h_re.dtype,
        ).to(h_re.device)
    x = stft(noise, n_fft, hop_length, window=None, center=True)
    audio = istft(x[None] * h_z, n_fft, hop_length, window=None, center=False)
    return audio[..., : hop_length * n_frames]


def fft_convolve_circular(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Circular convolution of ``(..., T)`` with ``(T_ir,)`` at length
    max(T, T_ir), trimmed back to T (the wrap is intentional)."""
    t = x.shape[-1]
    n = max(t, ir.shape[-1])
    y = torch.fft.irfft(
        torch.fft.rfft(x, n=n, dim=-1) * torch.fft.rfft(ir, n=n), n=n, dim=-1
    )
    return y[..., :t]


def fft_convolve_full(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Linear (non-circular) convolution of ``(..., T)`` with ``(T_ir,)``,
    full length T + T_ir - 1: what the streaming reverb's partitioned
    convolution computes block by block."""
    n = x.shape[-1] + ir.shape[-1] - 1
    return torch.fft.irfft(
        torch.fft.rfft(x, n=n, dim=-1) * torch.fft.rfft(ir, n=n), n=n, dim=-1
    )


def n_partitions(ir_length: int, block: int) -> int:
    """P = ceil(T_ir / block): the partitions of an IR, and the depth of
    the frequency-domain delay line that convolves with them."""
    return -(-ir_length // block)


def partition_ir_spectra(ir: torch.Tensor, block: int) -> torch.Tensor:
    """Split a (T_ir,) IR into :func:`n_partitions` zero-padded blocks and
    rfft each at 2*block -> (P, block+1) complex64 spectra (made once per
    block size)."""
    n_part = n_partitions(ir.shape[-1], block)
    padded = torch.nn.functional.pad(ir, (0, n_part * block - ir.shape[-1]))
    return torch.fft.rfft(padded.reshape(n_part, block), n=2 * block, dim=-1)


def partitioned_convolve_step(
    x_block: torch.Tensor,
    fdl: torch.Tensor,
    tail: torch.Tensor,
    ir_spectra: torch.Tensor,
):
    """One block of uniform-partitioned FFT convolution: a true linear
    convolution with an IR of any length, at one block of latency.

    Args: x_block (B, N) new input; fdl (B, P, N+1) complex frequency-
    domain delay line, newest first; tail (B, N) overlap-add carry;
    ir_spectra (P, N+1) from :func:`partition_ir_spectra`.
    Returns (y (B, N), fdl', tail'), new tensors (the inputs are not
    written)."""
    n = x_block.shape[-1]
    x_spec = torch.fft.rfft(x_block, n=2 * n, dim=-1)
    fdl = torch.cat([x_spec[:, None], fdl[:, :-1]], dim=1)
    acc = torch.einsum("bpk,pk->bk", fdl, ir_spectra)
    full = torch.fft.irfft(acc, n=2 * n, dim=-1)
    return full[..., :n] + tail, fdl, full[..., n:]
