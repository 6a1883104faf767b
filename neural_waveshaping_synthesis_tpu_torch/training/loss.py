"""Multi-resolution STFT loss (counterpart of the JAX ``training/loss.py``).

auraloss-0.2.1 ``MultiResolutionSTFTLoss()`` at its defaults, as the
reference trains with it:

  fft_sizes   = (1024, 2048, 512)
  hop_sizes   = (120, 240, 50)
  win_lengths = (600, 1200, 240)
  window      = periodic hann(win_length), zero-padded to n_fft, centered
                STFT with reflect padding
  per resolution: spectral convergence + log-magnitude L1, both weight 1
  total = mean over resolutions

Magnitudes are floored at sqrt(1e-8) (``ops.stft.spectrogram_magnitude``).
The spectrograms are framed ``torch.fft.rfft``s, where the JAX code uses a
polyphase matmul DFT of the same values.

Over a data-parallel mesh of more than one rank the loss is the global
batch's, as JAX's sharded step computes it, not a mean of the ranks' own
losses: spectral convergence is a ratio of norms over the whole batched
tensor. :func:`multi_resolution_stft_loss` then sums each resolution's
partial sums over the ranks (:class:`_GlobalLoss`).
"""
from typing import Optional

import torch

from ..ops.stft import spectrogram_magnitude
from ..ops.windows import hann_window
from ..parallel.mesh import Mesh, all_reduce_sum_

FFT_SIZES = (1024, 2048, 512)
HOP_SIZES = (120, 240, 50)
WIN_LENGTHS = (600, 1200, 240)


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """Single-resolution STFT loss between input ``x`` and target ``y``
    (both ``(..., T)``):

    sc = ||Y - X||_F / ||Y||_F  (norms over the whole batched tensor)
    log_mag = mean |log Y - log X|
    """
    window = hann_window(win, periodic=True, device=x.device)
    x_mag = spectrogram_magnitude(x, n_fft, hop, win, window)
    y_mag = spectrogram_magnitude(y, n_fft, hop, win, window)
    sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)
    log_mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc + log_mag


def stft_loss_sums(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int
                   ) -> torch.Tensor:
    """The partial sums of one resolution's loss over these rows: (4,)
    [sum (Y - X)^2, sum Y^2, sum |log Y - log X|, element count]."""
    window = hann_window(win, periodic=True, device=x.device)
    x_mag = spectrogram_magnitude(x, n_fft, hop, win, window)
    y_mag = spectrogram_magnitude(y, n_fft, hop, win, window)
    # made on the device (a fill, no host-to-device copy), so a CUDA graph can hold it
    count = torch.full((), float(y_mag.numel()), dtype=y_mag.dtype, device=y_mag.device)
    return torch.stack([
        torch.sum(torch.square(y_mag - x_mag)),
        torch.sum(torch.square(y_mag)),
        torch.sum(torch.abs(torch.log(y_mag) - torch.log(x_mag))),
        count,
    ])


class _GlobalLoss(torch.autograd.Function):
    """(R, 4) partial sums of this rank's rows (:func:`stft_loss_sums` per
    resolution) -> the global batch's loss, mean over resolutions of
    sqrt(A) / sqrt(Y) + S / N with A, Y, S, N summed over the ranks.

    The sums are all-reduced in the forward; the backward hands each rank's
    partial sums the derivative of the global loss at the global sums
    (dL/dA = 1 / (2 R sqrt(A) sqrt(Y)), dL/dS = 1 / (R N)), so autograd gives
    each rank its share of the global-batch gradient, and the ranks' shares
    summed (the Trainer's gradient all-reduce) are that gradient. This is
    the surrogate on detached global sums, chosen over a differentiable
    all-reduce: the backward holds no collective, so it needs no agreement
    between the ranks on the order of their backward passes, and works
    alike on gloo and NCCL."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        total = partial.detach().clone()
        all_reduce_sum_([total], mesh)
        ctx.save_for_backward(total)
        a, yy, s, n = total.unbind(-1)
        return torch.mean(torch.sqrt(a) / torch.sqrt(yy) + s / n)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (total,) = ctx.saved_tensors
        a, yy, s, n = total.unbind(-1)
        r = total.shape[0]
        d_a = grad / (2.0 * r * torch.sqrt(a) * torch.sqrt(yy))
        d_yy = -grad * torch.sqrt(a) / (2.0 * r * yy * torch.sqrt(yy))
        d_s = grad / (r * n)
        return torch.stack([d_a, d_yy, d_s, torch.zeros_like(d_s)], dim=-1), None


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean over the three resolutions of (spectral convergence + log-mag L1).

    With a ``mesh`` of more than one rank, ``x`` and ``y`` are this rank's
    rows and the loss is the global batch's on every rank, its gradient this
    rank's share (:class:`_GlobalLoss`); otherwise it is the one-process loss
    of these rows, bit for bit."""
    if mesh is not None and mesh.world_size > 1:
        partial = torch.stack([stft_loss_sums(x, y, n_fft, hop, win)
                               for n_fft, hop, win in zip(FFT_SIZES, HOP_SIZES, WIN_LENGTHS)])
        return _GlobalLoss.apply(partial, mesh)
    total = 0.0
    for n_fft, hop, win in zip(FFT_SIZES, HOP_SIZES, WIN_LENGTHS):
        total = total + stft_loss(x, y, n_fft, hop, win)
    return total / len(FFT_SIZES)
