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
"""
import torch

from ..ops.stft import spectrogram_magnitude
from ..ops.windows import hann_window

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


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over the three resolutions of (spectral convergence + log-mag L1)."""
    total = 0.0
    for n_fft, hop, win in zip(FFT_SIZES, HOP_SIZES, WIN_LENGTHS):
        total = total + stft_loss(x, y, n_fft, hop, win)
    return total / len(FFT_SIZES)
