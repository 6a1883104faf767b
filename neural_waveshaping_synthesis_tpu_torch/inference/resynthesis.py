"""Offline resynthesis: control signals -> audio with a trained checkpoint.

The serving entry point of the port. A request is an ``(f0_hz, loudness)``
pair of (Tc,) arrays at the 125 Hz control rate (what
``inference.timbre_transfer.extract_features`` yields).
:meth:`Synthesizer.render` normalises every request with
``adjust_controls`` at its default sliders and full pitch confidence,
zero-pads them to one length that is a multiple of ``FRAME_BUCKET``
frames, renders them as one batch under ``torch.inference_mode()``, and
trims each output back to ``Tc * hop`` samples.

On the card the GRU runs in cuDNN, which uses TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; set it (and
``torch.backends.cuda.matmul.allow_tf32``) False for float32 results.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert.checkpoint import load_checkpoint
from ..device import resolve_device
from ..models.neural_waveshaping import NeuralWaveshaping
from .timbre_transfer import FRAME_BUCKET, adjust_controls

Request = Tuple[np.ndarray, np.ndarray]


class Synthesizer:
    """A model held on one device with its normalisation statistics."""

    def __init__(
        self,
        model: NeuralWaveshaping,
        data_mean: np.ndarray,
        data_std: np.ndarray,
        device: torch.device,
    ):
        self.model = model
        self.data_mean, self.data_std = data_mean, data_std
        self.device = device

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        device="cuda",
        stats_dir: Optional[str] = None,
    ) -> "Synthesizer":
        """Load a reference-format checkpoint and the ``data_mean.npy`` /
        ``data_std.npy`` beside it (or in ``stats_dir``). ``device``
        defaults to the card and raises when CUDA is missing."""
        dev = resolve_device(device)
        params, hparams, data_mean, data_std = load_checkpoint(path, stats_dir)
        if data_mean is None or data_std is None:
            raise FileNotFoundError(
                f"data_mean.npy / data_std.npy not found beside {path}"
            )
        model = NeuralWaveshaping(
            n_waveshapers=int(hparams.get("n_waveshapers", 64)),
            control_hop=int(hparams.get("control_hop", 128)),
            sample_rate=float(hparams.get("sample_rate", 16000)),
        )
        model.load_params(params)
        return cls(model.to(dev).eval(), data_mean, data_std, dev)

    def prepare(self, requests: Sequence[Request]) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Normalise and zero-pad requests -> (f0 (B, Tp), control
        (B, Tp, 2), control lengths), Tp the longest request rounded up
        to a multiple of ``FRAME_BUCKET``."""
        if not requests:
            raise ValueError("no requests")
        rows, lengths = [], []
        for f0, loudness in requests:
            f0 = np.asarray(f0, dtype=np.float32)
            loudness = np.asarray(loudness, dtype=np.float32)
            if f0.ndim != 1 or f0.shape != loudness.shape or f0.size == 0:
                raise ValueError("a request is (f0 (Tc,), loudness (Tc,)) with Tc >= 1")
            rows.append(adjust_controls(
                f0, np.ones_like(f0), loudness, self.data_mean, self.data_std
            ))
            lengths.append(f0.shape[0])
        tp = -(-max(lengths) // FRAME_BUCKET) * FRAME_BUCKET
        f0_b = np.zeros((len(rows), tp), np.float32)
        ctrl_b = np.zeros((len(rows), tp, 2), np.float32)
        for i, (f0_hz, control) in enumerate(rows):
            f0_b[i, : lengths[i]] = f0_hz
            ctrl_b[i, : lengths[i]] = control
        return f0_b, ctrl_b, lengths

    def render(self, requests: Sequence[Request], seed: int = 0) -> List[np.ndarray]:
        """Render requests as one batch -> one (Tc * hop,) float32 array each.

        Phase offsets and noise are drawn from a CPU ``torch.Generator``
        seeded with ``seed``, so a seed renders the same draws on every
        device."""
        f0_b, ctrl_b, lengths = self.prepare(requests)
        generator = torch.Generator(device="cpu").manual_seed(seed)
        with torch.inference_mode():
            audio = self.model(
                torch.from_numpy(f0_b).to(self.device),
                torch.from_numpy(ctrl_b).to(self.device),
                generator=generator,
            )
            audio = audio.cpu().numpy()
        hop = self.model.control_hop
        return [audio[i, : n * hop].copy() for i, n in enumerate(lengths)]
