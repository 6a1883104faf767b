"""Dataset + DataModule over the reference's ``.npy`` shard layout
(counterpart of the JAX ``data/general.py``).

Directory format (the reference's, so datasets interchange with the JAX
package and the reference):

    <root>/
      data_mean.npy, data_std.npy          # (19, 1) control stats
      {train,val,test}/
        audio/audio_<name>.npy             # (T_audio,) float32, 4 s
        control/control_<name>.npy         # (19, T_ctrl) z-scored

Control channels: 0 = f0 (Hz), 1 = loudness, 2 = CREPE confidence,
3-18 = MFCC. Items expose denormalised f0/amp like the reference.

A split is loaded once into two dense float32 arrays (a 4-s split is a
few hundred MB at most); batches are numpy arrays of static shape
(remainder dropped), which the trainer copies to its device. Train
batches are shuffled per pass by a seeded ``np.random.default_rng``.
"""
import os
from typing import Dict, Iterator

import numpy as np

from .. import minigin as gin


class GeneralDataset:
    """One split of (audio, control) pairs, stacked in memory."""

    def __init__(self, path: str, split: str = "train"):
        self.path = path
        self.split = split
        split_path = os.path.join(path, split)
        self.names = sorted(
            f[len("audio_") : -len(".npy")]
            for f in os.listdir(os.path.join(split_path, "audio"))
            if f.endswith(".npy") and f.startswith("audio_")
        )
        self.data_mean = np.load(os.path.join(path, "data_mean.npy")).astype(np.float32)  # (C, 1)
        self.data_std = np.load(os.path.join(path, "data_std.npy")).astype(np.float32)
        audio, control = [], []
        for name in self.names:
            audio.append(np.load(os.path.join(split_path, "audio", f"audio_{name}.npy")))
            control.append(np.load(os.path.join(split_path, "control", f"control_{name}.npy")))
        if audio:
            self.audio = np.stack(audio).astype(np.float32)  # (N, Ta)
            # stored channel-first (C, Tc) -> channels-last (N, Tc, C)
            self.control = np.stack(control).astype(np.float32).transpose(0, 2, 1)
        else:
            self.audio = np.zeros((0, 0), np.float32)
            self.control = np.zeros((0, 0, 0), np.float32)

    def __len__(self) -> int:
        return len(self.names)

    def denormalize(self, control_tc: np.ndarray) -> np.ndarray:
        """(..., Tc, C) z-scored -> physical units."""
        return control_tc * self.data_std.T + self.data_mean.T

    def __getitem__(self, idx: int) -> Dict:
        audio, control = self.audio[idx], self.control[idx]
        denorm = self.denormalize(control)
        return {
            "audio": audio,
            "f0": denorm[:, 0],
            "amp": denorm[:, 1],
            "control": control,
            "name": self.names[idx],
        }

    def batch(self, indices: np.ndarray) -> Dict:
        """-> {audio (B, Ta), f0 (B, Tc) Hz, control (B, Tc, C) z-scored}."""
        audio, control = self.audio[indices], self.control[indices]
        return {"audio": audio, "f0": self.denormalize(control)[:, :, 0], "control": control}


@gin.configurable
class GeneralDataModule:
    """Batch streams for train and val (reference ``data/general.py``).

    Train batches are shuffled per pass with ``np.random.default_rng(seed)``
    and sized statically, the remainder dropped; val iterates in order
    and drops a short final batch the same way. A split smaller than
    ``batch_size`` gives one batch of the whole split."""

    def __init__(self, data_root: str, batch_size: int = 16):
        self.data_root = data_root
        self.batch_size = batch_size
        self._splits: Dict[str, GeneralDataset] = {}

    def dataset(self, split: str) -> GeneralDataset:
        if split not in self._splits:
            self._splits[split] = GeneralDataset(self.data_root, split)
        return self._splits[split]

    def _batches(self, split: str, order: np.ndarray) -> Iterator[Dict]:
        ds = self.dataset(split)
        bs = min(self.batch_size, len(ds))
        if not bs:
            return
        for start in range(0, len(ds) - bs + 1, bs):
            yield ds.batch(order[start : start + bs])

    def train_batches(self, seed) -> Iterator[Dict]:
        """One shuffled pass; ``seed`` is anything ``np.random.default_rng``
        takes (the trainer passes (run seed, epoch))."""
        n = len(self.dataset("train"))
        return self._batches("train", np.random.default_rng(seed).permutation(n))

    def val_batches(self) -> Iterator[Dict]:
        return self._batches("val", np.arange(len(self.dataset("val"))))
