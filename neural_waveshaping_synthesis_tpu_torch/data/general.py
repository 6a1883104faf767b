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

By default a split is loaded once into two dense float32 arrays (a 4-s
split is a few hundred MB at most). With ``load_to_memory=False`` the
shards stay on disk and each batch or item loads its own, for corpora
larger than host memory; the arrays are the same bit for bit. Batches
are numpy arrays of static shape (remainder dropped), which the trainer
copies to its device; over a data-parallel mesh each rank reads only its
rows of every global batch. Train batches are shuffled per pass by a seeded
``np.random.default_rng``; val and test iterate in order.
"""
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .. import minigin as gin
from ..parallel.mesh import Mesh, batch_sharding


class GeneralDataset:
    """One split of (audio, control) pairs: stacked in memory, or, with
    ``load_to_memory=False``, read from its shards per call (``audio`` and
    ``control`` are then None)."""

    def __init__(self, path: str, split: str = "train", load_to_memory: bool = True):
        self.path = path
        self.split = split
        self.load_to_memory = load_to_memory
        self._split_path = os.path.join(path, split)
        self.names = sorted(
            f[len("audio_") : -len(".npy")]
            for f in os.listdir(os.path.join(self._split_path, "audio"))
            if f.endswith(".npy") and f.startswith("audio_")
        )
        self.data_mean = np.load(os.path.join(path, "data_mean.npy")).astype(np.float32)  # (C, 1)
        self.data_std = np.load(os.path.join(path, "data_std.npy")).astype(np.float32)
        self.audio: Optional[np.ndarray] = None
        self.control: Optional[np.ndarray] = None
        if load_to_memory:
            self.audio, self.control = self._load(range(len(self.names)))

    def _load(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """The clips at ``indices`` -> (audio (N, Ta), control (N, Tc, C))."""
        audio, control = [], []
        for i in indices:
            name = self.names[i]
            audio.append(np.load(os.path.join(self._split_path, "audio", f"audio_{name}.npy")))
            control.append(np.load(os.path.join(self._split_path, "control", f"control_{name}.npy")))
        if not audio:
            return np.zeros((0, 0), np.float32), np.zeros((0, 0, 0), np.float32)
        # stored channel-first (C, Tc) -> channels-last (N, Tc, C)
        return (np.stack(audio).astype(np.float32),
                np.stack(control).astype(np.float32).transpose(0, 2, 1))

    def _clips(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        if self.load_to_memory:
            return self.audio[indices], self.control[indices]
        return self._load(np.atleast_1d(indices))

    def __len__(self) -> int:
        return len(self.names)

    def denormalize(self, control_tc: np.ndarray) -> np.ndarray:
        """(..., Tc, C) z-scored -> physical units."""
        return control_tc * self.data_std.T + self.data_mean.T

    def __getitem__(self, idx: int) -> Dict:
        (audio,), (control,) = self._clips([idx])
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
        audio, control = self._clips(indices)
        return {"audio": audio, "f0": self.denormalize(control)[:, :, 0], "control": control}


@gin.configurable
class GeneralDataModule:
    """Batch streams for train, val and test (reference ``data/general.py``).

    Train batches are shuffled per pass with ``np.random.default_rng(seed)``
    and sized statically, the remainder dropped; val and test iterate in
    order and drop a short final batch the same way. A split smaller than
    ``batch_size`` gives one batch of the whole split. ``load_to_memory``
    (default on) is the datasets' (:class:`GeneralDataset`)."""

    def __init__(self, data_root: str, batch_size: int = 16, load_to_memory: bool = True):
        self.data_root = data_root
        self.batch_size = batch_size
        self.load_to_memory = load_to_memory
        self._splits: Dict[str, GeneralDataset] = {}

    def dataset(self, split: str) -> GeneralDataset:
        if split not in self._splits:
            self._splits[split] = GeneralDataset(self.data_root, split, self.load_to_memory)
        return self._splits[split]

    def _batch_size(self, split: str) -> int:
        return min(self.batch_size, len(self.dataset(split)))

    def n_batches(self, split: str) -> int:
        """The batches one pass over ``split`` gives."""
        bs = self._batch_size(split)
        return len(self.dataset(split)) // bs if bs else 0

    def _rows(self, split: str, order: np.ndarray, start: int = 0,
              mesh: Optional[Mesh] = None) -> Iterator[np.ndarray]:
        bs = self._batch_size(split)
        for i in range(start, self.n_batches(split)):
            rows = order[i * bs : (i + 1) * bs]
            yield rows if mesh is None else batch_sharding(mesh)(rows)

    def _batches(self, split: str, order: np.ndarray, start: int = 0,
                 mesh: Optional[Mesh] = None) -> Iterator[Dict]:
        ds = self.dataset(split)
        for rows in self._rows(split, order, start, mesh):
            yield ds.batch(rows)

    def train_rows(self, seed, start: int = 0, mesh: Optional[Mesh] = None) -> Iterator[np.ndarray]:
        """The row indices of :meth:`train_batches`' batches, in its order,
        nothing loaded: what the trainer gathers from a split it holds on
        its device."""
        n = len(self.dataset("train"))
        return self._rows("train", np.random.default_rng(seed).permutation(n), start, mesh)

    def train_batches(self, seed, start: int = 0, mesh: Optional[Mesh] = None) -> Iterator[Dict]:
        """One shuffled pass from its ``start``-th batch on (the earlier ones
        are not loaded); ``seed`` is anything ``np.random.default_rng`` takes
        (the trainer passes (run seed, 2, epoch)). With a data-parallel
        ``mesh`` every rank draws the same order and loads only its
        contiguous rows of each global batch (``parallel.batch_sharding``;
        ValueError when the batch does not divide by the world size)."""
        ds = self.dataset("train")
        return (ds.batch(rows) for rows in self.train_rows(seed, start, mesh))

    def val_batches(self, mesh: Optional[Mesh] = None) -> Iterator[Dict]:
        return self._batches("val", np.arange(len(self.dataset("val"))), mesh=mesh)

    def test_batches(self, mesh: Optional[Mesh] = None) -> Iterator[Dict]:
        return self._batches("test", np.arange(len(self.dataset("test"))), mesh=mesh)
