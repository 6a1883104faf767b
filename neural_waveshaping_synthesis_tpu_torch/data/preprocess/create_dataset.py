"""Dataset creation: feature segments -> normalised train/val/test shards
(counterpart of the JAX ``data/preprocess/create_dataset.py``, whose shard
tree, statistics and split it reproduces for the same wavs and seed).

Contract with the reference's ``data/utils/create_dataset.py:73-165``:
  * shard tree ``out/{split}/{audio,control}/{audio|control}_{stem}_{j}.npy``;
  * control shards are (19, T_ctrl) channel-first: f0, loudness,
    confidence, then 16 MFCCs;
  * ``data_mean.npy`` (19, 1): unweighted mean of per-segment channel
    means; ``data_std.npy`` (19, 1): length-weighted RMS pool of
    per-segment channel stds — the pool ignores between-segment mean
    spread; kept as-is because shipped checkpoints bake these stats in;
  * audio divides by the corpus max |sample|, floored at 1e-5;
  * segments shuffle-split by seeded rng in the given proportions: one
    ``np.random.default_rng(seed).permutation`` sliced by counts that
    round the head split's share and recurse on the remainder, as JAX's.

One pass, no temporary tree: the features are computed on the device
(``preprocess_audio.device``), each file's segment stacks stay in host
memory, the statistics accumulate as running sums, and every shard is
written once, already normalised.
"""
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ... import minigin as gin
from .preprocess_audio import preprocess_audio

_PEAK_FLOOR = 1e-5


@dataclass
class CorpusStats:
    """Streaming accumulators for the corpus normalization contract."""

    mean_sum: np.ndarray = None  # sum over segments of per-channel means
    var_sum: np.ndarray = None  # sum over segments of T * per-channel var
    weight: float = 0.0  # sum of segment lengths
    count: int = 0  # number of segments
    peak: float = _PEAK_FLOOR  # max |audio sample|

    def add(self, audio: np.ndarray, control: np.ndarray) -> None:
        """audio (n, T_audio), control (n, C, T_ctrl)."""
        if control.shape[0] == 0:
            return
        m = control.mean(axis=-1)  # (n, C)
        v = control.var(axis=-1)  # (n, C)
        t = control.shape[-1]
        if self.mean_sum is None:
            self.mean_sum = np.zeros(control.shape[1])
            self.var_sum = np.zeros(control.shape[1])
        self.mean_sum += m.sum(axis=0)
        self.var_sum += t * v.sum(axis=0)
        self.weight += t * control.shape[0]
        self.count += control.shape[0]
        self.peak = max(self.peak, float(np.abs(audio).max()))

    @property
    def control_mean(self) -> np.ndarray:  # (C, 1)
        return (self.mean_sum / self.count)[:, None]

    @property
    def control_std(self) -> np.ndarray:  # (C, 1)
        return np.sqrt(self.var_sum / self.weight)[:, None]


def split_counts(n: int, proportions: Sequence[float]) -> List[int]:
    """Per-split segment counts: head takes round(n * p / sum(p)), the
    rule recurses on the remainder, the tail takes what's left."""
    counts, remaining, props = [], n, list(proportions)
    while len(props) > 1:
        take = int(round(remaining * props[0] / sum(props)))
        take = min(take, remaining)
        counts.append(take)
        remaining -= take
        props.pop(0)
    counts.append(remaining)
    return counts


def assign_splits(
    n: int,
    splits: Sequence[str],
    proportions: Sequence[float],
    rng: np.random.Generator,
) -> np.ndarray:
    """One seeded permutation sliced by split_counts -> per-segment
    split index array of length n."""
    assert len(splits) == len(proportions)
    order = rng.permutation(n)
    assignment = np.empty(n, np.int64)
    start = 0
    for k, c in enumerate(split_counts(n, proportions)):
        assignment[order[start : start + c]] = k
        start += c
    return assignment


def _ensure_tree(root: str, splits: Sequence[str]) -> None:
    for split in splits:
        for kind in ("audio", "control"):
            os.makedirs(os.path.join(root, split, kind), exist_ok=True)


@gin.configurable
def create_dataset(
    files: Sequence[str],
    output_directory: str,
    splits: Sequence[str] = ("train", "val", "test"),
    split_proportions: Sequence[float] = (0.8, 0.1, 0.1),
    lazy: bool = True,
    seed: int = 0,
    device="cuda",
) -> None:
    """Preprocess ``files``, their features on ``device``, and write the
    normalized shard tree.

    ``lazy`` is accepted for config-surface parity with the reference
    and ignored: this function streams files either way (the reference's
    non-lazy branch is unimplemented upstream).
    """
    del lazy
    _ensure_tree(output_directory, splits)

    # pass over files: extract + segment, cache stacks, accumulate stats
    stats = CorpusStats()
    per_file: List[Tuple[str, np.ndarray, np.ndarray]] = []
    for path, (audio, f0, confidence, loudness, mfcc) in zip(
        files, preprocess_audio(files, device=device)
    ):
        if audio.shape[0] == 0:
            continue
        stem = os.path.splitext(os.path.basename(path))[0]
        # (n, C, T_ctrl): f0, loudness, confidence, mfcc — shard order
        control = np.concatenate(
            [f0[:, None], loudness[:, None], confidence[:, None], mfcc], axis=1
        )
        stats.add(audio, control)
        per_file.append((stem, audio, control))

    if stats.count == 0:
        print("[create_dataset] no segments survived filtering; nothing to write")
        return

    mean, std = stats.control_mean, stats.control_std
    np.save(os.path.join(output_directory, "data_mean.npy"), mean)
    np.save(os.path.join(output_directory, "data_std.npy"), std)

    assignment = assign_splits(
        stats.count, splits, split_proportions, np.random.default_rng(seed)
    )

    # write every shard once, normalized vectorized per file
    i = 0
    for stem, audio, control in per_file:
        audio_n = (audio / stats.peak).astype(np.float32)
        control_n = ((control - mean) / std).astype(np.float32)
        for j in range(audio.shape[0]):
            split = splits[assignment[i]]
            np.save(
                os.path.join(
                    output_directory, split, "audio", f"audio_{stem}_{j}.npy"
                ),
                audio_n[j],
            )
            np.save(
                os.path.join(
                    output_directory, split, "control", f"control_{stem}_{j}.npy"
                ),
                control_n[j],
            )
            i += 1
    counts = {s: int((assignment == k).sum()) for k, s in enumerate(splits)}
    print(f"[create_dataset] wrote {stats.count} segments: {counts}")
