"""Metric and audio loggers (counterpart of the JAX ``training/logging.py``).

Three backends behind one duck-typed interface, ``log_metrics(metrics,
step)`` and ``log_audio(name, audio, sample_rate, step)``, with the JAX
metric names (``train/loss``, ``train/lr``, ``train/steps_per_sec``,
``grad_norm``, ``val/loss``, ``test/loss``) and CSV columns:

  ConsoleLogger — one stdout line per call;
  CSVLogger     — append-only ``metrics.csv``, and audio snapshots as wavs
                  in ``audio/`` beside it;
  WandbLogger   — Weights & Biases, imported when it is built; it also has
                  the ``log_params`` hook the Trainer calls at each
                  validation.
"""
import csv
import os
import time
from typing import Dict, Iterator, Tuple

import numpy as np
from scipy.io import wavfile

CSV_COLUMNS = (
    "step", "time", "train/loss", "train/lr", "train/steps_per_sec",
    "val/loss", "test/loss", "grad_norm",
)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Peak-normalise to 0.9 of full scale and write 16-bit PCM, as the JAX
    ``utils.write_wav``."""
    audio = np.asarray(audio)
    peak = np.abs(audio).max()
    scaled = audio / peak * 0.9 if peak > 0 else audio
    wavfile.write(path, int(sample_rate), (scaled * 32767).astype(np.int16))


class ConsoleLogger:
    def log_metrics(self, metrics: Dict, step: int) -> None:
        parts = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
        print(f"[step {step}] {parts}", flush=True)

    def log_audio(self, name: str, audio: np.ndarray, sample_rate: int, step: int) -> None:
        pass


class CSVLogger:
    """``<directory>/metrics.csv``, one row per call (columns the metric
    does not have stay empty), appended to across runs."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.csv")
        self._wrote_header = os.path.exists(self.path)

    def log_metrics(self, metrics: Dict, step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=CSV_COLUMNS, extrasaction="ignore")
            if not self._wrote_header:
                writer.writeheader()
                self._wrote_header = True
            writer.writerow(row)

    def log_audio(self, name: str, audio: np.ndarray, sample_rate: int, step: int) -> None:
        """Write an audio snapshot as ``audio/<name>_step<step>.wav``
        beside the metrics (``/`` in the name becomes ``_``)."""
        audio_dir = os.path.join(os.path.dirname(self.path), "audio")
        os.makedirs(audio_dir, exist_ok=True)
        safe = name.replace("/", "_")
        write_wav(os.path.join(audio_dir, f"{safe}_step{step}.wav"), audio, sample_rate)


def _named_leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[str, np.ndarray]]:
    """(path joined by "/", leaf) in the order JAX flattens a tree: dict
    keys sorted, list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), np.asarray(tree)


class WandbLogger:
    """Weights & Biases, as the JAX ``WandbLogger``. ``wandb`` is imported
    when the logger is built, so building it without wandb installed raises
    ImportError (the CLI builds it only under ``--with-wandb``)."""

    def __init__(self, project: str = "neural-waveshaping-synthesis-tpu", **kwargs):
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project=project, **kwargs)

    def log_metrics(self, metrics: Dict, step: int) -> None:
        self._wandb.log(metrics, step=step)

    def log_audio(self, name: str, audio: np.ndarray, sample_rate: int, step: int) -> None:
        self._wandb.log(
            {f"audio/{name}": self._wandb.Audio(audio, sample_rate=sample_rate, caption=name)},
            step=step,
        )

    def log_params(self, params: Dict, step: int) -> None:
        """A histogram per parameter tensor (``parameters/<path>``) and
        their global norm (``parameters/global_norm``): the reference's
        ``logger.watch(model, log="parameters")``, called by the Trainer
        at each validation with host arrays in the JAX layout."""
        payload, sq_sum = {}, 0.0
        for name, arr in _named_leaves(params):
            payload[f"parameters/{name}"] = self._wandb.Histogram(arr.ravel())
            sq_sum += float(np.sum(arr.astype(np.float64) ** 2))
        payload["parameters/global_norm"] = float(np.sqrt(sq_sum))
        self._wandb.log(payload, step=step)
