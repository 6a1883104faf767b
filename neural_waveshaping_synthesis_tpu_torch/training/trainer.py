"""Training (counterpart of the JAX ``training/trainer.py``).

The reference trains with PyTorch Lightning; the JAX package rebuilt that
runtime for the TPU, and this module is its PyTorch counterpart:

  * the loss: the model's forward, then the multi-resolution STFT loss
    (:func:`compute_loss`);
  * global-norm gradient clipping at 2.0, then Adam (eps 1e-8), then a
    staircase StepLR of 0.9 every 10,000 steps, stepped once per step
    (:class:`Optimizer`, the order of JAX ``make_optimizer``);
  * :class:`Trainer`: the loop over a :class:`data.GeneralDataModule`,
    validation, reference-format checkpoints that
    ``Synthesizer.from_checkpoint`` serves, and the JAX trainer's metrics
    handed to its loggers (:mod:`.logging`).

``TrainConfig`` and the data modules are gin configurables, so
``scripts/torch_train.py`` reads the repo's gin files as the JAX
``scripts/train.py`` does.

Per-step randomness (the oscillator's phase offsets and the noise
excitation) comes from a CPU ``torch.Generator`` seeded from (seed,
step), so a run repeats on any device. It cannot repeat JAX's key stream.

float32 throughout, as the JAX f32 recipe; on the card the Trainer turns
TF32 off for matmuls and cuDNN (the GRU). On the card NEWT's FiLM ->
shaper -> FiLM block runs the CUDA forward kernel and, in the backward,
the CUDA backward kernel of the ``NEWT.fused`` it is built with: the
control-rate pair by default, the audio-rate pair with ``"full_lane"``
(``kernels/newt_fused.py``).

Not here: the JAX runtime's multi-step ``lax.scan`` chunking and on-device
batch gathering (TPU dispatch devices), orbax resume, data parallelism
and wandb (ROADMAP.md).
"""
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .. import minigin as gin
from ..convert.checkpoint import save_reference_checkpoint
from ..device import resolve_device
from ..models.neural_waveshaping import NeuralWaveshaping
from .loss import multi_resolution_stft_loss


@gin.configurable
@dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig`` fields that mean something here, with its
    defaults (the reference recipe, ``gin/train/train_newt.gin``).
    ``data_parallel`` over one card is a mesh of one; over more it is not
    ported yet, and the Trainer raises (ROADMAP.md queue 1, Multi-GPU)."""

    learning_rate: float = 1e-3
    lr_decay: float = 0.9
    lr_decay_interval: int = 10000
    max_steps: int = 120000
    gradient_clip_val: float = 2.0
    data_parallel: bool = True
    val_every_n_steps: int = 1000
    log_every_n_steps: int = 100
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    adam_eps: float = 1e-8


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate: lr * decay^(step // interval), staircase, as
    ``optax.exponential_decay(staircase=True)`` and the reference's StepLR."""

    def schedule(step: int) -> float:
        return cfg.learning_rate * cfg.lr_decay ** (step // cfg.lr_decay_interval)

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place; returns the norm before the
    clip. Where the global norm is at least ``max_norm`` every gradient is
    scaled by max_norm / norm (optax computes (g / norm) * max_norm, one
    rounding away; torch's ``clip_grad_norm_`` divides by norm + 1e-6).
    The choice is made on the device, with no host synchronisation, in a
    few launches for all the gradients together."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Clip by global norm, then Adam, then the StepLR schedule: one
    :meth:`step` per training step, the order of JAX ``make_optimizer``
    (``optax.chain(clip_by_global_norm, adam(schedule))``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.clip = cfg.gradient_clip_val
        self.adam = torch.optim.Adam(self.params, lr=cfg.learning_rate, eps=cfg.adam_eps)
        self.schedule = torch.optim.lr_scheduler.StepLR(
            self.adam, step_size=cfg.lr_decay_interval, gamma=cfg.lr_decay
        )

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip the gradients, update the parameters, advance the schedule;
        returns the global gradient norm before the clip."""
        norm = clip_by_global_norm_([p.grad for p in self.params if p.grad is not None], self.clip)
        self.adam.step()
        self.schedule.step()
        return norm


def step_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from integers, e.g. (seed, step)."""
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(seed))


def compute_loss(
    model: NeuralWaveshaping,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    phase_offset: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One forward + the multi-resolution STFT loss against the batch's
    audio. ``phase_offset``/``noise`` inject the randomness the generator
    would draw (tests)."""
    recon = model(batch["f0"], batch["control"], generator=generator,
                  phase_offset=phase_offset, noise=noise)
    return multi_resolution_stft_loss(recon, batch["audio"])


def train_step(
    model: NeuralWaveshaping,
    optimizer: Optimizer,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    phase_offset: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One gradient step -> {"loss", "grad_norm" (before the clip)}, as
    0-d tensors on the model's device (reading them waits for the step)."""
    optimizer.zero_grad()
    loss = compute_loss(model, batch, generator, phase_offset, noise)
    loss.backward()
    grad_norm = optimizer.step()
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}


class Trainer:
    """Holds the training state (the model's parameters, the optimizer, the
    step) on one device, and runs the loop.

    The model's parameters as given are the starting point: build it with
    a seeded ``generator`` for a seeded random init, or pass
    ``initial_params`` to :meth:`fit`. ``loggers`` (:mod:`.logging`) get
    the JAX trainer's metrics: ``train/loss`` (the window's mean),
    ``train/lr``, ``train/steps_per_sec`` and ``grad_norm`` (the window's
    mean, before the clip) every ``log_every_n_steps``, and at each
    validation ``val/loss`` and the first val batch's original and
    reconstructed audio."""

    def __init__(
        self,
        model: NeuralWaveshaping,
        cfg: TrainConfig,
        device="cuda",
        loggers: Sequence = (),
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if cfg.data_parallel and torch.cuda.device_count() > 1:
                raise NotImplementedError(
                    f"TrainConfig.data_parallel over {torch.cuda.device_count()} cards is "
                    "not ported yet (ROADMAP.md queue 1, Multi-GPU); make one card "
                    "visible or set TrainConfig.data_parallel = False"
                )
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        self.cfg = cfg
        self.loggers = list(loggers)
        self.optimizer = Optimizer(self.model.parameters(), cfg)
        self.step = 0

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {
            k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)).to(self.device)
            for k in ("audio", "f0", "control")
        }

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One step on a numpy batch, with this step's generator."""
        metrics = train_step(
            self.model, self.optimizer, self.to_device(batch),
            step_generator(self.cfg.seed, 0, self.step),
        )
        self.step += 1
        return metrics

    def _log(self, metrics: Dict[str, float]) -> None:
        for logger in self.loggers:
            logger.log_metrics(metrics, self.step)

    def evaluate(
        self, batches: Iterable[Dict[str, np.ndarray]], log_audio: bool = False
    ) -> float:
        """Mean loss over the batches, without gradients; batch i draws its
        randomness from a generator seeded with (seed, 1, i). With
        ``log_audio`` the first batch's first clip and its reconstruction
        go to the loggers as ``val/original`` and ``val/recon``."""
        losses = []
        with torch.no_grad():
            for i, batch in enumerate(batches):
                b = self.to_device(batch)
                recon = self.model(b["f0"], b["control"],
                                   generator=step_generator(self.cfg.seed, 1, i))
                losses.append(multi_resolution_stft_loss(recon, b["audio"]))
                if i == 0 and log_audio:
                    rate = int(self.model.sample_rate)
                    clips = (("val/original", b["audio"][0]), ("val/recon", recon[0]))
                    for name, clip in clips:
                        for logger in self.loggers:
                            logger.log_audio(name, clip.cpu().numpy(), rate, self.step)
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def save_checkpoint(
        self,
        path: str,
        data_mean: Optional[np.ndarray] = None,
        data_std: Optional[np.ndarray] = None,
    ) -> None:
        """The reference-format ``.ckpt`` at ``path``, with the dataset's
        ``data_mean.npy``/``data_std.npy`` beside it when given."""
        cfg = self.cfg
        hparams = {
            "n_waveshapers": self.model.newt.n_waveshapers,
            "control_hop": self.model.control_hop,
            "sample_rate": self.model.sample_rate,
            "learning_rate": cfg.learning_rate,
            "lr_decay": cfg.lr_decay,
            "lr_decay_interval": cfg.lr_decay_interval,
        }
        save_reference_checkpoint(self.model.params(), path, hparams, step=self.step)
        folder = os.path.dirname(os.path.abspath(path))
        for name, stat in (("data_mean.npy", data_mean), ("data_std.npy", data_std)):
            if stat is not None:
                np.save(os.path.join(folder, name), stat)

    def fit(self, datamodule, initial_params: Optional[Dict] = None) -> Dict[str, list]:
        """Train until ``cfg.max_steps``; validate every ``val_every_n_steps``
        and at the end, writing ``last.ckpt`` each time and ``best.ckpt``
        when the validation loss is the lowest yet (with the train split's
        statistics beside them) in ``cfg.checkpoint_dir``.

        ``initial_params`` (a JAX-layout tree) restarts from those weights
        with a fresh optimizer, as JAX ``train_state_from_params``.
        Returns the history: per-step "loss" and "grad_norm", and "val" as
        (step, loss) pairs. The per-step metrics stay on the device until
        a log step or a validation reads them, so no step waits for the
        host."""
        cfg = self.cfg
        if initial_params is not None:
            self.model.load_params(initial_params)
            self.optimizer = Optimizer(self.model.parameters(), cfg)
            self.step = 0
        train = datamodule.dataset("train")
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        history: Dict[str, list] = {"loss": [], "grad_norm": [], "val": []}
        pending: List[Dict[str, torch.Tensor]] = []
        window: Dict[str, list] = {"loss": [], "grad_norm": []}
        best = [float("inf")]
        window_start = [time.perf_counter()]
        schedule = make_lr_schedule(cfg)

        def flush():
            if pending:
                for key in ("loss", "grad_norm"):
                    values = torch.stack([m[key] for m in pending]).tolist()
                    history[key].extend(values)
                    window[key].extend(values)
                pending.clear()

        def log_window():
            flush()
            n = len(window["loss"])
            if not n:
                return
            now = time.perf_counter()
            self._log({
                "train/loss": float(np.mean(window["loss"])),
                "train/lr": schedule(self.step),
                "train/steps_per_sec": n / max(now - window_start[0], 1e-9),
                "grad_norm": float(np.mean(window["grad_norm"])),
            })
            window_start[0] = now
            for values in window.values():
                values.clear()

        def validate():
            flush()
            val_loss = self.evaluate(datamodule.val_batches(), log_audio=bool(self.loggers))
            history["val"].append((self.step, val_loss))
            self._log({"val/loss": val_loss})
            stats = (train.data_mean, train.data_std)
            self.save_checkpoint(os.path.join(cfg.checkpoint_dir, "last.ckpt"), *stats)
            if val_loss < best[0]:
                best[0] = val_loss
                self.save_checkpoint(os.path.join(cfg.checkpoint_dir, "best.ckpt"), *stats)

        epoch, validated_at = 0, None
        while self.step < cfg.max_steps:
            ran = 0
            for batch in datamodule.train_batches((cfg.seed, 2, epoch)):
                pending.append(self.train_step(batch))
                ran += 1
                if self.step % cfg.log_every_n_steps == 0:
                    log_window()
                if self.step % cfg.val_every_n_steps == 0:
                    validate()
                    validated_at = self.step
                if self.step >= cfg.max_steps:
                    break
            if not ran:
                raise ValueError("the train split gives no batch")
            epoch += 1
        if validated_at != self.step:
            validate()
        log_window()
        return history
