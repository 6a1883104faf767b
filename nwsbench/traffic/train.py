"""Traffic ``train``: the recipe's training through the port's
``Trainer.fit`` on an in-memory split of tones drawn from the seed.

Set-up builds one Trainer and drives it through ``fit`` in calls that end
after step 1 (the eager warm-up, then the step's capture as a CUDA graph;
Adam's state gives the first gradient), step 3 (one chunk of two replays
of that graph, the one the window replays; the parameters' change) and the
first whole chunk (the chunk's rate read). The window is one further
``fit`` call of whole chunks, as many as that rate fills ``--seconds``
with; its validations fall as the recipe places them and one closes it.
The reference then follows the first three steps from the same weights,
batches and draws, and works out the losses of the two replayed steps
again at the program's own parameters before each: those after step 1,
kept, and those before step 3, undone from Adam's state after it.
"""
import contextlib
import dataclasses
import io
import os
import re
import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from nwsbench import contours, counts, harness, weights
from nwsbench.reference import train as ref_train

BETA1 = 0.9  # torch.optim.Adam's default, the recipe's


def make_split(seed: int, tag: int, n: int, mix: Dict, m: Dict, device) -> Dict[str, np.ndarray]:
    """n clips: audio (n, Ta), and the 19 control channels of the
    reference's datasets (f0 Hz, loudness dB, a confidence, 16 MFCC-like
    channels) in physical units, (n, Tc, 19)."""
    frames = mix["frames"]
    params = contours.draw_params(seed, (tag,), n, mix)
    f0, loud = contours.contour(params, np.arange(frames), m["sample_rate"] / m["control_hop"])
    audio = contours.tones(f0, loud, harness.seed_of(seed, tag), m["control_hop"],
                           m["sample_rate"], mix["tone_harmonics"], device)
    rng = np.random.default_rng([seed, tag, 1])
    extra = np.concatenate([rng.uniform(0.8, 1.0, (n, frames, 1)),
                            10.0 * rng.standard_normal((n, frames, 16))], axis=-1)
    control = np.concatenate([f0[..., None], loud[..., None], extra], axis=-1)
    return {"audio": audio, "control": control.astype(np.float32)}


def zscore(train: Dict, val: Dict):
    """The two splits' controls z-scored by the train split's per-channel
    statistics, as the port's datasets store them -> (train control, val
    control, mean (19, 1), std (19, 1)), float32."""
    flat = train["control"].reshape(-1, train["control"].shape[-1])
    mean = flat.mean(0)[:, None].astype(np.float32)
    std = flat.std(0)[:, None].astype(np.float32)
    return tuple(((s["control"] - mean.T) / std.T).astype(np.float32)
                 for s in (train, val)) + (mean, std)


def data_module(train: Dict, val: Dict, batch: int):
    """The port's data module over the two splits held in memory."""
    from neural_waveshaping_synthesis_tpu_torch.data.general import (
        GeneralDataModule,
        GeneralDataset,
    )

    train_ctrl, val_ctrl, mean, std = zscore(train, val)

    class Split(GeneralDataset):
        def __init__(self, name, audio, control):
            self.path, self.split, self.load_to_memory = "<memory>", name, True
            self.names = [str(i) for i in range(len(audio))]
            self.data_mean, self.data_std = mean, std
            self.audio, self.control = audio, control

    class Module(GeneralDataModule):
        def __init__(self):
            super().__init__("<memory>", batch_size=batch)
            self._splits = {"train": Split("train", train["audio"], train_ctrl),
                            "val": Split("val", val["audio"], val_ctrl)}

    return Module()


class _Window:
    """A logger for ``fit``: holds the window's ``nwsbench.train.fit`` span
    and stops the profiler at the first log after ``trace_s`` seconds of the
    window, closing the span first (a span still open when the profiler
    stops is not recorded)."""

    def __init__(self, tracer, trace_s: float):
        self.tracer, self.trace_s, self.t0, self.span = tracer, trace_s, None, None

    def open(self) -> None:
        self.t0 = time.perf_counter()
        self.span = harness.span("train.fit")
        self.span.__enter__()

    def close(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def log_metrics(self, metrics, step) -> None:
        if self.t0 is not None and self.tracer.active and "train/loss" in metrics \
                and time.perf_counter() - self.t0 >= self.trace_s:
            self.close()
            self.tracer.stop()

    def log_audio(self, *args) -> None:
        pass


def _host_stages(text: str) -> Dict[str, float]:
    """``[trainer] host profile: a: 0.123s | b: ...`` -> {a: seconds}."""
    lines = [l for l in text.splitlines() if l.startswith("[trainer] host profile:")]
    if not lines:
        return {}
    return {k: float(v) for k, v in re.findall(r"([\w+]+): ([0-9.]+)s", lines[-1])}


def _undo_step3(leaf: torch.Tensor, param: torch.Tensor, state: Dict, lr: float) -> torch.Tensor:
    """The program's ``leaf`` (a parameter or a view of one) before step 3,
    from the parameter and the moments Adam's step 3 left (a parameter Adam
    has not stepped keeps its value)."""
    moments = state.get(param, {})
    if "exp_avg" not in moments:
        return leaf.detach().clone()
    before = ref_train.undo_adam_step(param.detach(), moments["exp_avg"], moments["exp_avg_sq"],
                                      3, lr)
    if leaf is param:
        return before
    # a view (the GRU's weights, transposed): the same view of the result
    return before.as_strided(leaf.size(), leaf.stride(),
                             leaf.storage_offset() - param.storage_offset())


def run(ctx) -> Dict:
    from neural_waveshaping_synthesis_tpu_torch.training.trainer import TrainConfig, Trainer

    mix, m, dev = ctx.cell["traffic_params"], ctx.config["model"], ctx.device
    train = make_split(ctx.seed, 0, mix["train_clips"], mix, m, dev)
    val = make_split(ctx.seed, 1, mix["val_clips"], mix, m, dev)
    dm = data_module(train, val, mix["batch"])
    ctx.mark("set-up: splits made")
    tree = weights.draw(m, harness.seed_of(ctx.seed, 7), dev)
    model = harness.build_model(ctx.config, tree, dev, mix["fused"])
    ctx.mark("set-up: weights drawn, model built")
    folder = tempfile.mkdtemp(prefix="nwsbench-ckpt-")
    cfg = TrainConfig(learning_rate=mix["learning_rate"], gradient_clip_val=mix["gradient_clip"],
                      log_every_n_steps=mix["log_every_n_steps"],
                      val_every_n_steps=mix["val_every_n_steps"], max_steps=1,
                      checkpoint_dir=folder, seed=ctx.seed, data_parallel=False)
    window_logger = _Window(ctx.tracer, mix["trace_seconds"])
    trainer = Trainer(model, cfg, device=dev, loggers=[window_logger])
    with torch.no_grad():  # views with no autograd history, which would pin the
        leaves = weights.flatten(model.params())  # gradient accumulators to this stream
    params = {id(p): p for p in model.parameters()}

    def param_of(t):
        return params[id(t)] if id(t) in params else params[id(t._base)]

    try:
        ctx.mark("set-up: fit to step 1")
        losses = list(trainer.fit(dm)["loss"])
        state = trainer.optimizer.adam.state
        # a parameter Adam has not stepped has no state: its first moment is 0
        grad1 = {k: float(torch.linalg.vector_norm(
            state[param_of(v)].get("exp_avg", torch.zeros(())).double()) / (1.0 - BETA1))
            for k, v in leaves.items()}
        after1 = {k: v.detach().clone() for k, v in leaves.items()}
        program = trainer._program
        ctx.mark(f"set-up: step 1 done (its warm-up and the graph's capture, "
                 f"{getattr(program, 'capture_s', None)} s of capture)")
        trainer.cfg = dataclasses.replace(cfg, max_steps=3)
        losses += trainer.fit(dm)["loss"]
        ctx.mark("set-up: step 3 done")
        init = weights.flatten(tree)
        change3 = {k: float(torch.linalg.vector_norm((v.detach() - init[k]).double()))
                   for k, v in leaves.items()}
        before3 = {k: _undo_step3(v, param_of(v), state, mix["learning_rate"])
                   for k, v in leaves.items()}
        chunk = mix["log_every_n_steps"]
        trainer.cfg = dataclasses.replace(cfg, max_steps=chunk)
        t0 = time.perf_counter()
        trainer.fit(dm)
        rate = (chunk - 3) / (time.perf_counter() - t0)
        ctx.mark(f"set-up: first chunk done, {rate} steps/s")
        steps = max(1, round(ctx.seconds * rate / chunk)) * chunk
        trainer.cfg = dataclasses.replace(cfg, max_steps=chunk + steps)
        before = ctx.launch_counts()
        out = io.StringIO()
        ctx.window_start()
        if ctx.trace:
            os.environ["NWS_TPU_HOST_PROFILE"] = "1"
        ctx.tracer.start()
        window_logger.open()
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            history = trainer.fit(dm)
            window_s = time.perf_counter() - t0
        window_logger.close()
        ctx.tracer.stop()
        os.environ.pop("NWS_TPU_HOST_PROFILE", None)
        ctx.window_end()
        moved = ctx.launches_moved(before)
        window_losses = np.asarray(history["loss"], np.float64)
        n_val = len(history["val"])
        ctx.memory_peak()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    del trainer, model, leaves, params
    ctx.free()
    split = dm.dataset("train")
    ref = ref_train.first_steps(tree, m, split.audio, split.control, split.data_mean,
                                split.data_std, mix, ctx.seed, steps=3, device=dev,
                                tf32=False)
    replay = {s: ref_train.loss_at(tree, leaves_at, m, split.audio, split.control,
                                   split.data_mean, split.data_std, mix, ctx.seed, s, dev)
              for s, leaves_at in ((1, after1), (2, before3))}
    checks, note = harness.train_checks(losses, grad1, change3, ref, replay)
    ctx.note(note)
    bad = int(np.sum(~np.isfinite(window_losses)))
    rows = mix["batch"]
    frames = mix["frames"]
    step_flop = counts.train_step_flop(m, rows, frames)
    val_flop = counts.forward_flop(m, mix["val_clips"], frames) \
        + counts.loss_flop(m, mix["val_clips"], frames * m["control_hop"])
    return {
        "attempted": steps, "failed": bad,
        "e2e": {"train_steps_per_s": steps / window_s},
        "checks": checks,
        "layer": {"kind": "train", "window_s": window_s, "units": steps,
                  "flop": steps * step_flop + n_val * val_flop,
                  "host_stages_s": _host_stages(out.getvalue()),
                  "block_shape": (rows, frames), "launches_moved": moved,
                  "validations": n_val},
    }
