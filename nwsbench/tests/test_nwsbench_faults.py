"""Each fault that a cell can have, planted under a tiny run on the CPU
(the harness's look for a card skipped), makes ``correct`` come out false:
a step that returns its state unchanged; half of the batch left out, the
loss the mean over the rest, in every step or only in the steps after the
first (those that replay the captured step on the card); a chunk's slot
that does not advance; an answer altered where it is produced. (No cell
spans chips, so none can leave out an exchange between them.)"""
import numpy as np
import pytest
import torch

from neural_waveshaping_synthesis_tpu_torch.models.neural_waveshaping import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.streaming import synth as stream_synth
from neural_waveshaping_synthesis_tpu_torch.training import trainer

from conftest import tiny_run


def test_train_step_returning_its_state_unchanged(monkeypatch):
    def update(self):
        return clip_norm(self)

    def clip_norm(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        return torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))

    monkeypatch.setattr(trainer.Optimizer, "update", update)
    correct, rec = tiny_run("newt.train_b8")
    assert not correct
    assert rec["checks"]["change_gap"] == pytest.approx(1.0)


def test_train_half_the_batch(monkeypatch):
    real = trainer.compute_loss

    def half(model, batch, *args, **kwargs):
        rows = batch["f0"].shape[0] // 2
        return real(model, {k: v[:rows] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(trainer, "compute_loss", half)
    correct, rec = tiny_run("newt.train_b8")
    assert not correct
    assert rec["checks"]["loss1_gap"] > 1e-2


def _after_the_first_step(monkeypatch, fault):
    """Run ``fault(step_program)`` around each step body after the first:
    on the card those are the replays of the captured step."""
    real = trainer.MultiTrainStep._body

    def body(self):
        if self.trainer.step < 1:
            return real(self)
        return fault(self, real)

    monkeypatch.setattr(trainer.MultiTrainStep, "_body", body)


def test_train_half_the_batch_in_the_replayed_steps(monkeypatch):
    real_loss = trainer.compute_loss
    halving = [False]

    def loss(model, batch, *args, **kwargs):
        if halving[0]:
            batch = {k: v[:batch["f0"].shape[0] // 2] for k, v in batch.items()}
        return real_loss(model, batch, *args, **kwargs)

    def half(self, real):
        halving[0] = True
        try:
            real(self)
        finally:
            halving[0] = False

    monkeypatch.setattr(trainer, "compute_loss", loss)
    _after_the_first_step(monkeypatch, half)
    correct, rec = tiny_run("newt.train_b8")
    assert not correct
    assert rec["checks"]["loss1_gap"] < 1e-5  # step 1 is sound
    assert rec["checks"]["step2_loss_gap"] > 1e-2


def test_train_slot_not_advancing(monkeypatch):
    def stale(self, real):
        real(self)
        self.slot.sub_(1)

    _after_the_first_step(monkeypatch, stale)
    correct, rec = tiny_run("newt.train_b8")
    assert not correct
    assert rec["checks"]["loss1_gap"] < 1e-5  # step 1 is sound
    assert rec["checks"]["step3_loss_gap"] > 1e-2


@pytest.mark.parametrize("cell", ["fastnewt.render_b32", "newt.render_b32"])
def test_render_answer_altered(monkeypatch, cell):
    real = NeuralWaveshaping.forward

    def swapped(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        return torch.cat([out[1:2], out[:1], out[2:]])  # request 0 gets request 1's audio

    monkeypatch.setattr(NeuralWaveshaping, "forward", swapped)
    correct, rec = tiny_run(cell)
    assert not correct and rec["failed"] > 0


def test_stream_state_unchanged(monkeypatch):
    real = stream_synth.StreamingSynth.step

    def stale(self, state, *args, **kwargs):
        audio, _ = real(self, state, *args, **kwargs)
        return audio, state

    monkeypatch.setattr(stream_synth.StreamingSynth, "step", stale)
    correct, rec = tiny_run("newt.stream_live")
    assert not correct


def test_stream_buffer_altered(monkeypatch):
    real = stream_synth.StreamingSynth.step
    calls = []

    def altered(self, *args, **kwargs):
        audio, state = real(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 2:  # one buffer, every stream
            audio = audio * np.float32(1.01)
        return audio, state

    monkeypatch.setattr(stream_synth.StreamingSynth, "step", altered)
    correct, rec = tiny_run("newt.stream_live")
    assert not correct and rec["failed"] > 0
