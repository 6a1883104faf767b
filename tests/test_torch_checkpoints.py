"""The port's checkpoint directory against the JAX trainer's policy (JAX
``tests/test_training.py``): the newest save is resumed, the best-on-val
save is evaluated, ``keep_n_checkpoints`` best saves are kept, a resume
keeps ``best.ckpt`` unless it does better; the saves still serve; and
``Trainer.test`` and the ``log_params`` hook. Small shapes on the CPU.

The validation losses of the policy tests are scripted (``Trainer.evaluate``
replaced), so that the order of the losses is the one each test names."""
import sys

import numpy as np
import pytest
import torch

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint, load_lightning_checkpoint
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import (
    TrainConfig,
    Trainer,
    checkpoint_index,
    select_eval_checkpoint,
)

from test_torch_training import CKPT, _leaves, _write_shards


def _trainer(tmp_path, seed=0, **cfg):
    cfg.setdefault("checkpoint_dir", str(tmp_path / "ck"))
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(seed))
    return Trainer(model, TrainConfig(**cfg), device="cpu")


def _script(trainer, losses):
    """Replace the trainer's validation by the given losses, in order."""
    it = iter(losses)
    trainer.evaluate = lambda batches, log_audio=False, prefix="val": next(it)


def _meta(path):
    ckpt = load_lightning_checkpoint(str(path))
    return ckpt["global_step"], ckpt["val_loss"]


def _files(folder):
    return sorted(p.name for p in folder.glob("*.ckpt"))


def test_resume_prefers_last_over_stale_best(tmp_path):
    """JAX ``test_resume_prefers_last_over_stale_best``: with keep 1, a save
    at step 2 (val 1.0) and a worse one at step 4 (val 2.0) leave the step-2
    save as the best-on-val one and the step-4 one as last.ckpt; a new
    Trainer (a new process) restores the newest step, 4."""
    trainer = _trainer(tmp_path, keep_n_checkpoints=1)
    for step, loss in ((2, 1.0), (4, 2.0)):
        trainer.step = step
        trainer.write_checkpoints(loss)
    folder = tmp_path / "ck"
    assert _files(folder) == ["best.ckpt", "last.ckpt", "step=2.ckpt"]
    assert _meta(folder / "step=2.ckpt") == _meta(folder / "best.ckpt") == (2, 1.0)
    assert _meta(folder / "last.ckpt") == (4, 2.0)
    fresh = _trainer(tmp_path, seed=1, keep_n_checkpoints=1)
    assert fresh.restore() and fresh.step == 4
    assert fresh.best_val_loss == 1.0 and fresh.saves == {2: 1.0}


def test_select_eval_step_prefers_best_on_val(tmp_path):
    """JAX ``test_select_eval_step_prefers_best_on_val``: with keep 2, the
    best-on-val save (step 2) is evaluated, not the newest (step 4), and an
    explicit step wins; a step with no save raises."""
    trainer = _trainer(tmp_path, keep_n_checkpoints=2)
    for step, loss in ((2, 1.0), (4, 2.0)):
        trainer.step = step
        trainer.write_checkpoints(loss)
    folder = str(tmp_path / "ck")
    assert _meta(select_eval_checkpoint(folder))[0] == 2
    assert select_eval_checkpoint(folder, 4).endswith("step=4.ckpt")
    assert _meta(select_eval_checkpoint(folder, 4))[0] == 4
    with pytest.raises(FileNotFoundError):
        select_eval_checkpoint(folder, 3)
    with pytest.raises(FileNotFoundError):
        select_eval_checkpoint(str(tmp_path))


def test_keep_n_keeps_the_best_saves_of_the_run(tmp_path):
    """Validation losses 3, 1, 2, 4 at steps 1-4 with keep 2: the saves of
    the 1 and the 2 (steps 2 and 3) stay, best.ckpt is the 1, last.ckpt the
    4; every save carries its val_loss."""
    root = _write_shards(tmp_path / "data")
    trainer = _trainer(tmp_path, max_steps=4, val_every_n_steps=1, log_every_n_steps=1,
                       keep_n_checkpoints=2)
    _script(trainer, [3.0, 1.0, 2.0, 4.0])
    history = trainer.fit(GeneralDataModule(root, batch_size=2))
    assert history["val"] == [(1, 3.0), (2, 1.0), (3, 2.0), (4, 4.0)]
    folder = tmp_path / "ck"
    assert _files(folder) == ["best.ckpt", "last.ckpt", "step=2.ckpt", "step=3.ckpt"]
    assert _meta(folder / "best.ckpt") == (2, 1.0)
    assert _meta(folder / "step=3.ckpt") == (3, 2.0)
    assert _meta(folder / "last.ckpt") == (4, 4.0)
    assert sorted(s for _, s, _ in checkpoint_index(str(folder))) == [2, 2, 3, 4]


def test_a_worse_validation_after_a_resume_leaves_best_alone(tmp_path):
    """fit to 2 (val 1.0), then a resumed fit to 4 whose validation is
    worse (2.0): best.ckpt stays the step-2 save, last.ckpt is step 4. A
    best-so-far reset at the resume would have overwritten it."""
    root = _write_shards(tmp_path / "data")
    data = GeneralDataModule(root, batch_size=2)
    first = _trainer(tmp_path, max_steps=2, val_every_n_steps=2)
    _script(first, [1.0])
    first.fit(data)
    resumed = _trainer(tmp_path, seed=1, max_steps=4, val_every_n_steps=2)
    _script(resumed, [2.0])
    resumed.fit(data, restore=True)
    folder = tmp_path / "ck"
    assert _meta(folder / "best.ckpt") == (2, 1.0)
    assert _meta(folder / "last.ckpt") == (4, 2.0)
    assert _files(folder) == ["best.ckpt", "last.ckpt", "step=2.ckpt", "step=4.ckpt"]


def test_the_saves_serve_and_both_loaders_read_them(tmp_path):
    """best.ckpt, last.ckpt and a step save of a fit, training state and
    all, give the same parameters to Synthesizer.from_checkpoint, the
    port's load_checkpoint and the JAX load_reference_checkpoint, bit for
    bit, with the statistics beside them."""
    root = _write_shards(tmp_path / "data")
    trainer = _trainer(tmp_path, max_steps=2, val_every_n_steps=2)
    trainer.fit(GeneralDataModule(root, batch_size=2))
    expect = {k: v.detach().numpy() for k, v in _leaves(trainer.model.params())}
    for name in ("best.ckpt", "last.ckpt", "step=2.ckpt"):
        path = str(tmp_path / "ck" / name)
        synth = Synthesizer.from_checkpoint(path, device="cpu")
        trees = [synth.model.params(), load_checkpoint(path)[0], load_reference_checkpoint(path)[0]]
        for tree in trees:
            got = {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
                   for k, v in _leaves(tree)}
            assert got.keys() == expect.keys()
            for k, v in expect.items():
                np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
        assert synth.data_mean is not None and synth.data_std is not None


def test_trainer_test_logs_the_test_split_loss(tmp_path):
    """Trainer.test -> the mean loss over test_batches, as evaluate gives
    it, logged as test/loss at the current step with the test audio."""
    root = _write_shards(tmp_path / "data", splits=(("train", 4), ("val", 2), ("test", 3)))
    logged, audio = [], []

    class Spy:
        def log_metrics(self, metrics, step):
            logged.append((step, metrics))

        def log_audio(self, name, clip, rate, step):
            audio.append((name, step))

    data = GeneralDataModule(root, batch_size=2)
    trainer = _trainer(tmp_path, max_steps=1)
    trainer.loggers.append(Spy())
    trainer.fit(data)
    loss = trainer.test(data)
    assert np.isfinite(loss) and loss == trainer.evaluate(data.test_batches())
    assert logged[-1] == (1, {"test/loss": loss})
    assert audio[-2:] == [("test/original", 1), ("test/recon", 1)]


def test_param_watching_called_at_val_cadence(tmp_path):
    """JAX ``test_param_watching_called_at_val_cadence``: a logger with a
    log_params hook gets host numpy arrays, in the JAX layout (the GRU's
    w_ih (in, 3H)), at every validation; a logger without it is left
    alone."""
    root = _write_shards(tmp_path / "data")
    calls = []

    class Watcher:
        def log_metrics(self, metrics, step):
            pass

        def log_audio(self, name, clip, rate, step):
            pass

        def log_params(self, params, step):
            leaves = [v for _, v in _leaves(params)]
            assert len(leaves) == 48 and all(isinstance(v, np.ndarray) for v in leaves)
            assert params["embedding"]["gru"]["w_ih"].shape == (2, 384)
            calls.append(step)

    class NoParams:
        def log_metrics(self, metrics, step):
            pass

        def log_audio(self, name, clip, rate, step):
            pass

    trainer = _trainer(tmp_path, max_steps=4, val_every_n_steps=2, log_every_n_steps=2)
    trainer.loggers += [Watcher(), NoParams()]
    trainer.fit(GeneralDataModule(root, batch_size=2))
    assert calls == [2, 4]


def test_the_ports_loader_leaves_no_stub_under_the_jax_stub_finder(monkeypatch):
    """With the JAX loader's stub finder on sys.meta_path (it leaves it
    there), the port's loader still leaves no pytorch_lightning module in
    sys.modules: a probe that imported the package got the JAX stub, which
    stayed, and made torch's first import of torch._dynamo (when the
    Trainer builds its optimizer) crash in inspect."""
    from neural_waveshaping_synthesis_tpu.convert.from_torch import _StubFinder as JStubFinder

    monkeypatch.setattr(sys, "meta_path", [JStubFinder()] + [
        f for f in sys.meta_path if type(f).__name__ != "_StubFinder"])
    for name in [n for n in sys.modules if n.split(".")[0] == "pytorch_lightning"]:
        monkeypatch.delitem(sys.modules, name)
    params = load_checkpoint(CKPT)[0]
    assert params["reverb"]["ir"].shape == (2 * 16000 - 1,)
    assert not any(n.split(".")[0] == "pytorch_lightning" for n in sys.modules)
