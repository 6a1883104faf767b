"""The port's training state across processes: a JAX train state carried
into the port's optimizer, the checkpoint round trip, and a resumed run
against the run that was not interrupted. Small shapes on the CPU.

Each tolerance is stated where it is used, with its reason."""
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.training import TrainConfig as JTrainConfig
from neural_waveshaping_synthesis_tpu.training import make_optimizer as j_make_optimizer
from neural_waveshaping_synthesis_tpu_torch.convert import (
    parameters_from_tree,
    save_reference_checkpoint,
    train_state_from_jax,
)
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer

from test_torch_training import CKPT, _leaves, _write_shards


def _model(seed):
    return NeuralWaveshaping(generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# a JAX train state into the port
# ---------------------------------------------------------------------------
def _grad_trees(params, scales, seed):
    """Seeded random gradient trees shaped like ``params``, each scaled to
    the given global norm."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    trees = []
    for s in scales:
        g = [rng.standard_normal(np.shape(x)).astype(np.float32) for x in leaves]
        norm = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g))
        trees.append(jax.tree_util.tree_unflatten(treedef, [x * np.float32(s / norm) for x in g]))
    return trees


def test_a_jax_train_state_takes_the_next_update_as_optax_does():
    """The whole model's JAX parameter tree (the run120k_cr weights) takes
    3 ``make_optimizer`` updates with the LR decaying every 2 steps and the
    clip active on the first only; the state is carried over with
    ``train_state_from_jax`` and both take the 4th update. The carried
    moments equal optax's mu and nu bit for bit (a layout map, no
    arithmetic), the GRU's transposed matrices among them; after the 4th
    update every parameter agrees within rtol 1e-6, the bar of
    ``test_optimizer_matches_optax`` (torch's Adam and optax's adam differ
    in rounding only), plus atol 2e-5 * lr for the parameters whose value
    is near the size of one step: optax computes Adam's bias correction
    1 - 0.999^t in float32, from 0.999 rounded to float32, which at t = 4
    is 1.3e-5 off and moves its step by that share (8.4e-9 = 0.93e-5 * lr
    needed when written, on the reverb's IR)."""
    jparams = jax.tree_util.tree_map(jnp.asarray, load_reference_checkpoint(CKPT)[0])
    grads = _grad_trees(jparams, [3.0, 0.5, 1.5, 0.7], seed=6)
    jcfg = JTrainConfig(lr_decay_interval=2)
    opt = j_make_optimizer(jcfg)
    state = opt.init(jparams)
    for g in grads[:3]:
        updates, state = opt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    host = jax.device_get({"params": jparams, "opt_state": state, "step": jnp.asarray(3)})

    cfg = TrainConfig(lr_decay_interval=2)
    model = _model(0)
    trainer = Trainer(model, cfg, device="cpu")
    trainer.load_train_state(*train_state_from_jax(host, model, cfg))
    assert trainer.step == 3
    assert trainer.optimizer.schedule.last_epoch == 3
    assert trainer.optimizer.adam.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.9)
    adam = host["opt_state"][1][0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        expect = parameters_from_tree(model, tree)
        for p, e in zip(trainer.optimizer.params, expect):
            assert torch.equal(trainer.optimizer.adam.state[p][key], e), key
            assert float(trainer.optimizer.adam.state[p]["step"]) == 3.0
    gru = model.embedding.gru.rnn.weight_ih_l0
    np.testing.assert_array_equal(trainer.optimizer.adam.state[gru]["exp_avg"].numpy(),
                                  np.asarray(adam.mu["embedding"]["gru"]["w_ih"]).T)

    updates, state = opt.update(grads[3], state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    trainer.optimizer.zero_grad()
    for p, g in zip(trainer.optimizer.params, parameters_from_tree(model, grads[3])):
        p.grad = g
    trainer.optimizer.step()
    ours = dict(_leaves(model.params()))
    ref = dict(_leaves(jax.device_get(jparams)))
    assert ours.keys() == ref.keys() and "/embedding/gru/w_ih" in ours and len(ours) == 48
    for name, t in ours.items():
        np.testing.assert_allclose(t.detach().numpy(), ref[name], rtol=1e-6, atol=2e-5 * 9e-4,
                                   err_msg=name)


def test_train_state_from_jax_refuses_a_state_without_moments():
    with pytest.raises(ValueError, match="Adam moments"):
        train_state_from_jax({"params": {}, "opt_state": ((),), "step": 0}, _model(0), TrainConfig())


# ---------------------------------------------------------------------------
# the checkpoint round trip
# ---------------------------------------------------------------------------
def _state(trainer):
    """Every tensor and counter of a trainer's training state."""
    opt = trainer.optimizer
    out = {f"param{name}": t.detach().clone() for name, t in _leaves(trainer.model.params())}
    for i, p in enumerate(opt.params):
        for key, v in opt.adam.state[p].items():
            out[f"adam{i}/{key}"] = v.clone()
    out["lr"] = opt.adam.param_groups[0]["lr"]
    out["schedule"] = {k: v for k, v in opt.schedule.state_dict().items()}
    out["step"] = trainer.step
    return out


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_a_checkpoint_restores_every_tensor_and_counter_bit_for_bit(tmp_path):
    """Three steps, then save_checkpoint; a new Trainer on a model of
    another seed loads it: the parameters, Adam's moments and step count,
    the learning rate, StepLR's state and the step, bit for bit; and the
    next step of both gives the same loss bit for bit."""
    root = _write_shards(tmp_path / "data")
    batch = GeneralDataModule(root, batch_size=2).dataset("train").batch(np.arange(2))
    cfg = TrainConfig(lr_decay_interval=2)
    first = Trainer(_model(0), cfg, device="cpu")
    for _ in range(3):
        first.train_step(batch)
    path = str(tmp_path / "state.ckpt")
    first.save_checkpoint(path, val_loss=1.5)
    second = Trainer(_model(7), cfg, device="cpu")
    assert second.load_checkpoint(path) == 1.5
    _assert_same_state(_state(first), _state(second))
    assert second.optimizer.adam.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.9)
    assert float(first.train_step(batch)["loss"]) == float(second.train_step(batch)["loss"])


def test_a_checkpoint_without_the_training_state_is_refused(tmp_path):
    """A checkpoint the port wrote before it saved the training state (the
    weights only) is not resumed with fresh moments: fit(restore=True)
    raises, naming the missing keys."""
    root = _write_shards(tmp_path / "data")
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    save_reference_checkpoint(_model(0).params(), str(ckpt_dir / "last.ckpt"), step=4)
    trainer = Trainer(_model(1), TrainConfig(max_steps=6, checkpoint_dir=str(ckpt_dir)), device="cpu")
    with pytest.raises(ValueError, match=r"optimizer_states.*lr_schedulers.*val_loss"):
        trainer.fit(GeneralDataModule(root, batch_size=2), restore=True)
    assert trainer.step == 0


# ---------------------------------------------------------------------------
# a resumed run against one that was not interrupted
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("load_to_memory", [True, False], ids=["eager", "lazy"])
def test_a_resumed_run_is_bit_identical_to_an_uninterrupted_one(tmp_path, load_to_memory):
    """fit to 8 steps (validation every 4; 3 batches an epoch, so step 8 is
    in the middle of epoch 2), then a new Trainer on a model of another
    seed, fit(restore=True) to 12, against one fit to 12: the per-step
    losses and gradient norms of steps 9-12, the validation losses, the
    final parameters, Adam's moments and step count, the learning rate and
    StepLR's state, bit for bit. The LR decays every 5 steps, so the
    resumed run crosses a decay."""
    root = _write_shards(tmp_path / "data")
    data = GeneralDataModule(root, batch_size=2, load_to_memory=load_to_memory)
    assert data.n_batches("train") == 3

    def cfg(steps, folder):
        return TrainConfig(max_steps=steps, val_every_n_steps=4, log_every_n_steps=4,
                           lr_decay_interval=5, checkpoint_dir=str(tmp_path / folder))

    whole = Trainer(_model(0), cfg(12, "whole"), device="cpu")
    full = whole.fit(data)
    Trainer(_model(0), cfg(8, "parts"), device="cpu").fit(data)
    resumed = Trainer(_model(3), cfg(12, "parts"), device="cpu")
    rest = resumed.fit(data, restore=True)
    assert full["loss"][8:] == rest["loss"] and len(rest["loss"]) == 4
    assert full["grad_norm"][8:] == rest["grad_norm"]
    assert full["val"][2:] == rest["val"] == [(12, rest["val"][0][1])]
    _assert_same_state(_state(whole), _state(resumed))
    assert resumed.optimizer.adam.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.81)


def test_restore_with_nothing_on_disk_starts_fresh(tmp_path, capsys):
    """fit(restore=True) in an empty directory trains from the model as
    given, as JAX does, and says so."""
    root = _write_shards(tmp_path / "data")
    model = _model(0)
    start = [p.detach().clone() for p in model.parameters()]
    trainer = Trainer(model, TrainConfig(max_steps=1, checkpoint_dir=str(tmp_path / "ck")),
                      device="cpu")
    fresh = Trainer(_model(0), TrainConfig(max_steps=1, checkpoint_dir=str(tmp_path / "ck2")),
                    device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(start, fresh.model.parameters()))
    data = GeneralDataModule(root, batch_size=2)
    assert trainer.fit(data, restore=True)["loss"] == fresh.fit(data)["loss"]
    assert "no checkpoint in" in capsys.readouterr().out
    assert Path(tmp_path / "ck" / "last.ckpt").exists()
