"""The chunked runtime of the port's ``Trainer.fit`` (``MultiTrainStep``)
against JAX's (``training/trainer.py`` ``_chunk_length``, ``_gather_chunk``,
``make_multi_train_step``) and against an eager loop of ``train_step``, on
the CPU, where the chunk's step body runs in a Python loop: the bookkeeping
the card replays as a CUDA graph.

A narrow model (8 shapers; every other width the shipped one's) on 2 clips
of 16 frames, so that a step takes well under 0.1 s on one thread; the
resume, whose checkpoints hold the shipped architecture, at full width on
one clip of 9 frames. Every
comparison with the eager loop is bit for bit: the chunk runs the same step
on the same batches and draws. Against JAX, the rtol of
``test_two_training_steps_match_jax``."""
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.training import TrainConfig as JTrainConfig
from neural_waveshaping_synthesis_tpu.training import make_optimizer as j_make_optimizer
from neural_waveshaping_synthesis_tpu.training.loss import (
    multi_resolution_stft_loss as j_multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu.training.trainer import _chunk_length as j_chunk_length
from neural_waveshaping_synthesis_tpu_torch.convert import load_lightning_checkpoint
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import (
    MultiTrainStep,
    Optimizer,
    TrainConfig,
    Trainer,
    chunk_length,
)

from test_torch_training import _write_shards

SHAPERS = 8
BATCH = 2  # 6 train clips: 3 batches a pass


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread, so that every run of a step is the same bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _write_shards(tmp_path_factory.mktemp("chunked") / "data")


def _model(seed=0):
    return NeuralWaveshaping(n_waveshapers=SHAPERS, generator=torch.Generator().manual_seed(seed))


def _trainer(tmp_path, folder="ck", seed=0, dtype=torch.float32, **cfg):
    cfg.setdefault("checkpoint_dir", str(tmp_path / folder))
    return Trainer(_model(seed).to(dtype), TrainConfig(**cfg), device="cpu")


def _eager(trainer, data, steps):
    """An eager loop of ``Trainer.train_step`` over ``train_batches``, pass
    after pass -> (losses, grad norms)."""
    losses, norms, epoch = [], [], 0
    while len(losses) < steps:
        for batch in data.train_batches((trainer.cfg.seed, 2, epoch)):
            if len(losses) == steps:
                break
            metrics = trainer.train_step(batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        epoch += 1
    return losses, norms


class Spy:
    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, dict(metrics)))

    def log_audio(self, name, audio, rate, step):
        pass

    def steps(self, key):
        return [s for s, m in self.logged if key in m]


def _chunks(monkeypatch):
    """Record the length of every chunk ``MultiTrainStep.run`` runs."""
    sizes, run = [], MultiTrainStep.run

    def record(self, k):
        sizes.append(k)
        return run(self, k)

    monkeypatch.setattr(MultiTrainStep, "run", record)
    return sizes


@pytest.mark.parametrize("log, val", [(100, 1000), (2, 4), (1, 1), (1, 7), (7, 13), (128, 256),
                                      (250, 500), (131, 262), (1000, 3000), (384, 768)])
def test_chunk_length_is_jaxs(log, val):
    """JAX ``_chunk_length`` over gcds below, at and above 128, primes and 1:
    the recipe's (100, 1000) gives 100; gcd 250 gives 125, gcd 131 (a prime
    above 128) gives 1."""
    assert chunk_length(TrainConfig(log_every_n_steps=log, val_every_n_steps=val)) == \
        j_chunk_length(JTrainConfig(log_every_n_steps=log, val_every_n_steps=val))


def test_the_device_gather_is_jaxs_gather_and_the_eager_batches(root, tmp_path):
    """Two chunks of the order fit takes (the second crosses from the first
    pass into the next): the
    rows of ``train_rows`` gathered from the split ``device_split`` stages,
    against JAX's ``_gather_chunk`` (``v[idx]`` on the same split and index
    matrix) and against ``to_device`` of ``train_batches``' batches, bit for
    bit."""
    data = GeneralDataModule(root, batch_size=BATCH)
    trainer = _trainer(tmp_path)
    train = data.dataset("train")
    split = trainer.device_split(train)
    denorm = train.denormalize(train.control)
    j_split = {"audio": jnp.asarray(train.audio), "f0": jnp.asarray(denorm[:, :, 0]),
               "control": jnp.asarray(train.control)}
    stream = trainer._stream(data, "train_rows")
    eager = [b for epoch in (0, 1) for b in data.train_batches((0, 2, epoch))]
    jax_gather = jax.jit(lambda d, i: {key: v[i] for key, v in d.items()})
    shapes = {k: (BATCH, *v.shape[1:]) for k, v in split.items()}
    program = trainer._program_for(4, shapes)
    for first, k in ((0, 2), (2, 2)):
        index = np.stack([next(stream) for _ in range(k)])
        program.set_rows(index)
        program.gather(split, k)
        j_batches = jax_gather(j_split, index)
        for key in ("audio", "f0", "control"):
            got = program.batches[key][:k].numpy()
            np.testing.assert_array_equal(got, np.asarray(j_batches[key]))
            for i in range(k):
                np.testing.assert_array_equal(got[i], trainer.to_device(eager[first + i])[key].numpy())


def test_a_chunk_of_four_is_four_train_steps_bit_for_bit(root, tmp_path):
    """``MultiTrainStep.run(4)`` on a chunk gathered in memory against four
    calls of ``Trainer.train_step`` on the same batches from the same init:
    the losses, grad norms, parameters, Adam's state and the schedule, bit
    for bit, and the step counter at 4."""
    data = GeneralDataModule(root, batch_size=BATCH)
    eager = _trainer(tmp_path, "a")
    losses, norms = _eager(eager, data, 4)
    chunked = _trainer(tmp_path, "b")
    split = chunked.device_split(data.dataset("train"))
    program = chunked._program_for(4, {k: (BATCH, *v.shape[1:]) for k, v in split.items()})
    stream = chunked._stream(data, "train_rows")
    program.set_rows(np.stack([next(stream) for _ in range(4)]))
    program.gather(split, 4)
    got_losses, got_norms = program.run(4)
    assert got_losses.tolist() == losses and got_norms.tolist() == norms
    assert chunked.step == eager.step == 4
    for a, b in zip(chunked.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    for p, q in zip(chunked.optimizer.params, eager.optimizer.params):
        for key, v in chunked.optimizer.adam.state[p].items():
            assert torch.equal(v, eager.optimizer.adam.state[q][key]), key
    assert chunked.optimizer.schedule.state_dict() == eager.optimizer.schedule.state_dict()


def test_the_chunks_first_two_losses_match_a_jax_scan(root, tmp_path):
    """The chunk program's first two steps in float64 against a JAX
    ``lax.scan`` of ``value_and_grad`` + ``make_optimizer`` over the same two
    gathered batches, with the chunk's own draws (each step's phase offsets
    and noise) injected into ``apply``, from the same parameters: the two
    losses within rtol 1e-4, the bar of ``test_two_training_steps_match_jax``
    (the second loss is decided by the first update; Adam's sign-like first
    steps amplify the port's float32 LayerNorm statistics)."""
    data = GeneralDataModule(root, batch_size=BATCH)
    trainer = _trainer(tmp_path, dtype=torch.float64)
    params = jax.tree_util.tree_map(lambda t: t.detach().numpy().copy(), trainer.model.params())
    split = trainer.device_split(data.dataset("train"))
    program = trainer._program_for(2, {k: (BATCH, *v.shape[1:]) for k, v in split.items()})
    stream = trainer._stream(data, "train_rows")
    program.set_rows(np.stack([next(stream) for _ in range(2)]))
    program.gather(split, 2)
    losses, _ = program.run(2)
    batches = {k: v.numpy() for k, v in program.batches.items()}
    draws = {k: v.numpy() for k, v in program.draws.items()}

    model = JNeuralWaveshaping(n_waveshapers=SHAPERS, newt=JNEWT(n_waveshapers=SHAPERS))
    with jax.enable_x64(True):
        opt = j_make_optimizer(JTrainConfig())

        @jax.jit
        def scan(p, batches, draws):
            def body(carry, xs):
                q, state = carry
                batch, (offset, noise) = xs

                def loss_fn(r):
                    recon = model.apply(r, batch["f0"], batch["control"], phase_offset=offset,
                                        noise=noise)
                    return j_multi_resolution_stft_loss(recon, batch["audio"])

                loss, grads = jax.value_and_grad(loss_fn)(q)
                updates, state = opt.update(grads, state, q)
                return (optax.apply_updates(q, updates), state), loss

            p = jax.tree_util.tree_map(jnp.asarray, p)
            _, out = jax.lax.scan(body, (p, opt.init(p)), (batches, (draws["phase"], draws["noise"])))
            return out

        ref = np.asarray(scan(params, batches, draws))
    np.testing.assert_allclose(losses.numpy(), ref, rtol=1e-4)


@pytest.fixture(scope="module")
def eager_seven(root, tmp_path_factory):
    """7 eager steps from the init of :func:`_model` -> (losses, grad norms,
    the validation loss after them)."""
    eager = _trainer(tmp_path_factory.mktemp("eager"))
    losses, norms = _eager(eager, GeneralDataModule(root, batch_size=BATCH), 7)
    return losses, norms, eager.evaluate(GeneralDataModule(root, batch_size=BATCH).val_batches())


@pytest.mark.parametrize("load_to_memory", [True, False], ids=["in_memory", "lazy"])
def test_fit_keeps_jaxs_cadence_and_the_eager_losses(root, eager_seven, tmp_path, monkeypatch,
                                                     load_to_memory):
    """JAX ``test_lazy_chunked_path_stragglers_and_cadence`` on the port:
    max_steps 7, log every 2, validate every 4 (chunks of gcd 2), so 3 whole
    chunks and a 1-step tail: train metrics logged at steps [2, 4, 6, 7],
    validation at [4, 7] and the end-of-run save at 7. The history is the
    eager loop's bit for bit; the validations equal those of an eager
    ``evaluate`` at the same parameters."""
    data = GeneralDataModule(root, batch_size=BATCH, load_to_memory=load_to_memory)
    sizes = _chunks(monkeypatch)
    trainer = _trainer(tmp_path, max_steps=7, val_every_n_steps=4, log_every_n_steps=2)
    spy = Spy()
    trainer.loggers.append(spy)
    history = trainer.fit(data)
    assert spy.steps("train/loss") == [2, 4, 6, 7]
    assert spy.steps("val/loss") == [4, 7]
    assert sizes == [2, 2, 2, 1]
    assert trainer.step == 7
    assert load_lightning_checkpoint(str(tmp_path / "ck" / "last.ckpt"))["global_step"] == 7

    losses, norms, val = eager_seven
    assert history["loss"] == losses and history["grad_norm"] == norms
    assert history["val"][1] == (7, val)
    window = np.mean(losses[6:])
    assert [m["train/loss"] for s, m in spy.logged if "train/loss" in m][-1] == window


RESUME_CFG = {"val_every_n_steps": 4, "log_every_n_steps": 4, "lr_decay_interval": 5}


@pytest.fixture(scope="module")
def resume_root(tmp_path_factory):
    """4 train clips of 9 frames (the fewest the loss's 2048-point STFT
    pads) at batch 1: a pass of 4 steps."""
    return _write_shards(tmp_path_factory.mktemp("resume") / "data", tc=9,
                         splits=(("train", 4), ("val", 1)))


@pytest.fixture(scope="module")
def uninterrupted(resume_root, tmp_path_factory):
    """12 steps in chunks of 4 at full width (the checkpoints hold the
    shipped architecture) -> (the history, the final parameters)."""
    trainer = Trainer(_full_model(0), TrainConfig(
        max_steps=12, checkpoint_dir=str(tmp_path_factory.mktemp("whole")), **RESUME_CFG),
        device="cpu")
    history = trainer.fit(GeneralDataModule(resume_root, batch_size=1))
    return history, [p.detach().clone() for p in trainer.model.parameters()]


def _full_model(seed):
    return NeuralWaveshaping(generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("load_to_memory", [True, False], ids=["in_memory", "lazy"])
def test_a_run_resumed_from_mid_chunk_realigns_and_matches(resume_root, uninterrupted, tmp_path,
                                                           monkeypatch, load_to_memory):
    """Chunks of 4 (log and validate every 4), 4 steps a pass. A run stopped
    at max_steps 7 (in memory a chunk of 4 and a straggler chunk of 3; lazy
    a chunk and three single steps) saves at step 7, not a multiple of the
    chunk; a new Trainer on another seed's model restores it and runs to 12,
    across the pass that ends at step 8: a chunk of 1 realigns it, then one
    of 4, with train metrics and validation at 8 and 12. Its steps are the
    uninterrupted run's steps 8-12 bit for bit, and so are its validations
    and final parameters."""
    full, final = uninterrupted
    data = GeneralDataModule(resume_root, batch_size=1, load_to_memory=load_to_memory)
    sizes = _chunks(monkeypatch)
    folder = str(tmp_path / "parts")
    Trainer(_full_model(0), TrainConfig(max_steps=7, checkpoint_dir=folder, **RESUME_CFG),
            device="cpu").fit(data)
    assert sizes == ([4, 3] if load_to_memory else [4, 1, 1, 1])
    sizes.clear()
    resumed = Trainer(_full_model(3), TrainConfig(max_steps=12, checkpoint_dir=folder,
                                                  **RESUME_CFG), device="cpu")
    spy = Spy()
    resumed.loggers.append(spy)
    rest = resumed.fit(data, restore=True)
    assert sizes == [1, 4]
    assert spy.steps("train/loss") == [8, 12] and spy.steps("val/loss") == [8, 12]
    assert rest["loss"] == full["loss"][7:] and rest["grad_norm"] == full["grad_norm"][7:]
    assert rest["val"] == full["val"][1:]
    for a, b in zip(resumed.model.parameters(), final):
        assert torch.equal(a, b)


def test_a_card_optimizer_state_loads_on_the_cpu(tmp_path):
    """An optimizer state saved on the card (Adam ``capturable``) loads into
    the CPU's optimizer with the CPU's own setting, and the next step is the
    one the saving optimizer's CPU twin takes, bit for bit."""
    first = _trainer(tmp_path, "a")
    params = list(first.model.parameters())
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    first.optimizer.step()
    state = copy.deepcopy(first.optimizer.state_dict())
    state["adam"]["param_groups"][0]["capturable"] = True  # as the card writes it
    second = _trainer(tmp_path, "b")
    with torch.no_grad():
        for a, b in zip(second.model.parameters(), params):
            a.copy_(b)
    second._new_optimizer()
    second.optimizer.load_state_dict(state)
    assert second.optimizer.adam.param_groups[0]["capturable"] is False
    for opt in (first.optimizer, second.optimizer):
        for p in opt.params:
            p.grad = torch.full_like(p, -0.25)
        opt.step()
    for a, b in zip(second.model.parameters(), params):
        assert torch.equal(a, b)
    assert isinstance(Optimizer(params, TrainConfig()).lr, type(None))
