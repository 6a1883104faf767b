"""The port's training slice against the JAX package on the CPU: the
multi-resolution STFT loss, the LR schedule, the optimizer, one whole
training step, the shard dataset, and the checkpoints the Trainer writes.

Each tolerance is stated where it is used, with its reason."""
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.data import GeneralDataModule as JGeneralDataModule
from neural_waveshaping_synthesis_tpu.data.general import GeneralDataset as JGeneralDataset
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.ops.stft import spectrogram_magnitude as j_spectrogram_magnitude
from neural_waveshaping_synthesis_tpu.ops.windows import hann_window as j_hann_window
from neural_waveshaping_synthesis_tpu.training import TrainConfig as JTrainConfig
from neural_waveshaping_synthesis_tpu.training import make_optimizer as j_make_optimizer
from neural_waveshaping_synthesis_tpu.training.loss import (
    multi_resolution_stft_loss as j_multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu_torch.convert import (
    load_checkpoint,
    params_from_jax,
    save_reference_checkpoint,
)
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule, GeneralDataset
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.ops import hann_window, spectrogram_magnitude
from neural_waveshaping_synthesis_tpu_torch.training import (
    Optimizer,
    TrainConfig,
    Trainer,
    compute_loss,
    make_lr_schedule,
    multi_resolution_stft_loss,
    train_step,
)
CKPT = str(
    Path(__file__).resolve().parents[1] / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt"
)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", ["hann", None])
def test_spectrogram_magnitude_with_a_short_window_matches_jax(window):
    """A win_length < n_fft window zero-padded to n_fft, centered (the JAX
    _expand_window), and the sqrt(1e-8) floor; FFT rounding only:
    rtol 1e-5, atol 1e-5 (each bin sums up to 1024 samples)."""
    x = np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32)
    x[1] = 0.0  # a silent row: every bin sits on the floor
    w, jw = (hann_window(600), j_hann_window(600)) if window else (None, None)
    out = spectrogram_magnitude(torch.from_numpy(x), 1024, 120, 600, w).numpy()
    ref = np.asarray(j_spectrogram_magnitude(jnp.asarray(x), 1024, 120, 600, jw))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert np.all(out[1] == np.float32(np.sqrt(np.float32(1e-8))))


def _assert_f32_grad_close(ours, ref32, ref64, name=""):
    """A float32 gradient of the STFT loss against JAX's: within 1e-3
    normalised of JAX's float32 gradient, or no farther from JAX's float64
    gradient than JAX's own float32 gradient is. The log-magnitude L1 term
    divides by each bin's magnitude and flips sign where |log Y - log X|
    is near 0, so float32 rounding of the smallest bins shows up amplified
    in the gradient: JAX's float32 gradient (polyphase matmul DFT) is
    itself up to a few 1e-3 (the loss alone) and 5e-2 (a whole step) from
    its float64 one."""
    if _rel(ours, ref32) > 1e-3:
        assert _rel(ours, ref64) <= _rel(ref32, ref64), name


def test_mrstft_loss_and_gradient_match_jax():
    """The loss against the JAX loss (its polyphase matmul DFT against the
    port's framed FFT) at rtol 1e-4 in float32; its gradient as
    :func:`_assert_f32_grad_close` says in float32, and within 1e-3 in
    float64 (where the two differ by the last bits of their float32 Hann
    windows only: 1e-4 when written)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4000)) * 0.3
    y = rng.standard_normal((2, 4000)) * 0.3
    grads = {}
    for dtype in ("float32", "float64"):
        with jax.enable_x64(dtype == "float64"):
            ref, jgrad = jax.value_and_grad(
                lambda a: j_multi_resolution_stft_loss(a, jnp.asarray(y.astype(dtype)))
            )(jnp.asarray(x.astype(dtype)))
        xt = torch.from_numpy(x.astype(dtype)).requires_grad_()
        loss = multi_resolution_stft_loss(xt, torch.from_numpy(y.astype(dtype)))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4)
        grads[dtype] = xt.grad.numpy(), np.asarray(jgrad)
    ours64, ref64 = grads["float64"]
    assert _rel(ours64, ref64) <= 1e-3
    ours32, ref32 = grads["float32"]
    _assert_f32_grad_close(ours32, ref32, ref64)


def test_loss_is_zero_for_identical_inputs():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 4000)).astype(np.float32))
    assert float(multi_resolution_stft_loss(x, x)) == 0.0


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_optax():
    """Staircase 0.9 every 10,000 steps; optax evaluates it in float32,
    the port in float64: rtol 1e-6."""
    cfg = TrainConfig()
    ref = optax.exponential_decay(1e-3, 10000, 0.9, staircase=True)
    schedule = make_lr_schedule(cfg)
    for step in (0, 9999, 10000, 25000):
        np.testing.assert_allclose(schedule(step), float(ref(step)), rtol=1e-6)
    assert schedule(25000) == pytest.approx(1e-3 * 0.81)


def test_optimizer_matches_optax():
    """The same gradients fed for 4 steps to the port's clip + Adam +
    StepLR and to JAX make_optimizer, with the LR decaying every 2 steps
    and the clip active on steps 0 and 2 only. The port's clip scales by
    max_norm / norm, one rounding from optax's (g / norm) * max_norm (not
    torch's clip_grad_norm_, which divides by norm + 1e-6); torch's Adam
    and optax's adam differ only in rounding (torch lerps the first moment
    and divides the bias-corrected sqrt): params within rtol 1e-6."""
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    scales = [3.0, 0.1, 5.0, 0.2]  # global norms above / below the 2.0 clip
    grads = []
    for s in scales:
        g = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
        norm = np.sqrt(sum(float(np.sum(x * x)) for x in g))
        grads.append([x * np.float32(s / norm) for x in g])

    jcfg = JTrainConfig(lr_decay_interval=2)
    opt = j_make_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in init]
    state = opt.init(jparams)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    port = Optimizer(params, TrainConfig(lr_decay_interval=2))
    norms = []
    for g in grads:
        port.zero_grad()
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        norms.append(float(port.step()))
    np.testing.assert_allclose(norms, scales, rtol=1e-6)
    assert port.adam.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.9**2)
    for p, ref in zip(params, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# one whole training step
# ---------------------------------------------------------------------------
def _grad_tree(model: NeuralWaveshaping):
    """The model's gradients as a tree in the JAX layout: ``params()`` of
    a second model whose parameters hold the gradients."""
    holder = NeuralWaveshaping().to(next(model.parameters()).dtype)
    with torch.no_grad():
        for h, p in zip(holder.parameters(), model.parameters()):
            h.copy_(p.grad)
    return holder.params()


def _jax_step(dtype):
    """Loss and gradient tree of one JAX step (apply + loss) from the
    run120k_cr weights on the B=2, Tc=16 batch of :func:`_step_inputs`."""
    jparams, _, _, _ = load_reference_checkpoint(CKPT)
    f0, control, audio, offset, noise = _step_inputs(dtype)
    with jax.enable_x64(dtype == "float64"):
        jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), jparams)

        def loss_fn(p):
            recon = JNeuralWaveshaping().apply(p, f0, control, phase_offset=offset, noise=noise)
            return j_multi_resolution_stft_loss(recon, audio)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
        return float(loss), dict(_leaves(jax.tree_util.tree_map(np.asarray, grads)))


def _step_inputs(dtype):
    rng = np.random.default_rng(4)
    b, tc = 2, 16
    f0 = 220.0 * 2.0 ** rng.uniform(0, 2, (b, 1)) * np.linspace(1.0, 1.3, tc)
    control = rng.standard_normal((b, tc, 2))
    audio = rng.standard_normal((b, tc * 128)) * 0.1
    offset = rng.uniform(-np.pi, np.pi, 101)
    noise = rng.uniform(0, 1, tc * 128 - 1)
    return [a.astype(dtype) for a in (f0, control, audio, offset, noise)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_training_step_matches_jax(dtype):
    """Loss and gradients of one step from the run120k_cr weights (B=2,
    Tc=16, the same injected phase offsets and noise), against
    ``jax.value_and_grad`` of the JAX apply + loss: loss rtol 1e-5, each
    gradient leaf within 1e-3 normalised.

    float64 holds the gradient bar on every leaf (3.1e-4 at most when
    written): the step is the same function. In float32 each leaf is held
    as :func:`_assert_f32_grad_close` says: JAX's own float32 gradient is
    up to 5e-2 from its float64 one here (the reverb and the noise
    branch), the port's float32 one at most 1.2e-3 (when written)."""
    f0, control, audio, offset, noise = _step_inputs(dtype)
    ref_loss, ref = _jax_step(dtype)
    model = NeuralWaveshaping()
    model.load_params(params_from_jax(load_reference_checkpoint(CKPT)[0]))
    model.to(getattr(torch, dtype))
    batch = {"f0": torch.from_numpy(f0), "control": torch.from_numpy(control),
             "audio": torch.from_numpy(audio)}
    loss = compute_loss(model, batch, phase_offset=torch.from_numpy(offset),
                        noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    ours = {k: v.detach().numpy() for k, v in _leaves(_grad_tree(model))}
    assert ours.keys() == ref.keys() and len(ours) == 48
    exact = _jax_step("float64")[1] if dtype == "float32" else ref
    for name, g in ours.items():
        if dtype == "float64":
            assert _rel(g, ref[name]) <= 1e-3, name
        else:
            _assert_f32_grad_close(g, ref[name], exact[name], name)


def test_two_training_steps_match_jax():
    """Two steps of the port's train_step (loss, backward, clip, Adam,
    StepLR) against two of JAX value_and_grad + make_optimizer, from the
    run120k_cr weights with the same injected randomness per step, in
    float64: the second loss, which the first update decides, within rtol
    1e-4 (2.0e-5 when written). No longer: Adam's first steps move every
    parameter by about lr * sign(g), so the 1e-4 gradient differences of
    :func:`test_one_training_step_matches_jax` flip the updates of
    near-zero gradient entries; the third loss differs by 1e-3."""
    f0, control, audio, _, _ = _step_inputs("float64")
    rng = np.random.default_rng(5)
    draws = [(rng.uniform(-np.pi, np.pi, 101), rng.uniform(0, 1, 16 * 128 - 1)) for _ in range(2)]
    jparams = load_reference_checkpoint(CKPT)[0]
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jparams)
        opt = j_make_optimizer(JTrainConfig())
        state = opt.init(params)

        @jax.jit
        def step(p, st, o, n):
            def loss_fn(q):
                recon = JNeuralWaveshaping().apply(q, f0, control, phase_offset=o, noise=n)
                return j_multi_resolution_stft_loss(recon, audio)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, st = opt.update(grads, st, p)
            return optax.apply_updates(p, updates), st, loss

        ref_losses = []
        for o, n in draws:
            params, state, loss = step(params, state, o, n)
            ref_losses.append(float(loss))

    model = NeuralWaveshaping()
    model.load_params(params_from_jax(jparams))
    model.double()
    optimizer = Optimizer(model.parameters(), TrainConfig())
    batch = {"f0": torch.from_numpy(f0), "control": torch.from_numpy(control),
             "audio": torch.from_numpy(audio)}
    losses = [float(train_step(model, optimizer, batch, phase_offset=torch.from_numpy(o),
                               noise=torch.from_numpy(n))["loss"]) for o, n in draws]
    assert losses[1] < losses[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


# ---------------------------------------------------------------------------
# data and the Trainer
# ---------------------------------------------------------------------------
def _write_shards(root, tc=16, hop=128, splits=(("train", 6), ("val", 2)), seed=0):
    """A tiny dataset in the reference's shard layout."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        (root / split / "audio").mkdir(parents=True)
        (root / split / "control").mkdir(parents=True)
        for i in range(n):
            np.save(root / split / "audio" / f"audio_clip{i}.npy",
                    (rng.standard_normal(tc * hop) * 0.1).astype(np.float32))
            np.save(root / split / "control" / f"control_clip{i}.npy",
                    rng.standard_normal((19, tc)).astype(np.float32))
    mean = np.zeros((19, 1), np.float32)
    mean[0] = 300.0
    std = np.ones((19, 1), np.float32)
    std[0] = 50.0
    np.save(root / "data_mean.npy", mean)
    np.save(root / "data_std.npy", std)
    return str(root)


def test_general_dataset_matches_jax(tmp_path):
    """Items, index batches and the in-order val batches, bit for bit."""
    root = _write_shards(tmp_path / "data")
    ours, theirs = GeneralDataset(root, "train"), JGeneralDataset(root, "train")
    assert ours.names == theirs.names and len(ours) == 6
    np.testing.assert_array_equal(ours.audio, theirs.audio)
    np.testing.assert_array_equal(ours.control, theirs.control)
    for key in ("audio", "f0", "amp", "control", "name"):
        np.testing.assert_array_equal(ours[3][key], theirs[3][key])
    idx = np.array([4, 0, 2])
    for key in ("audio", "f0", "control"):
        np.testing.assert_array_equal(ours.batch(idx)[key], theirs.batch(idx)[key])
    dm, jdm = GeneralDataModule(root, batch_size=4), JGeneralDataModule(root, batch_size=4)
    for a, b in zip(dm.val_batches(), jdm.val_batches()):
        assert all(np.array_equal(a[k], b[k]) for k in ("audio", "f0", "control"))
    train = list(dm.train_batches((0, 2, 0)))
    assert len(train) == 1 and train[0]["audio"].shape == (4, 16 * 128)
    again = list(dm.train_batches((0, 2, 0)))
    assert np.array_equal(train[0]["audio"], again[0]["audio"])


def test_fit_writes_a_checkpoint_both_loaders_read(tmp_path):
    """Three steps of Trainer.fit on the CPU from the run120k_cr weights
    (``initial_params``); every parameter moves, and the last.ckpt it
    writes (and the statistics beside it) loads bit for bit with the
    port's load_checkpoint and with the JAX load_reference_checkpoint."""
    root = _write_shards(tmp_path / "data")
    cfg = TrainConfig(max_steps=3, val_every_n_steps=2, log_every_n_steps=1,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, device="cpu")
    initial = load_checkpoint(CKPT)[0]
    history = trainer.fit(GeneralDataModule(root, batch_size=2), initial_params=initial)
    assert trainer.step == 3 and len(history["loss"]) == 3 and np.all(np.isfinite(history["loss"]))
    assert [s for s, _ in history["val"]] == [2, 3]
    start = dict(_leaves(initial))
    assert all(not torch.equal(start[n], p) for n, p in _leaves(model.params()))
    expect = dict(_leaves(model.params()))
    path = str(tmp_path / "ckpt" / "last.ckpt")
    for loader in (load_checkpoint, load_reference_checkpoint):
        loaded, _, mean, std = loader(path)
        got = dict(_leaves(loaded))
        assert got.keys() == expect.keys()
        for name, t in expect.items():
            np.testing.assert_array_equal(np.asarray(got[name]), t.detach().numpy(), err_msg=name)
        np.testing.assert_array_equal(mean, GeneralDataset(root).data_mean)
        np.testing.assert_array_equal(std, GeneralDataset(root).data_std)


def test_training_steps_repeat_from_a_seed(tmp_path):
    """Per-step randomness comes from (seed, step): two runs from the same
    init and data give the same losses bit for bit."""
    root = _write_shards(tmp_path / "data", splits=(("train", 2), ("val", 1)))
    batch = GeneralDataset(root).batch(np.array([0, 1]))
    runs = []
    for _ in range(2):
        model = NeuralWaveshaping(generator=torch.Generator().manual_seed(1))
        trainer = Trainer(model, TrainConfig(), device="cpu")
        runs.append([float(trainer.train_step(batch)["loss"]) for _ in range(2)])
    assert runs[0] == runs[1] and runs[0][0] != runs[0][1]


def test_loading_a_lightning_checkpoint_leaves_no_stub_behind(tmp_path, monkeypatch):
    """A checkpoint that pickles pytorch_lightning classes loads without
    pytorch_lightning, and afterwards nothing answers for that package:
    stub modules left in sys.modules made torch's own probe for it (when
    torch.optim first imports torch._dynamo) crash in inspect."""
    import sys
    import types

    # the JAX package's loader leaves its own stub finder installed, and
    # what it has answered in sys.modules: both are set aside here
    monkeypatch.setattr(sys, "meta_path", [f for f in sys.meta_path
                                           if type(f).__name__ != "_StubFinder"])
    for name in [n for n in sys.modules if n.split(".")[0] == "pytorch_lightning"]:
        monkeypatch.delitem(sys.modules, name)
    names = ["pytorch_lightning", "pytorch_lightning.utilities", "pytorch_lightning.utilities.parsing"]
    for name in names:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    attribute_dict = type("AttributeDict", (dict,), {"__module__": names[-1]})
    sys.modules[names[-1]].AttributeDict = attribute_dict
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "pl.ckpt")
    save_reference_checkpoint(model.params(), path, hparams=attribute_dict(n_waveshapers=64))
    for name in names:
        monkeypatch.delitem(sys.modules, name)
    params, hparams, _, _ = load_checkpoint(path)
    assert hparams == {"n_waveshapers": 64}
    assert torch.equal(params["reverb"]["ir"], model.reverb.ir.detach())
    assert not any(n.split(".")[0] == "pytorch_lightning" for n in sys.modules)
    with pytest.raises(ImportError):
        import pytorch_lightning  # noqa: F401


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        Trainer(NeuralWaveshaping(), TrainConfig())
