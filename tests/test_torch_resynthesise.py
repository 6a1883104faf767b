"""``scripts/torch_resynthesise_dataset.py`` on the CPU: a dataset split
through a checkpoint into ``<name>.target.wav`` / ``<name>.output.wav``
pairs, as the JAX ``scripts/resynthesise_dataset.py`` writes them; each
clip's render and distance against the JAX model and loss; the best-on-val
save of a checkpoint directory; batch independence; FastNEWT.

The model is the run120k_cr checkpoint's on the smoke's tone dataset
(0.5-s clips, 5 in the test split)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.data import GeneralDataset as JGeneralDataset
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.training.loss import (
    multi_resolution_stft_loss as j_multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu.utils import write_wav as j_write_wav
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer

from test_torch_training import CKPT

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_resynthesise_dataset", REPO / "scripts" / "torch_resynthesise_dataset.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    import chip_smoke

    path = tmp_path_factory.mktemp("resynth") / "data"
    return chip_smoke.write_tone_dataset(
        path, splits=(("train", 2), ("val", 1), ("test", 5)), seconds=0.5)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A trainer's checkpoint directory: the run120k_cr weights saved at
    step 2 with val 1.0 (the best), a seeded random init at step 4 with
    val 2.0 (the newest)."""
    folder = tmp_path_factory.mktemp("ck")
    trainer = Trainer(NeuralWaveshaping(), TrainConfig(checkpoint_dir=str(folder)), device="cpu")
    trainer.model.load_params(load_checkpoint(CKPT)[0])
    trainer.step = 2
    trainer.write_checkpoints(1.0)
    random = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    trainer.model.load_params(random.params())
    trainer.step = 4
    trainer.write_checkpoints(2.0)
    return folder


def _run(script, root, out, checkpoint, *extra):
    gin.clear_config()
    try:
        return script.run(["--dataset-path", root, "--checkpoint", str(checkpoint),
                           "--output-path", str(out), "--device", "cpu", *extra])
    finally:
        gin.clear_config()


def _close_per_clip(a, b):
    """rtol 1e-6, and atol 1e-6 of the clip's peak for the samples near 0."""
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6 * np.abs(y).max())


def test_one_wav_pair_per_clip_and_the_targets_are_the_jax_scripts(script, root, tmp_path, capsys):
    """Every clip of the test split gives <name>.target.wav and
    <name>.output.wav; the target wavs are byte for byte JAX
    utils.write_wav's of the same audio; finite outputs of the clips'
    length; the per-clip distances and their mean are printed."""
    out = tmp_path / "out"
    result = _run(script, root, out, CKPT)
    names = [f"tone{i}" for i in range(5)]
    assert sorted(result["names"]) == names
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{n}.{kind}.wav" for n in names for kind in ("output", "target"))
    from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataset

    test = GeneralDataset(root, "test")
    for i, name in enumerate(test.names):
        j_write_wav(str(tmp_path / "jax.wav"), test.audio[i], 16000)
        assert (out / f"{name}.target.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
        assert result["outputs"][i].shape == test.audio[i].shape == (62 * 128,) and np.all(np.isfinite(result["outputs"][i]))
    assert len(result["distances"]) == 5 and np.all(np.isfinite(result["distances"]))
    assert "mean multi-res STFT distance" in capsys.readouterr().out


def test_each_clip_matches_the_jax_model_and_loss(script, root, tmp_path):
    """The script's renders against the JAX ``NeuralWaveshaping.apply`` of
    the same test split (JAX's own dataset), the run120k_cr weights, and
    the script's one phase-offset draw and one noise draw injected for
    every clip: each clip within 1e-3 nRMS (the port's model-render bar,
    tests/test_torch_model.py). Each printed distance against JAX's
    multi_resolution_stft_loss of the same (output, target) pair: rtol
    1e-4 (the port's loss bar, tests/test_torch_training.py). Observed
    when written: 2.6e-4 nRMS and 4.6e-7 relative at most."""
    result = _run(script, root, tmp_path / "out", CKPT, "--batch-size", "3")
    test = JGeneralDataset(root, "test")
    assert result["names"] == test.names
    batch = test.batch(np.arange(len(test)))
    assert result["phase_offset"].shape == (101,)
    assert result["noise"].shape == (batch["audio"].shape[1] - 1,)
    ref = np.asarray(jax.jit(
        lambda p, f, c, o, n: JNeuralWaveshaping().apply(p, f, c, phase_offset=o, noise=n)
    )(load_reference_checkpoint(CKPT)[0], batch["f0"], batch["control"],
      result["phase_offset"], result["noise"]))
    loss = jax.jit(j_multi_resolution_stft_loss)
    for i, out in enumerate(result["outputs"]):
        nrms = np.sqrt(np.mean((out - ref[i]) ** 2)) / np.sqrt(np.mean(ref[i] ** 2))
        assert nrms <= 1e-3, (i, nrms)
        j_distance = float(loss(out[None], batch["audio"][i][None]))
        np.testing.assert_allclose(result["distances"][i], j_distance, rtol=1e-4)


def test_a_clips_output_does_not_depend_on_its_batch(script, root, tmp_path):
    """--batch-size 3 (batches of 3 and 2) against 8 (one batch of 5): the
    same outputs per clip (rtol 1e-6; when written they differed by 6e-8
    at most, the CPU's matmuls at another batch size)."""
    a = _run(script, root, tmp_path / "b8", CKPT)
    b = _run(script, root, tmp_path / "b3", CKPT, "--batch-size", "3")
    assert a["names"] == b["names"]
    _close_per_clip(b["outputs"], a["outputs"])


def test_a_checkpoint_directory_gives_its_best_on_val_save(script, root, ckpt_dir, tmp_path):
    """From the directory the best-on-val save (step 2, the run120k_cr
    weights) renders, not the newest (step 4); --step 4 renders the step-4
    save; each as the .ckpt file itself does."""
    best = _run(script, root, tmp_path / "dir", ckpt_dir)
    assert Path(best["checkpoint"]).name == "best.ckpt"
    _close_per_clip(best["outputs"], _run(script, root, tmp_path / "file", CKPT)["outputs"])
    newest = _run(script, root, tmp_path / "step4", ckpt_dir, "--step", "4")
    assert Path(newest["checkpoint"]).name == "step=4.ckpt"
    by_file = _run(script, root, tmp_path / "file4", ckpt_dir / "step=4.ckpt")
    _close_per_clip(newest["outputs"], by_file["outputs"])
    assert not np.allclose(newest["outputs"][0], best["outputs"][0])


def test_fast_newt_renders_close_to_the_shaper_bank(script, root, tmp_path):
    """--use-fast-newt (the 4096-point table in place of the shaper bank):
    each clip within 1e-2 nRMS of the bank's render, the table's
    interpolation error at the output (1.05e-3 at most when written), and
    its own output independent of the batch (rtol 1e-6)."""
    bank = _run(script, root, tmp_path / "bank", CKPT)["outputs"]
    fast = _run(script, root, tmp_path / "fast", CKPT, "--use-fast-newt")["outputs"]
    for a, b in zip(fast, bank):
        assert np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)) <= 1e-2
        assert not np.array_equal(a, b)
    fast3 = _run(script, root, tmp_path / "fast3", CKPT, "--use-fast-newt", "--batch-size", "3")
    _close_per_clip(fast3["outputs"], fast)
