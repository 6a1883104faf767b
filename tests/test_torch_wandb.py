"""The port's WandbLogger against the JAX one, and ``--with-wandb`` of
``scripts/torch_train.py``, with a stub ``wandb`` module put in
``sys.modules`` (the logger imports wandb when it is built)."""
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_waveshaping_synthesis_tpu.training.logging import WandbLogger as JWandbLogger
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import WandbLogger

REPO = Path(__file__).resolve().parents[1]


class _Histogram:
    def __init__(self, values):
        self.values = np.asarray(values)


class _Audio:
    def __init__(self, audio, sample_rate, caption):
        self.audio, self.sample_rate, self.caption = np.asarray(audio), sample_rate, caption


@pytest.fixture
def stub(monkeypatch):
    """A wandb stand-in that records init's arguments and every log call."""
    module = types.ModuleType("wandb")
    module.logged, module.inits = [], []
    module.init = lambda **kw: module.inits.append(kw) or types.SimpleNamespace(**kw)
    module.log = lambda payload, step=None: module.logged.append((step, payload))
    module.Histogram, module.Audio = _Histogram, _Audio
    monkeypatch.setitem(sys.modules, "wandb", module)
    return module


def _host_params(seed=0):
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(seed))

    def to_np(tree):
        if isinstance(tree, dict):
            return {k: to_np(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_np(v) for v in tree]
        return np.ascontiguousarray(tree.detach().numpy())

    return to_np(model.params())


def test_wandb_logger_logs_metrics_audio_and_params(stub):
    logger = WandbLogger(name="run")
    assert stub.inits == [{"project": "neural-waveshaping-synthesis-tpu", "name": "run"}]
    logger.log_metrics({"train/loss": 1.5}, 3)
    clip = np.sin(np.linspace(0, 50, 800)).astype(np.float32)
    logger.log_audio("val/recon", clip, 16000, 3)
    logger.log_params(_host_params(), 3)
    (s0, metrics), (s1, audio), (s2, params) = stub.logged
    assert (s0, s1, s2) == (3, 3, 3) and metrics == {"train/loss": 1.5}
    wav = audio["audio/val/recon"]
    assert wav.sample_rate == 16000 and wav.caption == "val/recon" and np.array_equal(wav.audio, clip)
    assert len(params) == 49 and "parameters/embedding/gru/w_ih" in params
    assert params["parameters/embedding/gru/w_ih"].values.shape == (2 * 384,)


def test_log_params_matches_the_jax_logger(stub):
    """The same host parameters through both loggers: the same keys
    (parameters/<path> for the 48 tensors and parameters/global_norm),
    the same histogram values, and the global norm within rtol 1e-6 (both
    sum the squares in float64, in the same order)."""
    params = _host_params(1)
    WandbLogger().log_params(params, 5)
    JWandbLogger().log_params(params, 5)
    (_, ours), (_, theirs) = stub.logged
    assert ours.keys() == theirs.keys() and len(ours) == 49
    for k, v in ours.items():
        if k == "parameters/global_norm":
            np.testing.assert_allclose(v, theirs[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(v.values, theirs[k].values, err_msg=k)


def _cli():
    spec = importlib.util.spec_from_file_location("torch_train", REPO / "scripts" / "torch_train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cli_args(tmp_path):
    import chip_smoke

    root = chip_smoke.write_tone_dataset(tmp_path / "data", splits=(("train", 2), ("val", 2)), seconds=0.25)
    return ["--gin-file", "gin/train/train_newt.gin", "--dataset-path", root, "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs"),
            "-b", "TrainConfig.max_steps = 2", "-b", "GeneralDataModule.batch_size = 2",
            "-b", "TrainConfig.log_every_n_steps = 1", "-b", "TrainConfig.val_every_n_steps = 2",
            "--with-wandb"]


def test_cli_with_wandb_logs_the_run(stub, tmp_path):
    """--with-wandb adds the logger: the train metrics of both steps, the
    validation loss, its audio and the parameters at the validation."""
    gin.clear_config()
    try:
        assert _cli().main(_cli_args(tmp_path)) == 0
    finally:
        gin.clear_config()
    keys = {(step, k) for step, payload in stub.logged for k in payload}
    for expect in ((1, "train/loss"), (2, "train/loss"), (2, "val/loss"), (2, "audio/val/recon"),
                   (2, "parameters/global_norm"), (2, "parameters/newt/shaping_fn/input_scale")):
        assert expect in keys, expect


def test_cli_with_wandb_without_wandb_raises_import_error(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "wandb", None)
    gin.clear_config()
    try:
        with pytest.raises(ImportError):
            _cli().main(_cli_args(tmp_path))
    finally:
        gin.clear_config()
