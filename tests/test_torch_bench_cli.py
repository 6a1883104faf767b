"""``scripts/torch_bench_data_path.py`` and ``scripts/torch_profile_loss.py``
on the CPU, against their JAX counterparts: the data-path bench's
``RateCapture`` against JAX's on scripted log windows and the CLI end to end
on a tiny shard dataset; the loss profile's inputs, its float32 value
against JAX's ``multi_resolution_stft_loss`` (rtol 1e-5) and its float64
oracle against JAX's in float64, and the CLI end to end."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu import minigin as jgin
from neural_waveshaping_synthesis_tpu.training.loss import (
    multi_resolution_stft_loss as j_multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu_torch import minigin as gin

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's tests, restored after: the test
    workers share the machine's cores, and torch's default of a thread per
    core in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_gin(monkeypatch):
    """Both minigins' bindings are process-wide: start and leave every test
    with none; the port's scripts import their siblings from scripts/."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    gin.clear_config()
    jgin.clear_config()
    yield
    gin.clear_config()
    jgin.clear_config()


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


@pytest.mark.parametrize("warmup", [0, 2, 5])
def test_rate_capture_matches_jax(warmup, monkeypatch):
    """The span rate over scripted windows (bursty log times, as a deferred
    fetch makes them), and the fallbacks for too few windows, as JAX's."""
    ours, theirs = _load("torch_bench_data_path").RateCapture(), _load("bench_data_path").RateCapture()
    for capture in (ours, theirs):
        times = iter([10.0, 10.5, 10.51, 12.0, 12.02, 14.5])
        monkeypatch.setattr("time.time", lambda: next(times))
        for step in (64, 128, 192, 256, 320, 384):
            capture.log_metrics({"train/loss": 1.0, "train/steps_per_sec": step / 7.0}, step)
        capture.log_metrics({"val/loss": 2.0}, 384)  # no rate: not a window
        capture.log_audio("x", np.zeros(4), 16000, 384)
    assert ours.windows == theirs.windows and len(ours.windows) == 6
    assert ours.span_rate(warmup) == theirs.span_rate(warmup)
    expected = {0: (384 - 64) / 4.5, 2: (384 - 192) / (14.5 - 10.51),
                5: (384 - 64) / 4.5}[warmup]  # one window left: all of them
    assert ours.span_rate(warmup) == pytest.approx(expected)
    one, jone = _load("torch_bench_data_path").RateCapture(), _load("bench_data_path").RateCapture()
    assert np.isnan(one.span_rate(0)) and np.isnan(jone.span_rate(0))


def test_bench_data_path_cli_on_the_cpu(tmp_path, capsys):
    """Both arms of ``Trainer.fit`` (in memory and lazy) a few steps on a
    tiny dataset, with the recipe's gin file: the JSON line with JAX's keys,
    the lazy_i16 arm reported as not ported."""
    root = _write_shards(tmp_path / "data")
    script = _load("torch_bench_data_path")
    assert script.main(["--dataset-path", root, "--batch-size", "2", "--steps", "6",
                        "--log-every", "2", "--warmup-windows", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    result = json.loads(lines[-1])
    assert set(result) == {"eager_steps_per_s", "lazy_steps_per_s", "eager_over_lazy"}
    assert result["eager_steps_per_s"] > 0 and result["lazy_steps_per_s"] > 0
    assert result["eager_over_lazy"] == pytest.approx(
        result["eager_steps_per_s"] / result["lazy_steps_per_s"], rel=1e-2)
    assert any(line.startswith("  eager steady-state") for line in lines)
    assert any(line.startswith("  lazy  steady-state") for line in lines)
    assert any("lazy_i16: not measured" in line for line in lines)
    assert "lazy_i16_steps_per_s" not in lines[-1]


def test_profile_loss_value_matches_jax():
    """The script's inputs are JAX's draws; its float32 loss equals JAX's
    ``multi_resolution_stft_loss`` on them at rtol 1e-5, its float64 oracle
    JAX's float64 loss at rtol 1e-7 (JAX's float32 Hann window)."""
    script = _load("torch_profile_loss")
    x, y = script.loss_inputs(2, 4000)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x, np.asarray(jnp.asarray(rng.standard_normal((2, 4000)) * 0.1,
                                                            jnp.float32)))
    np.testing.assert_array_equal(y, np.asarray(jnp.asarray(rng.standard_normal((2, 4000)) * 0.1,
                                                            jnp.float32)))
    ours = script.main_impl(2, 4000, 1, 2, 1, device="cpu")
    loss = jax.jit(j_multi_resolution_stft_loss)
    ref = float(loss(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(ours["value"], ref, rtol=1e-5)
    with jax.enable_x64(True):
        ref64 = float(loss(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)))
    np.testing.assert_allclose(ours["oracle"], ref64, rtol=1e-7)
    assert ours["value"] == pytest.approx(ours["oracle"], rel=1e-5)


def test_profile_loss_cli_on_the_cpu(capsys):
    """Every row of the port's profile, the oracle line and the note on
    JAX's TPU formulations."""
    script = _load("torch_profile_loss")
    assert script.main(["--batch-size", "1", "--n-samples", "2000", "--n-short", "1",
                        "--n-long", "2", "--repeats", "1", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    for row in ("loss_fwd ", "loss_fwd_bwd ", "res1024/120_fwd_bwd", "res2048/240_fwd_bwd",
                "res512/50_fwd_bwd"):
        assert f"  {row}" in text
    assert "oracle loss value (float64, CPU)" in text and "rel_err" in text
    assert "not ported" in text
    assert torch.get_default_dtype() == torch.float32
