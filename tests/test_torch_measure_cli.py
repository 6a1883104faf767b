"""The port's measurement CLIs on the CPU: ``scripts/torch_time_forward_pass.py``,
``torch_time_buffer_sizes.py``, ``torch_serving_capacity.py``,
``torch_time_train_step.py``, ``torch_profile_train_step.py`` and
``torch_profile_streaming_step.py``. Each one's inputs against the arrays its
JAX counterpart draws (caught where the JAX script hands them to
``jnp.asarray``, its model's init and compile stubbed out), the time-train-step
CLI's first loss against JAX's from JAX's initial train state, and each CLI
end to end with ``--device cpu``, called in-process through ``main(argv)``."""
import csv
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neural_waveshaping_synthesis_tpu.training as jtraining
from neural_waveshaping_synthesis_tpu import minigin as jgin
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.streaming import StreamingSynth as JStreamingSynth
from neural_waveshaping_synthesis_tpu.training.loss import (
    multi_resolution_stft_loss as j_multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's tests, restored after: the test
    workers share the machine's cores, and torch's default of a thread per
    core in each oversubscribes them (the CLIs' many small operators then
    wait on each other's threads)."""
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


class _Caught(Exception):
    pass


def _jax_inputs(monkeypatch, script, argv, n):
    """The first ``n`` arrays the JAX ``scripts/<script>.py`` hands
    ``jnp.asarray`` from its own code (as numpy, in the dtype asked for),
    the script stopped there. Its model's init and stream state are stubbed:
    the draws come before anything reads them."""
    real, got = jnp.asarray, []
    path = str(SCRIPTS / f"{script}.py")

    def catch(x, dtype=None, *args, **kwargs):
        if sys._getframe(1).f_code.co_filename == path:
            got.append(np.asarray(x, dtype=dtype))
            if len(got) == n:
                raise _Caught
        return real(x, dtype, *args, **kwargs)

    with monkeypatch.context() as patch:
        patch.setattr(jnp, "asarray", catch)
        patch.setattr(JNeuralWaveshaping, "init", lambda self, key: {})
        patch.setattr(JStreamingSynth, "init_state", lambda self, *a: None)
        patch.setattr(JStreamingSynth, "ir_partition_spectra", lambda self, *a: None)
        patch.setattr(jtraining, "init_train_state", lambda *a: {"params": None})
        with pytest.raises(_Caught):
            _load(script).main.main(argv, standalone_mode=False)
    return got


def _assert_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_time_forward_pass_inputs_are_jax_draws(monkeypatch):
    theirs = _jax_inputs(monkeypatch, "time_forward_pass",
                         ["--batch-size", "2", "--length-in-seconds", "1.0"], 2)
    _assert_equal(_load("torch_time_forward_pass").forward_inputs(2, 125), theirs)


def test_time_buffer_sizes_inputs_are_jax_draws(monkeypatch):
    """Two buffer sizes in turn from one generator (the JAX script's
    compiled forward stubbed to hand back zeros)."""
    with monkeypatch.context() as patch:
        patch.setattr(jax, "jit", lambda f, *a, **k: lambda *x, **y: np.zeros((1, 1)))
        theirs = _jax_inputs(patch, "time_buffer_sizes",
                             ["--buffers", "256,512", "--iterations", "1", "--warmup", "0",
                              "--output-csv", "/dev/null"], 4)
    module = _load("torch_time_buffer_sizes")
    rng = np.random.default_rng(0)
    _assert_equal([a for frames in (2, 4) for a in module.buffer_inputs(rng, frames)], theirs)


def test_serving_capacity_inputs_are_jax_draws(monkeypatch):
    """The first batch size's first push (the JAX script compiles its step
    on those before its pipeline draws the rest of the set)."""
    theirs = _jax_inputs(monkeypatch, "serving_capacity", ["--batches", "3"], 2)
    f0s, ctrls = _load("torch_serving_capacity").stream_inputs(np.random.default_rng(0), 3, 8)
    _assert_equal([f0s[0], ctrls[0]], theirs)


def test_time_train_step_inputs_are_jax_draws(monkeypatch):
    theirs = _jax_inputs(monkeypatch, "time_train_step",
                         ["--batch-size", "2", "--n-frames", "20", "--scan-steps", "3"], 3)
    ours = _load("torch_time_train_step").train_batches(3, 2, 20, 128)
    _assert_equal([ours["audio"], ours["f0"], ours["control"]], theirs)


def test_profile_train_step_inputs_are_jax_draws(monkeypatch):
    theirs = _jax_inputs(monkeypatch, "profile_train_step",
                         ["--batch-size", "2", "--n-frames", "20"], 6)
    _assert_equal(_load("torch_profile_train_step").probe_inputs(2, 20, 128, 64, 128), theirs)


def test_profile_streaming_step_inputs_are_jax_draws(monkeypatch):
    """JAX's audio-rate FiLM draw, of which the port's shaper stage takes
    the first K rows as its control-rate frames; JAX takes the magnitude's
    abs after the cast."""
    f0, control, exciter, film_aud, emb, h_raw, dry = _jax_inputs(
        monkeypatch, "profile_streaming_step", ["--batch-streams", "2", "--buffer-size", "256"], 7)
    ours = _load("torch_profile_streaming_step").probe_inputs(2, 2, 128, 64, 128, 129)
    _assert_equal(ours, [f0, control, exciter, film_aud[:, :2], emb, np.abs(h_raw), dry])


def test_time_train_step_first_loss_matches_jax_compute_loss():
    """The CLI's step loop on its first batch at 1 x 20 frames, from JAX's
    ``init_train_state(PRNGKey(0))`` carried over by ``params_from_jax`` and
    with the phase offsets and noise injected, gives JAX's loss of the same
    batch, draws and parameters within rtol 1e-5 (PERF.md section 2's
    one-step bar)."""
    module = _load("torch_time_train_step")
    module.parse_gin(["gin/train/train_newt.gin"], [])
    jgin.parse_config_file(str(REPO / "gin/train/train_newt.gin"))
    jmodel = JNeuralWaveshaping()
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jtraining.init_train_state(jmodel, jtraining.TrainConfig(), key)["params"]
    )(jax.random.PRNGKey(0)))
    batches = module.train_batches(1, 1, 20, 128)
    rng = np.random.default_rng(9)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, 20 * 128 - 1).astype(np.float32)
    ref = float(jax.jit(lambda p: j_multi_resolution_stft_loss(jmodel.apply(
        p, batches["f0"][0], batches["control"][0], phase_offset=offset, noise=noise),
        batches["audio"][0]))(jparams))

    model = NeuralWaveshaping()
    model.load_params(params_from_jax(jparams))
    trainer = Trainer(model, TrainConfig(), device="cpu")
    losses = module.run_steps(trainer, batches,
                              draws=[(torch.from_numpy(offset), torch.from_numpy(noise))])
    assert losses.shape == (1,) and trainer.step == 1
    np.testing.assert_allclose(float(losses[0]), ref, rtol=1e-5)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_time_forward_pass_cli(capsys):
    """JAX's CLI test's iterations at a quarter of its 1-s length (the CPU
    forward dominates this file's time)."""
    assert _load("torch_time_forward_pass").main(
        ["--iterations", "3", "--length-in-seconds", "0.25", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("Queued loop", "x realtime", "DescribeResult", "Mean host-round-trip RTF",
                 "90th percentile RTF", "[launches] none"):
        assert line in out, line
    assert "Device-only" not in out


def test_time_forward_pass_cli_fast_newt_throughput(capsys):
    assert _load("torch_time_forward_pass").main(
        ["--iterations", "2", "--length-in-seconds", "0.5", "--use-fast-newt", "--async-pipeline",
         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fast_newt=True" in out and "Throughput mode" in out


def test_time_buffer_sizes_cli(tmp_path, capsys):
    """Stateless forwards, then the streaming step with its queued loop, the
    card's busy time (not measured on the CPU: NaN) and the pipelined
    cadence; JAX's CSV columns."""
    module = _load("torch_time_buffer_sizes")
    out_csv = tmp_path / "bt.csv"
    assert module.main(["--buffers", "256", "--iterations", "3", "--warmup", "1",
                        "--output-csv", str(out_csv), "--device", "cpu"]) == 0
    rows = _rows(out_csv)
    assert list(rows[0]) == ["model", "device", "buffer_size", "seconds"] and len(rows) == 3
    assert rows[0]["model"] == "newt_torch_stateless" and rows[0]["device"] == "cpu"
    assert module.main(["--streaming", "--buffers", "256", "--iterations", "3", "--warmup", "1",
                        "--pipeline-depth", "2", "--output-csv", str(out_csv),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("buffer    256: p50", "queued-loop step", "pipelined cadence (depth 2)",
                 "device busy per step:     nan"):
        assert line in out, line
    summary = _rows(tmp_path / "bt_summary.csv")
    assert list(summary[0])[:13] == [
        "model", "device", "buffer_size", "p50_ms", "p95_ms", "device_step_ms",
        "host_rtt_p50_ms", "host_rtt_p95_ms", "pipeline_depth", "pipelined_cadence_p50_ms",
        "pipelined_cadence_p95_ms", "first_buffer_latency_ms", "budget_ms"]
    assert summary[0]["device_step_ms"] == "nan" and float(summary[0]["budget_ms"]) == 16.0


def test_serving_capacity_cli(tmp_path, capsys):
    """JAX's CLI test: batches 1 and 2 on the int16 wire, the CSV's columns."""
    out_csv = tmp_path / "cap.csv"
    assert _load("torch_serving_capacity").main(
        ["--batches", "1,2", "--iterations", "6", "--warmup", "2", "--fetch-int16",
         "--output-csv", str(out_csv), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "capacity:" in out and "on one cpu" in out and "link (pre-sweep)" in out
    rows = _rows(out_csv)
    assert list(rows[0]) == [
        "device", "wire_dtype", "buffer_size", "batch_streams", "pipeline_depth",
        "cadence_p50_ms", "cadence_p95_ms", "first_buffer_latency_ms", "budget_ms", "realtime",
        "aggregate_msamples_per_s", "link_rtt_ms", "link_fetch_mbps", "link_state"]
    assert [r["batch_streams"] for r in rows] == ["1", "2"]
    assert all(r["wire_dtype"] == "int16" and float(r["cadence_p50_ms"]) > 0
               and float(r["budget_ms"]) == 64.0 and r["link_state"] == "not measured"
               for r in rows)


def test_time_train_step_cli(tmp_path, capsys):
    assert _load("torch_time_train_step").main(
        ["--batch-size", "1", "--n-frames", "20", "--steps", "2", "--repeats", "1",
         "--trace-dir", str(tmp_path / "trace"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("NEWT.fused='full_lane_cr'", "warm-up run", "per-step ms over 1 runs of 2",
                 "ms/step", "trace written"):
        assert line in out, line
    assert any(p.name.endswith(".pt.trace.json") for p in (tmp_path / "trace").iterdir())


def test_profile_train_step_cli(capsys):
    """JAX's CLI test's batch at 16 frames (JAX's: 20, the loss's shortest
    input is 2048 samples), loops of 1 and 2 (JAX's: 2 and 4): every probe
    runs, the full step line prints."""
    module = _load("torch_profile_train_step")
    assert module.main(["--batch-size", "1", "--n-frames", "16", "--n-short", "1", "--n-long",
                        "2", "--repeats", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("full_train_step", "model_fwd_bwd", "loss_fwd_bwd", "newt_fwd_bwd",
                 "newt_fwd_bwd_fused_cr", "newt_fwd_bwd_fused_fl", "adam_update", "full step"):
        assert name in out, name
    with pytest.raises(SystemExit):
        module.main(["--probe", "loss_variant", "--device", "cpu"])


def test_profile_streaming_step_cli(capsys):
    assert _load("torch_profile_streaming_step").main(
        ["--batch-streams", "2", "--buffer-size", "256", "--n-short", "2", "--n-long", "4",
         "--repeats", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("full_step", "control_gru", "shaper", "reverb_fdl", "noise_filter_fir",
                 "buffer budget"):
        assert name in out, name
