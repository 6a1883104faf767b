"""The port's measurement tools on the CPU: ``utils.profiling`` (the
``StageTimer`` report, ``trace``, ``debug_nans``, the per-iteration timer,
the launch check) against the JAX package's ``utils/profiling.py`` where it
has the piece, ``Trainer.fit``'s host-stage profile under
``NWS_TPU_HOST_PROFILE`` and ``PipelinedStreamer``'s ``step=`` with the int16
wire of ``scripts/torch_serving_capacity.py``."""
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu.utils import profiling as jprof
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.streaming import PipelinedStreamer, StreamingSynth
from neural_waveshaping_synthesis_tpu_torch.training import TrainConfig, Trainer, compute_loss
from neural_waveshaping_synthesis_tpu_torch.utils import (
    StageTimer,
    debug_nans,
    differential_loop_ms,
    seed_all,
    trace,
)
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import require_launches

REPO = Path(__file__).resolve().parents[1]


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


def _clock(monkeypatch, ticks):
    """time.perf_counter returns ``ticks`` in turn (durations injected)."""
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_stage_timer_report_is_jax_character_for_character(monkeypatch):
    """The same stages with the same injected durations (a repeated stage
    summing, three decimals, the " | " joins) give JAX's report."""
    ticks = [0.0, 0.1234, 1.0, 1.5, 2.0, 2.0004, 3.0, 13.25]
    names = ["step_dispatch", "loss_fetch+device_wait", "step_dispatch", "val+checkpoint"]
    reports = []
    for timer in (StageTimer(), jprof.StageTimer()):
        _clock(monkeypatch, ticks)
        for name in names:
            with timer.stage(name):
                pass
        reports.append(timer.report())
    assert reports[0] == reports[1] == (
        "step_dispatch: 0.124s | loss_fetch+device_wait: 0.500s | val+checkpoint: 10.250s")


def test_trace_writes_a_file_on_the_cpu_and_nothing_when_falsy(tmp_path, capsys):
    with trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    assert files[0].stat().st_size > 0 and "trace written" in capsys.readouterr().out
    for falsy in ("", None):
        with trace(falsy):
            torch.ones(8).sum()
    assert [p.name for p in tmp_path.iterdir()] == ["t"]


def test_debug_nans_raises_on_a_nan_planted_in_newt_as_jax_does():
    """A NaN planted in a NEWT parameter (the shaper's first weight) raises
    in the port's forward and backward inside the scope, and JAX's NEWT
    with the same weights raises in JAX's ``debug_nans`` scope; outside the
    scope the port computes the NaN silently."""
    newt = NEWT(fused=False, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        newt.shaping_fn.params()["layers"][0]["w"].view(-1)[5] = float("nan")
    jp = jax.tree_util.tree_map(lambda t: t.detach().numpy(), newt.params())
    rng = np.random.default_rng(0)
    exc = rng.standard_normal((1, 32, 64)).astype(np.float32)
    emb = rng.standard_normal((1, 4, 128)).astype(np.float32)
    with pytest.raises(FloatingPointError):
        with jprof.debug_nans():
            jnp.sum(JNEWT().apply(jp, exc, emb)).block_until_ready()
    x = torch.from_numpy(exc).requires_grad_(True)
    with pytest.raises(FloatingPointError):
        with debug_nans():
            newt(x, torch.from_numpy(emb)).sum().backward()
    out = newt(x, torch.from_numpy(emb)).sum()
    out.backward()
    assert torch.isnan(out) and torch.isnan(x.grad).any()


def test_debug_nans_catches_a_nan_made_in_the_backward_only():
    """A NaN made in the backward (the forward is clean) raises there, with
    anomaly mode's warning naming the backward and the forward call that
    recorded it; ``enable=False`` lets it through."""

    class NaNGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(FloatingPointError), pytest.warns(UserWarning, match="NaNGradBackward"):
        with debug_nans():
            NaNGrad.apply(x).sum().backward()
    with debug_nans(False):
        NaNGrad.apply(x).sum().backward()
    assert torch.isnan(x.grad).all() and not torch.is_anomaly_enabled()


def test_debug_nans_leaves_clean_losses_bit_identical():
    """One forward + loss + backward of the whole model on clean inputs (fixed
    draws) gives the same loss and gradients bit for bit inside the scope."""
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tc = 16
    batch = {"f0": torch.from_numpy((220 + 220 * rng.random((1, tc))).astype(np.float32)),
             "control": torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32)),
             "audio": torch.from_numpy((0.1 * rng.standard_normal((1, tc * 128))).astype(
                 np.float32))}
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    runs = []
    for scope in (debug_nans, lambda: debug_nans(False)):
        model.zero_grad()
        with scope():
            loss = compute_loss(model, batch, phase_offset=offset, noise=noise)
            loss.backward()
        runs.append((loss.detach(), [p.grad.clone() for p in model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.isfinite(runs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_differential_loop_calls_its_body_the_stated_number_of_times():
    """1 + repeats * (n_short + n_long) calls (one untimed), the carry
    threaded through every one of them; no speed figure is asserted."""
    calls = []

    def body(carry):
        calls.append(carry)
        return carry + 1

    ms = differential_loop_ms(body, n_short=2, n_long=5, repeats=3, carry=0, device="cpu")
    assert len(calls) == 1 + 3 * (2 + 5) and calls == list(range(len(calls)))
    assert np.isfinite(ms)
    with pytest.raises(ValueError):
        differential_loop_ms(body, n_short=5, n_long=5, device="cpu")


def test_require_launches_refuses_a_card_timing_whose_kernel_did_not_move(capsys):
    """On the card a timing whose kernel counter did not move exits non-zero;
    one that moved passes and is printed; on the CPU nothing is required."""
    before = launch_counts()
    assert require_launches(before, ["film_shaper_cr.launches"], "cpu") == {}
    with pytest.raises(SystemExit):
        require_launches(before, ["film_shaper_cr.launches"], "cuda")
    nf.film_shaper_cr.launches_bf16 += 2
    try:
        moved = require_launches(before, ["film_shaper_cr.launches"], "cuda")
    finally:
        nf.film_shaper_cr.launches_bf16 -= 2
    assert moved == {"film_shaper_cr.launches_bf16": 2}
    assert "film_shaper_cr.launches_bf16 +2" in capsys.readouterr().out


def test_seed_all_is_still_importable_from_utils():
    g = seed_all(3)
    assert torch.equal(torch.rand(2, generator=g),
                       torch.rand(2, generator=torch.Generator().manual_seed(3)))


def _write_shards(root: Path, tc=16, hop=128, splits=(("train", 2), ("val", 1))) -> str:
    rng = np.random.default_rng(0)
    for split, n in splits:
        (root / split / "audio").mkdir(parents=True)
        (root / split / "control").mkdir(parents=True)
        for i in range(n):
            np.save(root / split / "audio" / f"audio_clip{i}.npy",
                    (rng.standard_normal(tc * hop) * 0.1).astype(np.float32))
            np.save(root / split / "control" / f"control_clip{i}.npy",
                    rng.standard_normal((19, tc)).astype(np.float32))
    mean, std = np.zeros((19, 1), np.float32), np.ones((19, 1), np.float32)
    mean[0], std[0] = 300.0, 50.0
    np.save(root / "data_mean.npy", mean)
    np.save(root / "data_std.npy", std)
    return str(root)


def test_fit_host_profile_prints_the_stages_and_keeps_the_losses(tmp_path, monkeypatch, capsys):
    """With NWS_TPU_HOST_PROFILE set fit prints each validation's split and
    the run's stages under JAX's names; the losses and validation losses are
    bit-identical to a run without it."""
    root = _write_shards(tmp_path / "data")
    runs = []
    for profile in ("", "1"):
        monkeypatch.setenv("NWS_TPU_HOST_PROFILE", profile)
        cfg = TrainConfig(max_steps=2, val_every_n_steps=2, log_every_n_steps=1,
                          checkpoint_dir=str(tmp_path / f"ck{profile}"))
        trainer = Trainer(NeuralWaveshaping(generator=torch.Generator().manual_seed(0)), cfg,
                          device="cpu")
        runs.append(trainer.fit(GeneralDataModule(root, batch_size=1)))
        out = capsys.readouterr().out
        assert ("host profile" in out) == bool(profile)
    assert runs[0] == runs[1] and len(runs[0]["loss"]) == 2
    host = [line for line in out.splitlines() if line.startswith("[trainer] host profile: ")]
    val = [line for line in out.splitlines() if line.startswith("[trainer] val profile @step 2: ")]
    assert len(host) == 1 and len(val) == 1
    for name in ("batch", "to_device", "step_dispatch", "loss_fetch+device_wait", "log",
                 "val+checkpoint"):
        assert f"{name}: " in host[0], name
    for name in ("eval", "log+params", "checkpoint"):
        assert f"{name}: " in val[0], name


def _serving_script():
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(
        "torch_serving_capacity", REPO / "scripts" / "torch_serving_capacity.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pipelined_int16_wire_is_the_clipped_cast_of_the_float32_stream():
    """PipelinedStreamer(step=the serving script's int16 wire) at 2 streams x
    256 samples hands out int16 buffers equal, bit for bit, to numpy's and
    JAX's clip(32767 x audio) cast of the float32 stream from the same seed
    (NEWT's output mix scaled up drives samples past full scale, so the clip
    is exercised)."""
    wire = _serving_script().int16_step
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.newt.mixer.w.mul_(8.0)
    synth = StreamingSynth(model, 2)
    rng = np.random.default_rng(0)
    pushes = [((220 + 220 * rng.random((2, 2))).astype(np.float32),
               rng.standard_normal((2, 2, 2)).astype(np.float32)) for _ in range(5)]
    outs = []
    for step in (None, wire(synth)):
        streamer = PipelinedStreamer(synth, 2, torch.Generator().manual_seed(7), depth=2,
                                     device="cpu", step=step)
        got = [a for a in (streamer.push(f0, c) for f0, c in pushes) if a is not None]
        outs.append(np.stack(got + list(streamer.flush())))
    f32, i16 = outs
    assert f32.dtype == np.float32 and i16.dtype == np.int16 and i16.shape == (5, 2, 256)
    assert np.abs(f32).max() > 1.0
    np.testing.assert_array_equal(i16, np.clip(f32 * 32767.0, -32768, 32767).astype(np.int16))
    np.testing.assert_array_equal(
        i16, np.asarray(jnp.clip(jnp.asarray(f32) * 32767.0, -32768, 32767).astype(jnp.int16)))
