"""Timbre transfer in the port against the JAX package, on the CPU: the
sliders, the FastNEWT bake and lookup (the CUDA kernel's plain version,
against JAX's XLA lookup and its Pallas kernel in interpret mode), NEWT
and the whole model with a lookup table, the slice end to end, the
streaming path, the CLI, and what raises."""
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.inference.timbre_transfer import (
    ControlAdjustments as JControlAdjustments,
    _box_smooth as j_box_smooth,
    adjust_controls as j_adjust_controls,
    extract_features as j_extract_features,
)
from neural_waveshaping_synthesis_tpu.kernels import fast_newt_lookup_pallas
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.models.newt import fast_newt_lookup as j_fast_newt_lookup
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.inference import (
    ControlAdjustments,
    Synthesizer,
    adjust_controls,
    extract_features,
    stream_timbre_transfer,
    timbre_transfer,
)
from neural_waveshaping_synthesis_tpu_torch.inference.timbre_transfer import _box_smooth
from neural_waveshaping_synthesis_tpu_torch.kernels import fast_newt
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, NeuralWaveshaping

REPO = Path(__file__).resolve().parents[1]
CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")
WAV = str(REPO / "logs" / "audio" / "val_original_step20.wav")
SLIDERS = ControlAdjustments(
    octave_shift=1, loudness_scale=1.7, loudness_floor=0.05, loudness_conf_filter=0.3,
    pitch_conf_filter=0.4, pitch_smoothing=2, loudness_smoothing=3,
)


@pytest.fixture(scope="module")
def jax_ckpt():
    return load_reference_checkpoint(CKPT)


@pytest.fixture(scope="module")
def cpu_synth():
    return Synthesizer.from_checkpoint(CKPT, device="cpu")


@pytest.fixture(scope="module")
def table(jax_ckpt):
    """The run120k_cr FastNEWT table as JAX bakes it, fed to both sides."""
    return np.asarray(JNeuralWaveshaping().newt.bake_lookup_table(jax_ckpt[0]["newt"]))


def nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def _controls(n, seed):
    rng = np.random.default_rng(seed)
    f0 = np.geomspace(*rng.uniform(110, 880, 2), n).astype(np.float32)
    conf = rng.uniform(0, 1, n).astype(np.float32)
    loud = (0.2 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return f0, conf, loud


def test_adjust_controls_with_every_slider_matches_jax(jax_ckpt):
    """All seven sliders away from their defaults: atol 1e-6 (both are
    numpy; observed when written: bit for bit)."""
    _, _, mean, std = jax_ckpt
    f0, conf, loud = _controls(60, seed=1)
    for a, b in zip(adjust_controls(f0, conf, loud, mean, std, SLIDERS),
                    j_adjust_controls(f0, conf, loud, mean, std, JControlAdjustments(**vars(SLIDERS)))):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    x = np.zeros(11)
    x[5] = 1.0
    np.testing.assert_array_equal(_box_smooth(x, 2), j_box_smooth(x, 2))


def test_default_sliders_give_the_old_prepare_bit_for_bit(cpu_synth):
    """``Synthesizer.prepare`` now runs the full ``adjust_controls`` at
    ``ControlAdjustments()`` and confidence 1; it must give what the
    default-only arithmetic it replaced gave, bit for bit, gated
    (non-positive) loudness included."""
    f0, _, loud = _controls(40, seed=2)
    loud[::3] = -np.abs(loud[::3])
    mean, std = cpu_synth.data_mean, cpu_synth.data_std
    f0_b, ctrl_b, _ = cpu_synth.prepare([(f0, loud)])
    gated = loud * (loud > 0.0)
    old = np.stack([(f0 - mean[0, 0]) / std[0, 0], (gated - mean[1, 0]) / std[1, 0]], axis=-1)
    np.testing.assert_array_equal(f0_b[0, :40], f0)
    np.testing.assert_array_equal(ctrl_b[0, :40], old.astype(np.float32))


def test_bake_matches_jax(jax_ckpt, table, cpu_synth):
    """The 4096 x 64 table on the run120k_cr weights: atol 1e-5 (the grids
    of torch.linspace and jnp.linspace differ by up to 4.8e-7; observed
    when written: 4.7e-6)."""
    with torch.inference_mode():
        baked = cpu_synth.model.newt.bake_lookup_table()
    assert baked.shape == (4096, 64) and baked.is_contiguous()  # as the kernel takes it
    ours = baked.numpy()
    np.testing.assert_allclose(ours, table, rtol=0, atol=1e-5)


def _lookup_inputs(seed):
    """x over [-4, 4] (both table edges crossed), the exact grid points of
    a 4096-point table over [-3, 3] and the edges themselves; 3 x 333 rows,
    not a multiple of the Pallas tile (1024)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4, 4, (3, 333, 64)).astype(np.float32)
    grid = np.float32(-3) + np.arange(64 * 64, dtype=np.float32) * np.float32(6 / 4096)
    x[0, :64] = grid.reshape(64, 64)
    x[1, 0, :6] = [-4.0, 4.0, -3.0, 3.0, -3.5, 3.5]
    return x


def test_lookup_plain_matches_both_jax_forms(table):
    """One table, both sides. Against JAX's XLA lookup (the NEWT path's)
    the plain version is bit for bit (held at atol 1e-6). Against the
    Pallas kernel in interpret mode the bar is one float32 ulp of the
    index (idx < 8192: 2^-11) times the table's steepest step: that
    program rounds S*(x - min)/(max - min) differently. Observed when
    written: 2.6e-6 against a bar of 5.4e-6. The CPU wrapper is the plain
    version."""
    x = _lookup_inputs(3)
    ours = fast_newt.fast_newt_lookup_plain(torch.from_numpy(table), torch.from_numpy(x)).numpy()
    xla = np.asarray(j_fast_newt_lookup(jnp.asarray(table), jnp.asarray(x)))
    pallas = np.asarray(fast_newt_lookup_pallas(jnp.asarray(table), jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(ours, xla, rtol=0, atol=1e-6)
    bar = 2.0**-11 * np.abs(np.diff(table, axis=0)).max()
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=bar)
    wrapped = fast_newt.fast_newt_lookup(torch.from_numpy(table), torch.from_numpy(x))
    assert torch.equal(wrapped, torch.from_numpy(ours))
    # above max: table[S-1]; below min: extrapolated from the first two entries
    np.testing.assert_array_equal(ours[1, 0, 1], table[-1, 1])
    assert ours[1, 0, 0] != table[0, 0]


def test_lookup_kernel_wrapper_refuses_what_it_does_not_take():
    """The CUDA wrapper raises, before any build, on a CPU tensor, a wrong
    dtype and a non-contiguous input; the CPU dispatch refuses a table on
    another device than x."""
    table, x = torch.zeros(256, 64), torch.zeros(2, 8, 64)
    with pytest.raises(ValueError):
        fast_newt._launch(table, x)
    with pytest.raises(TypeError):
        fast_newt._launch(table, x.double())
    with pytest.raises(ValueError):
        fast_newt._launch(table, torch.zeros(2, 64, 8).transpose(1, 2))
    with pytest.raises(ValueError):
        fast_newt.fast_newt_lookup(table.to("meta"), x)


@pytest.mark.parametrize("c,offset,path", [(64, 0, "vec4"), (5, 0, "scalar"), (64, 1, "scalar")])
def test_lookup_path_takes_vec4_only_on_aligned_quads_of_channels(c, offset, path):
    """The lookup kernel's path, chosen from C and the data pointers: C = 64
    on an aligned tensor gives vec4; C = 5 gives scalar; a C = 64
    contiguous view at storage offset 1 (4 B past 16-B alignment) gives
    scalar."""
    x = torch.zeros(2 * 8 * c + offset)[offset:].view(2, 8, c)
    assert x.is_contiguous()
    assert fast_newt._lookup_path(x, torch.empty_like(x)) == path


def _newt_inputs(tc, seed):
    rng = np.random.default_rng(seed)
    exciter = (rng.standard_normal((2, tc * 128, 64)) * 0.5).astype(np.float32)
    emb = rng.standard_normal((2, tc, 128)).astype(np.float32)
    return exciter, emb


@pytest.mark.parametrize("tc", [16, 15])
def test_newt_with_a_lookup_table_matches_jax(jax_ckpt, table, tc):
    """NEWT.forward(lookup_table=...) vs the JAX apply with the same
    table: <= 1e-3 nRMS (observed when written: 6.0e-7 at Tc=16, 6.2e-7
    at Tc=15)."""
    p = jax_ckpt[0]["newt"]
    exciter, emb = _newt_inputs(tc, seed=tc)
    ref = np.asarray(JNeuralWaveshaping().newt.apply(p, exciter, emb, lookup_table=jnp.asarray(table)))
    newt = NEWT()
    newt.load_params(params_from_jax(jax_ckpt[0])["newt"])
    with torch.inference_mode():
        out = newt(torch.from_numpy(exciter), torch.from_numpy(emb),
                   lookup_table=torch.from_numpy(table)).numpy()
    assert out.shape == ref.shape == (2, tc * 128, 1)
    assert nrms(out, ref) <= 1e-3, nrms(out, ref)


def _jax_render(params, f0, control, offset, noise, table=None):
    fn = jax.jit(lambda p, f, c, o, n, t: JNeuralWaveshaping().apply(
        p, f, c, phase_offset=o, noise=n, lookup_table=t))
    return np.asarray(fn(params, f0, control, offset, noise, None if table is None else jnp.asarray(table)))


def _port_render(model, f0, control, offset, noise, table=None):
    with torch.inference_mode():
        return model(torch.from_numpy(f0), torch.from_numpy(control),
                     phase_offset=torch.from_numpy(offset), noise=torch.from_numpy(noise),
                     lookup_table=None if table is None else torch.from_numpy(table)).numpy()


@pytest.mark.parametrize("tc", [16, 15])
def test_model_with_a_lookup_table_matches_jax(jax_ckpt, table, cpu_synth, tc):
    """The whole model with FastNEWT vs the JAX apply, same weights, table,
    phase offsets and noise: <= 1e-3 nRMS, the golden bar (observed when
    written: 2.5e-5 at Tc=16, 1.2e-5 at Tc=15)."""
    rng = np.random.default_rng(20 + tc)
    f0 = (220.0 * np.linspace(1.0, 1.4, tc)[None] * np.ones((2, 1))).astype(np.float32)
    control = rng.standard_normal((2, tc, 2)).astype(np.float32)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)
    ref = _jax_render(jax_ckpt[0], f0, control, offset, noise, table)
    out = _port_render(cpu_synth.model, f0, control, offset, noise, table)
    assert out.shape == (2, tc * 128) and np.all(np.isfinite(out))
    assert nrms(out, ref) <= 1e-3, nrms(out, ref)


def _tone_44k_stereo(seconds=1.5):
    sr = 44100
    t = np.arange(int(seconds * sr)) / sr
    tone = 0.4 * np.sin(2 * np.pi * 330 * t) * (0.6 + 0.4 * np.sin(np.pi * t))
    return (np.stack([tone, 0.5 * tone], axis=-1) * 32767).astype(np.int16), sr


def test_the_slice_end_to_end_matches_jax(jax_ckpt, table, cpu_synth):
    """A 1.5-s 330-Hz tone at 44.1 kHz (int16 stereo): extraction and the
    sliders (octave +1, loudness x2) in the port and in JAX give the same
    controls (f0 rtol 1e-5; the loudness control within the loudness bar
    carried through the x2 and the z-score, 2e-5 / std); then each side
    renders its own controls with the same phase offsets and noise, with
    and without FastNEWT: <= 1e-3 nRMS (observed when written: 1.9e-4
    both ways; the controls differ by 7.6e-6 at most). Then ``timbre_transfer`` on the
    CPU synthesizer returns (Tc * 128,) finite audio and a positive speed."""
    params, _, mean, std = jax_ckpt
    audio, sr = _tone_44k_stereo()
    adj = ControlAdjustments(octave_shift=1, loudness_scale=2.0)
    _, f0, conf, loud = extract_features(audio, sr, device="cpu")
    f0_hz, control = adjust_controls(f0, conf, loud, mean, std, adj)
    from test_torch_features import _design_jax_filter

    _design_jax_filter(sr)
    _, jf0, jconf, jloud = j_extract_features(audio, sr)
    jf0_hz, jcontrol = j_adjust_controls(jf0, jconf, jloud, mean, std,
                                            JControlAdjustments(octave_shift=1, loudness_scale=2.0))
    tc = f0_hz.shape[0]
    assert tc == 1 + int(1.5 * 16000) // 128
    np.testing.assert_allclose(f0_hz, jf0_hz, rtol=1e-5)
    np.testing.assert_allclose(control[:, 0], jcontrol[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(control[:, 1], jcontrol[:, 1], rtol=0, atol=2e-5 / std[1, 0])

    rng = np.random.default_rng(9)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)
    for lookup in (None, table):
        ref = _jax_render(params, jf0_hz[None], jcontrol[None], offset, noise, lookup)
        out = _port_render(cpu_synth.model, f0_hz[None], control[None], offset, noise, lookup)
        assert nrms(out, ref) <= 1e-3, (lookup is not None, nrms(out, ref))

    out, speed = timbre_transfer(cpu_synth, audio, sr, adj, use_fast_newt=True, seed=0)
    assert out.shape == (tc * 128,) and out.dtype == np.float32
    assert np.all(np.isfinite(out)) and np.sqrt(np.mean(out**2)) > 1e-4 and speed > 0


def test_stream_timbre_transfer_contract(cpu_synth):
    """JAX's ``test_stream_timbre_transfer_tiny`` contract on the CPU: 1 s
    at 22.05 kHz through 1024-sample buffers, depth 2."""
    sr = 22050
    t = np.arange(sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    out, stats = stream_timbre_transfer(cpu_synth, audio, sr, buffer_size=1024, pipeline_depth=2)
    n_frames = 1 + 16000 // 128
    assert out.shape == (n_frames * 128,) and np.all(np.isfinite(out)) and out.std() > 0
    assert stats["n_buffers"] == -(-n_frames // 8)
    assert stats["pipeline_depth"] == 2 and stats["buffer_size"] == 1024
    assert 0.0 <= stats["cadence_p50_ms"] <= stats["cadence_p95_ms"]
    assert stats["first_buffer_latency_ms"] > 0.0 and stats["x_realtime"] > 0.0
    assert stats["buffer_budget_ms"] == 64.0
    with pytest.raises(ValueError, match="multiple of control_hop"):
        stream_timbre_transfer(cpu_synth, audio, sr, buffer_size=100)


def test_entry_points_raise_without_a_card(cpu_synth):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    audio = np.zeros(4000, np.float32)
    with pytest.raises(RuntimeError):
        extract_features(audio, 16000)
    with pytest.raises(RuntimeError):
        Synthesizer.from_checkpoint(CKPT)
    with pytest.raises(NotImplementedError):
        timbre_transfer(cpu_synth, audio, 16000, f0_extractor="crepe")


def test_cli(tmp_path, capsys):
    """``scripts/torch_timbre_transfer.py``: --help, one run at --device
    cpu on a 1-s wav with FastNEWT (a 16-kHz wav of Tc * 128 samples
    comes out), and the default device raising without a card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_timbre_transfer", REPO / "scripts" / "torch_timbre_transfer.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0 and "--use-fast-newt" in capsys.readouterr().out

    sr, audio = wavfile.read(WAV)
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    wavfile.write(src, sr, audio[:sr])
    args = ["--input", str(src), "--checkpoint", CKPT, "--output", str(dst), "--octave-shift", "1"]
    assert cli.main(args + ["--device", "cpu", "--use-fast-newt"]) == 0
    assert "faster than real time" in capsys.readouterr().out
    out_sr, out = wavfile.read(dst)
    assert out_sr == 16000 and out.dtype == np.int16 and out.shape == ((1 + sr // 128) * 128,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.main(args)
