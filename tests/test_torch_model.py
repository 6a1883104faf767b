"""The whole slice: checkpoint loading, the full model against the JAX
``NeuralWaveshaping.apply``, the serving entry point, and the port's
import rules."""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.inference.timbre_transfer import (
    adjust_controls as j_adjust_controls,
)
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.ops import oscillator as j_oscillator
from neural_waveshaping_synthesis_tpu_torch import resolve_device
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint, params_from_jax
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer, adjust_controls
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.streaming import PipelinedStreamer, StreamingSynth

REPO = Path(__file__).resolve().parents[1]
CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")
PORT = REPO / "neural_waveshaping_synthesis_tpu_torch"


@pytest.fixture(scope="module")
def jax_ckpt():
    return load_reference_checkpoint(CKPT)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_port_loader_matches_params_from_jax(jax_ckpt):
    """Both bridges give the same tree of identical float32 tensors, in
    the JAX layouts, and the checkpoint's 266,945 parameters."""
    params, hparams, mean, std = load_checkpoint(CKPT)
    jparams, jhparams, jmean, jstd = jax_ckpt
    ours = dict(_leaves(params))
    theirs = dict(_leaves(params_from_jax(jparams)))
    assert ours.keys() == theirs.keys()
    for name, t in ours.items():
        assert t.dtype == torch.float32, name
        assert torch.equal(t, theirs[name]), name
    assert sum(t.numel() for t in ours.values()) == 266945
    assert hparams == jhparams
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)


@pytest.mark.parametrize("tc", [16, 15])
def test_forward_matches_jax_apply(jax_ckpt, tc):
    """NeuralWaveshaping.forward on the CPU vs the JAX apply, both with
    the run120k_cr weights and the same injected phase offsets and noise.
    Bar: 1e-3 normalised RMS (tests/test_model_golden.py's bar). Observed
    when written: 2.9e-5 at Tc=16 and 3.7e-5 at Tc=15 — the odd length
    the JAX TPU gate refused, which the Hopper gate accepts."""
    jparams = jax_ckpt[0]
    rng = np.random.default_rng(tc)
    base = 220.0 * 2.0 ** rng.uniform(0, 2, (2, 1))
    f0 = (base * np.linspace(1.0, 1.3, tc) + rng.standard_normal((2, tc))).astype(np.float32)
    control = rng.standard_normal((2, tc, 2)).astype(np.float32)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)
    ref = np.asarray(
        jax.jit(
            lambda p, f, c, o, n: JNeuralWaveshaping().apply(p, f, c, phase_offset=o, noise=n)
        )(jparams, f0, control, offset, noise)
    )
    model = NeuralWaveshaping()
    model.load_params(params_from_jax(jparams))
    with torch.inference_mode():
        out = model(
            torch.from_numpy(f0), torch.from_numpy(control),
            phase_offset=torch.from_numpy(offset), noise=torch.from_numpy(noise),
        ).numpy()
    assert out.shape == (2, tc * 128) and np.all(np.isfinite(out))
    nrms = np.sqrt(np.mean((out - ref) ** 2)) / np.sqrt(np.mean(ref**2))
    assert nrms <= 1e-3, nrms


def test_forward_at_a_served_length_matches_jax_with_an_exact_phase(jax_ckpt, monkeypatch):
    """A 4-s request (Tc=500, 64,000 samples), as served. The port sums
    the oscillator phase in float64; the JAX package sums it in float32,
    whose rounding over 64,000 samples shifts the upper harmonics. The
    witness is the JAX apply with its phase integral computed exactly
    (float64 on the host): the port must match it within the 1e-3 nRMS
    golden bar, and be closer to it than the JAX float32 render is.
    Observed when written: port vs witness 1.7e-6; JAX float32 vs
    witness (and vs the port) 1.07e-3, above the bar."""
    jparams = jax_ckpt[0]
    synth = Synthesizer.from_checkpoint(CKPT, device="cpu")
    tc = 500
    (f0, loud), = _requests([tc], seed=7)
    f0_b, ctrl_b, _ = synth.prepare([(f0, loud)])
    f0_b, ctrl_b = f0_b[:, :tc], ctrl_b[:, :tc]
    rng = np.random.default_rng(8)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)

    def jax_render():
        return np.asarray(
            jax.jit(
                lambda p, f, c, o, n: JNeuralWaveshaping().apply(p, f, c, phase_offset=o, noise=n)
            )(jparams, f0_b, ctrl_b, offset, noise)
        )

    def exact_phase(f, sample_rate):
        def host(x):
            phase = 2 * np.pi * np.cumsum(np.asarray(x, np.float64), axis=-1) / sample_rate
            return np.mod(phase, 2 * np.pi).astype(np.float32)

        return jax.pure_callback(host, jax.ShapeDtypeStruct(f.shape, f.dtype), f)

    jax_f32 = jax_render()
    monkeypatch.setattr(j_oscillator, "phase_accumulate", exact_phase)
    witness = jax_render()
    with torch.inference_mode():
        out = synth.model(
            torch.from_numpy(f0_b), torch.from_numpy(ctrl_b),
            phase_offset=torch.from_numpy(offset), noise=torch.from_numpy(noise),
        ).numpy()

    def nrms(a, b):
        return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2))

    assert out.shape == (1, tc * 128) and np.all(np.isfinite(out))
    assert nrms(out, witness) <= 1e-3, nrms(out, witness)
    assert nrms(out, witness) < nrms(jax_f32, witness)


def _requests(lengths, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        f0 = np.geomspace(*rng.uniform(110, 880, 2), n).astype(np.float32)
        loud = (0.2 + 0.05 * np.sin(np.linspace(0, 6, n))).astype(np.float32)
        out.append((f0, loud))
    return out


def test_synthesizer_renders_requests_of_different_lengths():
    """Two requests, padded to one 256-frame bucket and rendered as one
    batch, come back at their own lengths; one seed gives one render."""
    synth = Synthesizer.from_checkpoint(CKPT, device="cpu")
    f0_b, ctrl_b, lengths = synth.prepare(_requests([40, 23]))
    assert f0_b.shape == (2, 256) and ctrl_b.shape == (2, 256, 2) and lengths == [40, 23]
    assert np.all(f0_b[1, 23:] == 0) and np.all(ctrl_b[1, 23:] == 0)
    audio = synth.render(_requests([40, 23]), seed=3)
    assert [a.shape for a in audio] == [(40 * 128,), (23 * 128,)]
    assert all(a.dtype == np.float32 and np.all(np.isfinite(a)) for a in audio)
    assert all(np.sqrt(np.mean(a**2)) > 1e-4 for a in audio)
    again = synth.render(_requests([40, 23]), seed=3)
    assert all(np.array_equal(a, b) for a, b in zip(audio, again))


def test_adjust_controls_matches_jax():
    """The request normalisation is the JAX package's at its default
    sliders and full confidence, bit for bit, non-positive loudness
    (gated to 0) included."""
    _, _, mean, std = load_checkpoint(CKPT)
    (f0, loud), = _requests([30], seed=4)
    loud = loud - np.float32(0.22)
    assert (loud <= 0).any() and (loud > 0).any()
    for a, b in zip(adjust_controls(f0, np.ones_like(f0), loud, mean, std),
                    j_adjust_controls(f0, np.ones_like(f0), loud, mean, std)):
        np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_the_card():
    """With no device argument the port asks for CUDA, and without a
    card it raises instead of falling back to the CPU: the serving entry
    point and the streaming ones."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        Synthesizer.from_checkpoint(CKPT)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    synth = StreamingSynth(Synthesizer.from_checkpoint(CKPT, device="cpu").model, 8)
    with pytest.raises(RuntimeError):
        synth.init_state(1)
    with pytest.raises(RuntimeError):
        PipelinedStreamer(synth, batch=1)
    assert synth.init_state(1, device="cpu").gru_h.device == torch.device("cpu")


def _imports(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    files += sorted((REPO / "scripts").glob("*torch*.py"))
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "neural_waveshaping_synthesis_tpu"), (
                f"{os.path.relpath(path, REPO)} imports {name}"
            )
