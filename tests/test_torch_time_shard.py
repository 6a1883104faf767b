"""The port's time-sharded renderer (``parallel/time_shard.py``) against
the unsharded ``model.forward`` and against JAX's
``make_time_sharded_renderer``, on the CPU.

The cases mirror ``tests/test_time_shard.py`` one by one at its bars, on the
shipped architecture at JAX's small shapes. A mesh of n chunks is
``create_mesh(devices=["cpu"] * n)``, the counterpart of JAX's n virtual CPU
devices; on the CPU each chunk runs kernel 5's plain version. Each case's
docstring records the distance measured when it was written.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.parallel import create_mesh as j_create_mesh
from neural_waveshaping_synthesis_tpu.parallel import (
    make_time_sharded_renderer as j_make_time_sharded_renderer,
)
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer, timbre_transfer
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.parallel import (
    create_mesh,
    make_time_sharded_renderer,
)
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample
from neural_waveshaping_synthesis_tpu_torch.parallel.time_shard import _upsample_chunk

CKPT = str(Path(__file__).resolve().parents[1] / "docs" / "results" / "run120k_cr" / "checkpoint"
           / "best.ckpt")


def _mesh(n):
    return create_mesh(devices=["cpu"] * n)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's tests, restored after: the test
    workers share the machine's cores, and torch's default of a thread per
    core in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return NeuralWaveshaping(generator=torch.Generator().manual_seed(0))


def _inputs(rng, b, tc, dtype=np.float32):
    f0 = torch.from_numpy((220.0 * 2 ** rng.uniform(0, 1, (b, tc))).astype(dtype))
    control = torch.from_numpy(rng.standard_normal((b, tc, 2)).astype(dtype))
    return f0, control


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b**2)) + 1e-12))


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_matches_unsharded_render(model, rng, n_devices):
    """Sharded vs unsharded at (2, 40) frames, the same generator: JAX's
    f32 bar, atol and rtol 5e-4. Measured: 0.0 for every n (the chunks'
    mixer sums reassociate nothing on the CPU here)."""
    f0, control = _inputs(rng, 2, 40)
    with torch.no_grad():
        reference = model(f0, control, generator=_gen(7)).numpy()
        render = make_time_sharded_renderer(model, _mesh(n_devices))
        sharded = render(f0, control, generator=_gen(7)).numpy()
    assert sharded.shape == reference.shape == (2, 40 * 128)
    np.testing.assert_allclose(sharded, reference, atol=5e-4, rtol=5e-4)


def test_matches_unsharded_render_exact_f64(rng):
    """In float64 the sharded render equals the unsharded one to 1e-7 (JAX's
    bar): the chunk decomposition is exact, and the float32 bar above is
    reassociation only. Measured: 0.0 max abs."""
    model64 = NeuralWaveshaping(generator=_gen(0)).double()
    f0, control = _inputs(rng, 1, 24, np.float64)
    with torch.no_grad():
        reference = model64(f0, control, generator=_gen(5)).numpy()
        sharded = make_time_sharded_renderer(model64, _mesh(8))(
            f0, control, generator=_gen(5)).numpy()
    assert sharded.dtype == np.float64
    np.testing.assert_allclose(sharded, reference, atol=1e-7, rtol=1e-7)


def test_non_divisible_frames_pad_path(model, rng):
    """37 frames over 8 chunks (seven of 5 frames, the last of 2): the
    chunk edges and the last half-hop's tail clamp come from the true last
    frame. Bar 5e-4; measured 0.0."""
    f0, control = _inputs(rng, 1, 37)
    with torch.no_grad():
        reference = model(f0, control, generator=_gen(11)).numpy()
        sharded = make_time_sharded_renderer(model, _mesh(8))(
            f0, control, generator=_gen(11)).numpy()
    assert sharded.shape == reference.shape == (1, 37 * 128)
    np.testing.assert_allclose(sharded, reference, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("tc,hop,n", [(37, 128, 8), (5, 4, 2), (3, 6, 8), (1, 3, 1)])
def test_chunk_upsample_is_the_global_upsample_bit_for_bit(tc, hop, n):
    """Every chunk's FiLM upsample from its edge-clamped halo frames equals
    its slice of ``linear_upsample`` over the whole clip, bit for bit (head
    and tail clamps, odd hops, chunks of one frame)."""
    x = torch.from_numpy(np.random.default_rng(tc).standard_normal((2, tc, 3)).astype(np.float32))
    whole = linear_upsample(x, tc * hop)
    pp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    k = -(-tc // n)
    for m0 in range(0, tc, k):
        m1 = min(m0 + k, tc)
        chunk = _upsample_chunk(pp[:, m0 : m1 + 2], hop, m0 == 0)
        assert torch.equal(chunk, whole[:, m0 * hop : m1 * hop]), (m0, m1)


def test_same_key_determinism(model, rng):
    """The same generator seed gives the same bits; another seed other
    phase offsets and noise (more than 1e-6 apart)."""
    f0, control = _inputs(rng, 1, 16)
    render = make_time_sharded_renderer(model, _mesh(8))
    with torch.no_grad():
        a = render(f0, control, generator=_gen(3)).numpy()
        b = render(f0, control, generator=_gen(3)).numpy()
        c = render(f0, control, generator=_gen(4)).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-6


def test_timbre_transfer_mesh_path(model):
    """``timbre_transfer(..., mesh=...)`` renders the sharded clip, which
    matches the one-program path in energy and spectrum (JAX's bars, nRMS
    and spectral error < 0.02; measured 0.0 and 0.0: the port's float64
    phase sum is the same in both); FastNEWT with a mesh raises."""
    sr = 16000
    t = np.arange(2 * sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    mean = np.zeros((19, 1), np.float32)
    mean[0] = 300.0
    std = np.ones((19, 1), np.float32)
    std[0] = 60.0
    synth = Synthesizer(model, mean, std, torch.device("cpu"))
    out_single, _ = timbre_transfer(synth, audio, sr, seed=3)
    out_sharded, speed = timbre_transfer(synth, audio, sr, seed=3, mesh=_mesh(8))
    assert out_sharded.shape == out_single.shape and speed > 0
    assert _nrms(out_sharded, out_single) < 0.02
    spec_a = np.abs(np.fft.rfft(out_sharded))
    spec_b = np.abs(np.fft.rfft(out_single))
    assert np.linalg.norm(spec_a - spec_b) / np.linalg.norm(spec_b) < 0.02
    with pytest.raises(ValueError, match="use_fast_newt"):
        timbre_transfer(synth, audio, sr, mesh=_mesh(8), use_fast_newt=True)


def test_bf16_model_matches_unsharded(rng):
    """A ``compute_dtype = "bfloat16"`` model keeps sharded == unsharded
    (JAX's bar atol and rtol 4e-3; measured 2.2e-3 max abs: the chunks
    round their float32 FiLM lerp to bf16 for kernel 5's plain version, the
    unsharded "cr" path keeps it float32 inside kernel 1's), and tracks the
    float32 render (nRMS < 0.05; measured 4.8e-3)."""
    model16 = NeuralWaveshaping(generator=_gen(0), compute_dtype="bfloat16")
    model32 = NeuralWaveshaping(generator=_gen(0))
    f0, control = _inputs(rng, 1, 16)
    with torch.no_grad():
        reference = model16(f0, control, generator=_gen(9)).numpy()
        sharded = make_time_sharded_renderer(model16, _mesh(8))(
            f0, control, generator=_gen(9)).numpy()
        ref32 = model32(f0, control, generator=_gen(9)).numpy()
    assert sharded.dtype == np.float32
    np.testing.assert_allclose(sharded, reference, atol=4e-3, rtol=4e-3)
    assert _nrms(sharded, ref32) < 0.05


def test_matches_jax_time_sharded_renderer():
    """The port's 8-chunk render against JAX's ``make_time_sharded_renderer``
    on its 8-device CPU mesh, both from the run120k_cr weights with the
    same injected phase offsets and noise, at (2, 40) frames: the golden
    1e-3 nRMS bar. Measured 8.0e-5 (JAX's float32 phase sum against the
    port's float64 one, and the two frameworks' mixer sums)."""
    jparams = load_reference_checkpoint(CKPT)[0]
    rng = np.random.default_rng(12)
    b, tc = 2, 40
    f0 = (220.0 * 2 ** rng.uniform(0, 1, (b, tc))).astype(np.float32)
    control = rng.standard_normal((b, tc, 2)).astype(np.float32)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)
    jrender = j_make_time_sharded_renderer(JNeuralWaveshaping(), j_create_mesh())
    ref = np.asarray(jrender(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(f0),
                             jnp.asarray(control), noise=jnp.asarray(noise),
                             phase_offset=jnp.asarray(offset)))
    model = NeuralWaveshaping()
    model.load_params(params_from_jax(jparams))
    with torch.no_grad():
        ours = make_time_sharded_renderer(model, _mesh(8))(
            torch.from_numpy(f0), torch.from_numpy(control), noise=torch.from_numpy(noise),
            phase_offset=torch.from_numpy(offset)).numpy()
    assert ours.shape == ref.shape == (b, tc * 128)
    assert _nrms(ours, ref) < 1e-3
