"""The port's CREPE (``models/crepe.py``) against the JAX package on the
CPU: the bin and cents maps, Viterbi on the JAX suite's ridge and
brute-force cases, the local average, framing, the CNN with random
weights in torchcrepe's layout and through ``from_jax_params`` and the
``.npz`` cache, ``predict`` with both decoders, and the extractor with a
``.pth``. The repo holds no pretrained weights, so every check uses
random ones, as the JAX suite does."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.models import crepe as j_crepe
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import f0_extraction as t_f0x
from neural_waveshaping_synthesis_tpu_torch.models import crepe as t_crepe


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread for each test. The Viterbi recursion's per-frame
    ops and ``betainc``'s continued-fraction terms are small, and under the
    tier-1 run's parallel workers torch's intra-op threads thrash on them: a
    513-frame decode took 38-42 s in each of six concurrent processes at 8
    threads on 8 cores, and 0.14-0.21 s at one thread
    (``scripts/torch_viterbi_threads.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torchcrepe_state(rng, capacity, batches_tracked=False):
    """Random weights in torchcrepe's state-dict layout (JAX
    tests/test_crepe.py ``_make_torch_state``)."""
    filters = [t_crepe.CAPACITIES[capacity] * f for f in (32, 4, 4, 4, 8, 16)]
    widths = (512, 64, 64, 64, 64, 64)
    sd, in_ch = {}, 1
    for i, (out_ch, w) in enumerate(zip(filters, widths), start=1):
        sd[f"conv{i}.weight"] = torch.tensor(rng.standard_normal((out_ch, in_ch, w, 1)).astype(np.float32) * 0.05)
        sd[f"conv{i}.bias"] = torch.tensor(rng.standard_normal(out_ch).astype(np.float32) * 0.05)
        sd[f"conv{i}_BN.weight"] = torch.tensor(1.0 + 0.1 * rng.standard_normal(out_ch).astype(np.float32))
        sd[f"conv{i}_BN.bias"] = torch.tensor(0.1 * rng.standard_normal(out_ch).astype(np.float32))
        sd[f"conv{i}_BN.running_mean"] = torch.tensor(0.1 * rng.standard_normal(out_ch).astype(np.float32))
        sd[f"conv{i}_BN.running_var"] = torch.tensor((1.0 + 0.1 * rng.random(out_ch)).astype(np.float32))
        if batches_tracked:
            sd[f"conv{i}_BN.num_batches_tracked"] = torch.tensor(7)
        in_ch = out_ch
    sd["classifier.weight"] = torch.tensor(rng.standard_normal((360, 4 * filters[-1])).astype(np.float32) * 0.05)
    sd["classifier.bias"] = torch.tensor(rng.standard_normal(360).astype(np.float32) * 0.05)
    return sd


def _jax_params(sd):
    return jax.tree_util.tree_map(jnp.asarray, j_crepe.convert_torchcrepe_state_dict(sd))


def test_constants_and_maps_match_jax():
    assert (t_crepe.WINDOW_SIZE, t_crepe.N_BINS, t_crepe.CENTS_PER_BIN, t_crepe.CENTS_OFFSET) == (
        j_crepe.WINDOW_SIZE, j_crepe.N_BINS, j_crepe.CENTS_PER_BIN, j_crepe.CENTS_OFFSET)
    assert t_crepe.CAPACITIES == j_crepe._CAPACITIES and t_crepe._PADS == j_crepe._PADS
    bins = np.arange(360, dtype=np.float32)
    cents = t_crepe.bins_to_cents(torch.from_numpy(bins))
    np.testing.assert_allclose(cents.numpy(), np.asarray(j_crepe.bins_to_cents(jnp.asarray(bins))), rtol=1e-7)
    freqs = t_crepe.cents_to_frequency(cents)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(j_crepe.cents_to_frequency(
        j_crepe.bins_to_cents(jnp.asarray(bins)))), rtol=1e-6)
    np.testing.assert_allclose(t_crepe.frequency_to_bins(freqs).numpy(), bins, atol=1e-3)
    np.testing.assert_array_equal(t_crepe._freq_mask(50.0, 2000.0), j_crepe._freq_mask(50.0, 2000.0))


def test_viterbi_follows_ridge(rng):
    """The JAX suite's ridge case (tests/test_crepe.py:114): a drifting
    ridge with outlier frames that argmax chases. The port's path is
    JAX's, and tracks the ridge."""
    t, drift = 200, 0.25
    bins = (100 + drift * np.arange(t)).astype(int)
    probs = rng.random((t, 360)).astype(np.float32) * 0.3
    probs[np.arange(t), bins] = 0.9
    probs[rng.choice(t, 20, replace=False), 300] = 1.0
    path = t_crepe.viterbi_decode(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(path, np.asarray(j_crepe.viterbi_decode(jnp.asarray(probs))))
    am = t_crepe.argmax_decode(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(am, np.asarray(j_crepe.argmax_decode(jnp.asarray(probs))))
    assert np.abs(path - bins).mean() < 1.0 < np.abs(am - bins).mean()


def _dp_path(probs, window=12):
    t, n = probs.shape
    diff = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]).astype(np.float64)
    trans = np.maximum(window - diff, 0.0)
    log_trans = np.log(trans / trans.sum(1, keepdims=True) + 1e-20)
    log_obs = np.log(probs / np.maximum(probs.sum(-1, keepdims=True), 1e-12) + 1e-20)
    delta = log_obs[0] - np.log(n)
    ptrs = np.zeros((t - 1, n), np.int64)
    for i in range(1, t):
        scores = delta[:, None] + log_trans
        ptrs[i - 1] = scores.argmax(0)
        delta = scores.max(0) + log_obs[i]
    ref = np.zeros(t, np.int64)
    ref[-1] = delta.argmax()
    for i in range(t - 2, -1, -1):
        ref[i] = ptrs[i, ref[i + 1]]
    return ref


@pytest.mark.parametrize("t", [1, 2, 3, 40, 257])
def test_viterbi_matches_bruteforce_dp(rng, t):
    """The JAX suite's brute-force case (tests/test_crepe.py:133, 40
    frames) and lengths around the backtrack's doubling: the port's path
    is the numpy dynamic program's and JAX's."""
    probs = rng.random((t, 360)).astype(np.float32)
    path = t_crepe.viterbi_decode(torch.from_numpy(probs)).numpy()
    assert path.shape == (t,) and path.dtype == np.int64
    np.testing.assert_array_equal(path, _dp_path(probs))
    np.testing.assert_array_equal(path, np.asarray(j_crepe.viterbi_decode(jnp.asarray(probs))))


def test_local_average_cents_matches_jax(rng):
    probs = rng.random((30, 360)).astype(np.float32)
    bins = np.concatenate([[0, 2, 359, 357], rng.integers(0, 360, 26)])
    out = t_crepe.local_average_cents(torch.from_numpy(probs), torch.from_numpy(bins)).numpy()
    ref = np.asarray(j_crepe.local_average_cents(jnp.asarray(probs), jnp.asarray(bins)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_frame_audio_matches_jax(rng):
    audio = (rng.standard_normal(4100) * 3.0 + 1.0).astype(np.float32)
    audio[:600] = 0.0  # a window of zeros: the std floor
    for hop in (128, 77):
        out = t_crepe.frame_audio(torch.from_numpy(audio), hop).numpy()
        ref = np.asarray(j_crepe.frame_audio(jnp.asarray(audio), hop))
        assert out.shape == ref.shape == (1 + 4100 // hop, 1024)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_cnn_matches_jax_apply(rng):
    """Random torchcrepe-layout weights at tiny capacity, loaded as they
    are, against JAX ``Crepe.apply`` on its conversion: atol 1e-5 (observed
    when written: <= 6e-8). Full capacity is held card vs CPU in
    ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
    sd = _torchcrepe_state(rng, "tiny")
    model = t_crepe.Crepe("tiny")
    model.load_state_dict(sd, strict=False)
    x = rng.standard_normal((6, 1024)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(j_crepe.Crepe("tiny").apply(_jax_params(sd), jnp.asarray(x)))
    assert out.shape == (6, 360)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_from_jax_params_and_the_npz_cache(rng, tmp_path):
    """JAX's own random init goes into the port through
    ``from_jax_params`` (its capacity read from the shapes) and through
    the ``.npz`` cache JAX writes: both give JAX's probabilities (atol
    1e-5) and the same state."""
    model = j_crepe.Crepe("tiny")
    params = model.init(jax.random.PRNGKey(3))
    x = rng.standard_normal((6, 1024)).astype(np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    ported = t_crepe.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert ported.capacity == "tiny"
    path = str(tmp_path / "tiny.jax.npz")
    j_crepe.save_params_npz(params, path)
    cached = t_crepe.load_weights(path)
    for m in (ported, cached):
        with torch.no_grad():
            np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=1e-5)
    for k, v in ported.state_dict().items():
        assert torch.equal(v, cached.state_dict()[k]), k


@pytest.mark.parametrize("decoder", ["viterbi", "argmax"])
def test_predict_matches_jax(rng, decoder, monkeypatch):
    """``predict`` at tiny capacity with random weights on a noisy sweep
    (1 s, 126 frames, in batches of 64): the decoded bins identical to
    JAX's, f0 rtol 1e-5 and periodicity atol 1e-5."""
    bins = {}

    def keep(side, fn):
        def wrapped(probs, *args, **kwargs):
            out = fn(probs, *args, **kwargs)
            bins[side] = np.asarray(out)
            return out
        return wrapped

    name = f"{decoder}_decode"
    monkeypatch.setattr(j_crepe, name, keep("jax", getattr(j_crepe, name)))
    monkeypatch.setattr(t_crepe, name, keep("port", getattr(t_crepe, name)))
    sd = _torchcrepe_state(rng, "tiny")
    t = np.arange(16000) / 16000.0
    audio = (0.5 * np.sin(2 * np.pi * (220 * t + 55 * t**2)) + 0.02 * rng.standard_normal(t.shape))
    audio = audio.astype(np.float32)
    model = t_crepe.Crepe("tiny")
    model.load_state_dict(sd, strict=False)
    f0, per = t_crepe.predict(model, torch.from_numpy(audio), batch_size=64, decoder=decoder)
    f0_j, per_j = j_crepe.predict(j_crepe.Crepe("tiny"), _jax_params(sd), audio, batch_size=64,
                                  decoder=decoder)
    assert f0.shape == per.shape == (1 + 16000 // 128,)
    np.testing.assert_array_equal(bins["port"], bins["jax"])
    np.testing.assert_allclose(f0.numpy(), f0_j, rtol=1e-5)
    np.testing.assert_allclose(per.numpy(), per_j, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        t_crepe.predict(model, torch.from_numpy(audio), decoder="none")


def test_the_extractor_reads_a_torchcrepe_pth(rng, tmp_path, monkeypatch):
    """``extract_f0_with_crepe`` with a ``.pth`` (batch norm's counters
    included, as a saved torchcrepe module has them), by ``weights_path``
    and by ``$CREPE_WEIGHTS``: the tiny model's ``predict`` on the same
    audio. A state dict of another capacity, or one missing a tensor,
    raises."""
    sd = _torchcrepe_state(rng, "tiny", batches_tracked=True)
    pth = str(tmp_path / "tiny.pth")
    torch.save(sd, pth)
    audio = torch.from_numpy((0.3 * np.sin(2 * np.pi * 440 * np.arange(8000) / 16000)).astype(np.float32))
    model = t_crepe.Crepe("tiny")
    model.load_state_dict(sd)
    ref = t_crepe.predict(model, audio, fmax=1000.0)
    out = t_f0x.extract_f0_with_crepe(audio, full_model=False, weights_path=pth, maximum_frequency=1000.0)
    monkeypatch.setenv("CREPE_WEIGHTS", pth)
    env = t_f0x.extract_f0_with_crepe(audio, full_model=False, maximum_frequency=1000.0)
    for got in (out, env):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(RuntimeError, match="size mismatch"):
        t_crepe.load_weights(pth, "small")
    del sd["classifier.bias"]
    torch.save(sd, pth)
    with pytest.raises(KeyError, match="not a CREPE 'tiny' state dict: missing"):
        t_crepe.load_weights(pth, "tiny")
