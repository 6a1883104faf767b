"""The port's learned modules against the JAX package's, driven by one
parameter tree (JAX init -> ``params_from_jax``) on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.models import modules as jm
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.models import (
    ControlModule,
    Dense,
    LayerNorm,
    TimeDistributedMLP,
    TrainableNonlinearity,
)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_dense_and_layer_norm_match_jax():
    """One matmul / one normalisation: float32 rounding, 1e-5."""
    p = jm.dense_init(jax.random.PRNGKey(0), 24, 40)
    x = _x((2, 5, 24))
    dense = Dense(24, 40)
    dense.load_params(params_from_jax(p))
    ref = np.asarray(jm.dense_apply(p, jnp.asarray(x)))
    np.testing.assert_allclose(dense(torch.from_numpy(x)).detach().numpy(), ref, rtol=1e-5, atol=1e-5)

    ln_p = {"scale": _x((40,), 1), "bias": _x((40,), 2)}
    norm = LayerNorm(40)
    norm.load_params(params_from_jax(ln_p))
    y = _x((2, 5, 40), 3, 4.0)
    ref = np.asarray(jm.layer_norm_apply(ln_p, jnp.asarray(y)))
    np.testing.assert_allclose(norm(torch.from_numpy(y)).detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_time_distributed_mlp_matches_jax():
    """Four dense layers with LayerNorm + LeakyReLU(0.01): 1e-5."""
    cfg = jm.TimeDistributedMLP(128, 128, 256, depth=4)
    p = cfg.init(jax.random.PRNGKey(1))
    mlp = TimeDistributedMLP(128, 128, 256, depth=4)
    mlp.load_params(params_from_jax(p))
    x = _x((2, 9, 128), 4)
    ref = np.asarray(cfg.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        out = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_time_distributed_mlp_depth_check():
    with pytest.raises(ValueError):
        TimeDistributedMLP(8, 8, 8, depth=2)


def test_trainable_nonlinearity_matches_jax():
    """The shipped shaper (64 channels, width 8, depth 4, polynomial
    sine) in the einsum form. Input scales ~randn*10 push the first
    layer's arguments to tens of radians, where the two polynomial sines
    agree to ~1e-6; four layers keep it near 1e-5."""
    cfg = jm.TrainableNonlinearity(64, 8, depth=4)
    p = cfg.init(jax.random.PRNGKey(2))
    shaper = TrainableNonlinearity(64, 8, depth=4)
    shaper.load_params(params_from_jax(p))
    x = _x((2, 50, 64), 5, 0.5)
    ref = np.asarray(cfg.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        out = shaper(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_control_module_and_gru_final_state_match_jax(with_h0):
    """GRU (nn.GRU, gates r, z, n) + projection, including the final
    state: 40 recurrent steps of float32 rounding, 1e-5."""
    cfg = jm.ControlModule(2, 128, 128)
    p = cfg.init(jax.random.PRNGKey(3))
    module = ControlModule(2, 128, 128)
    module.load_params(params_from_jax(p))
    control = _x((2, 40, 2), 6)
    h0 = _x((2, 128), 7, 0.5) if with_h0 else None
    emb, h = cfg.apply(p, jnp.asarray(control), None if h0 is None else jnp.asarray(h0))
    with torch.no_grad():
        emb_t, h_t = module(
            torch.from_numpy(control), None if h0 is None else torch.from_numpy(h0)
        )
    assert h_t.shape == (2, 128)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h), rtol=1e-5, atol=1e-5)


def test_load_params_rejects_wrong_shape():
    dense = Dense(4, 3)
    with pytest.raises(ValueError):
        dense.load_params({"w": np.zeros((3, 4), np.float32), "b": np.zeros(3, np.float32)})


def test_generator_makes_init_reproducible():
    a = TrainableNonlinearity(64, 8, 4, generator=torch.Generator().manual_seed(0))
    b = TrainableNonlinearity(64, 8, 4, generator=torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
