"""The audio-rate FiLM -> shaper -> FiLM module of the port and NEWT's
audio-rate dispatch, against the JAX package on the CPU.

The JAX TPU kernels ``film_shaper_fused_fl`` (full-lane) and
``film_shaper_fused`` (half-lane), and their backwards, run in interpret
mode; the port's plain versions are held against both, and NEWT with
``fused=True | "full_lane" | "fl"``, the ``"full_lane_cr"`` fallback and
``remat_shaper`` against JAX ``NEWT.apply``. The CUDA kernels' own cases
are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.kernels import newt_fused as jnf
from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT

# the two TPU lane layouts of one function: (JAX kernel, its weight packing)
LAYOUTS = {
    "full_lane": (jnf.film_shaper_fused_fl, jnf.pack_weights_fl),
    "half_lane": (jnf.film_shaper_fused, jnf.pack_weights),
}


@pytest.fixture(scope="module")
def jax_newt():
    newt = JNEWT()
    return newt, newt.init(jax.random.PRNGKey(5))


def _inputs(b, ta, seed):
    rng = np.random.default_rng(seed)
    exciter = (rng.standard_normal((b, ta, 64)) * 0.5).astype(np.float32)
    film_a = rng.standard_normal((b, ta, 256)).astype(np.float32)
    return exciter, film_a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("b,ta", [(2, 48), (1, 130)])
def test_plain_matches_jax_audio_rate_kernels(jax_newt, layout, b, ta):
    """film_shaper_fl_plain vs each JAX layout's kernel in interpret mode,
    at the JAX suite's kernel-vs-chain bar rtol=1e-4, atol=1e-5
    (tests/test_newt_fused.py)."""
    _, p = jax_newt
    kernel, pack = LAYOUTS[layout]
    exciter, film_a = _inputs(b, ta, seed=ta)
    ref = kernel(jnp.asarray(exciter), jnp.asarray(film_a), pack(p["shaping_fn"]))
    out = nf.film_shaper_fl_plain(
        torch.from_numpy(exciter), torch.from_numpy(film_a), params_from_jax(p["shaping_fn"])
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_backward_matches_jax_audio_rate_grad(jax_newt, layout):
    """film_shaper_fl_grad_plain (d_exciter, d_film, the 170 weight planes
    unpacked to the shaper tree) against jax.grad through each layout's
    kernel, whose backward is _fused_bwd_fl / _fused_bwd, at the JAX
    suite's gradient bar rtol=1e-3, atol=1e-2."""
    _, p = jax_newt
    kernel, pack = LAYOUTS[layout]
    exciter, film_a = _inputs(2, 40, seed=3)
    dy = np.random.default_rng(4).standard_normal(exciter.shape).astype(np.float32)

    def loss(exc, f, sp):
        return jnp.sum(kernel(exc, f, pack(sp)) * dy)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(exciter), jnp.asarray(film_a), p["shaping_fn"]
    )
    d_exc, d_film, d_planes = nf.film_shaper_fl_grad_plain(
        torch.from_numpy(exciter), torch.from_numpy(film_a),
        params_from_jax(p["shaping_fn"]), torch.from_numpy(dy),
    )
    ours = [d_exc, d_film] + jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), nf.unpack_weight_grads(d_planes))
    )
    theirs = jax.tree_util.tree_leaves(ref)
    assert len(ours) == len(theirs) == 11
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-2)


def test_wrapper_dispatches_cpu_tensors_to_plain(jax_newt):
    """On CPU tensors film_shaper_fl is the plain version (no launch), and
    autograd through it gives film_shaper_fl_grad_plain's gradients."""
    _, p = jax_newt
    exciter, film_a = _inputs(2, 21, seed=6)
    sp = params_from_jax(p["shaping_fn"])
    exc, film = torch.from_numpy(exciter), torch.from_numpy(film_a).requires_grad_()
    before = (nf.film_shaper_fl.launches, nf.film_shaper_fl.bwd_launches)
    out = nf.film_shaper_fl(exc, film, sp)
    assert torch.equal(out, nf.film_shaper_fl_plain(exc, film, sp))
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(dy)
    assert (nf.film_shaper_fl.launches, nf.film_shaper_fl.bwd_launches) == before
    assert torch.equal(film.grad, nf.film_shaper_fl_grad_plain(exc, film, sp, dy)[1])


@pytest.mark.parametrize(
    "case",
    ["dtype", "channels", "film_width", "batch", "length", "contiguity", "weights", "device",
     "empty", "plain_shape"],
)
def test_fl_launch_checks_refuse_what_the_kernel_does_not_take(case):
    """The audio-rate kernels' checks run before any launch; here on CPU
    tensors, where they can be exercised without a card. Odd B*Ta is
    taken (JAX's full-lane kernel needed it even)."""
    exc = torch.zeros(1, 7, 64)
    film_a = torch.zeros(1, 7, 256)
    w = torch.zeros(170, 64)
    nf._check_fl(exc, film_a, w)
    if case == "dtype":
        exc = exc.double()
    elif case == "channels":
        exc = torch.zeros(1, 7, 32)
    elif case == "film_width":
        film_a = torch.zeros(1, 7, 128)
    elif case == "batch":
        film_a = torch.zeros(2, 7, 256)
    elif case == "length":
        film_a = torch.zeros(1, 8, 256)
    elif case == "contiguity":
        film_a = torch.zeros(1, 256, 7).transpose(1, 2)
    elif case == "weights":
        w = torch.zeros(170, 32)
    elif case == "device":
        w = w.to("meta")
    elif case == "empty":
        exc, film_a = exc[:, :0], film_a[:, :0]
    elif case == "plain_shape":
        with pytest.raises(ValueError):
            nf.film_shaper_fl_plain(exc, torch.zeros(1, 8, 256), {})
        return
    with pytest.raises((ValueError, TypeError)):
        nf._check_fl(exc, film_a, w)


def _newt_inputs(ta, tc, seed):
    rng = np.random.default_rng(seed)
    exciter = (rng.standard_normal((2, ta, 64)) * 0.5).astype(np.float32)
    emb = rng.standard_normal((2, tc, 128)).astype(np.float32)
    return exciter, emb


@pytest.mark.parametrize("fused", [True, "full_lane", "fl"])
def test_newt_audio_rate_matches_jax(jax_newt, fused):
    """NEWT(fused=...) on the CPU (the plain chain) against JAX NEWT.apply
    with the same ``fused``, which runs the half-lane (True) or full-lane
    Pallas kernel in interpret mode, at Ta=600, Tc=5: 1e-4/1e-5. The
    option is accepted at construction and per call."""
    newt, p = jax_newt
    exciter, emb = _newt_inputs(600, 5, seed=7)
    ref = np.asarray(jax.jit(lambda q, e, m: newt.apply(q, e, m, fused=fused))(
        p, jnp.asarray(exciter), jnp.asarray(emb)))
    port = NEWT(fused=fused)
    port.load_params(params_from_jax(p))
    default = NEWT()
    default.load_params(params_from_jax(p))
    with torch.no_grad():
        out = port(torch.from_numpy(exciter), torch.from_numpy(emb))
        per_call = default(torch.from_numpy(exciter), torch.from_numpy(emb), fused=fused)
    assert torch.equal(out, per_call)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_newt_full_lane_cr_fallback_matches_jax(jax_newt):
    """At a non-integer hop (Ta=130, Tc=4) neither gate takes the control-
    rate kernel, so JAX's "full_lane_cr" falls back to its audio-rate
    kernel (newt.py:163-165); the port's NEWT computes the same: 1e-4/1e-5."""
    newt, p = jax_newt
    exciter, emb = _newt_inputs(130, 4, seed=8)
    port = NEWT(fused="full_lane_cr")
    port.load_params(params_from_jax(p))
    assert not nf.supports_cr(port.shaping_fn, 130, 4) and nf.supports(port.shaping_fn)
    assert not jnf.supports_cr(newt.shaping_fn, 130, 4)
    ref = np.asarray(jax.jit(lambda q, e, m: newt.apply(q, e, m, fused="full_lane_cr"))(
        p, jnp.asarray(exciter), jnp.asarray(emb)))
    with torch.no_grad():
        out = port(torch.from_numpy(exciter), torch.from_numpy(emb))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_remat_shaper_gradients_match_the_chain_and_jax(jax_newt):
    """remat_shaper recomputes the shaper bank in the backward: the
    output and every gradient are bit-equal to the plain chain's, and
    within the JAX suite's gradient bar (rtol 1e-3, atol 1e-2) of JAX
    NEWT(remat_shaper=True) (jax.checkpoint around the shaper)."""
    _, p = jax_newt
    exciter, emb = _newt_inputs(96, 6, seed=9)
    dy = np.random.default_rng(10).standard_normal((2, 96, 1)).astype(np.float32)
    runs = []
    for remat in (True, False):
        newt = NEWT(remat_shaper=remat)
        newt.load_params(params_from_jax(p))
        out = newt(torch.from_numpy(exciter), torch.from_numpy(emb))
        (out * torch.from_numpy(dy)).sum().backward()
        runs.append((out.detach(), {n: t.grad for n, t in _leaves(newt.params())}))
    (out, grads), (chain_out, chain_grads) = runs
    assert torch.equal(out, chain_out)
    assert grads.keys() == chain_grads.keys()
    assert all(torch.equal(grads[n], chain_grads[n]) for n in grads)

    jnewt = JNEWT(remat_shaper=True)
    ref = jax.jit(jax.grad(lambda q: jnp.sum(
        jnewt.apply(q, jnp.asarray(exciter), jnp.asarray(emb), fused=False) * dy)))(p)
    theirs = dict(_leaves(ref))
    assert theirs.keys() == grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(theirs[name]), rtol=1e-3, atol=1e-2,
                                   err_msg=name)
