"""bfloat16 on the exciter-fused path and on FastNEWT: the port's
``NeuralWaveshaping.fuse_exciter`` / ``fuse_out_mixer`` and its FastNEWT
lookup under ``compute_dtype = "bfloat16"``.

On the CPU, against the JAX package: the plain versions of the exciter-fused
kernels (``newt_fused.bank_film_shaper_xcr_plain`` / ``bank_newt_xfull_plain``)
with a bf16 mixer and a bf16 or float32 FiLM against JAX's
``bank_film_shaper_fused_xcr`` / ``bank_newt_fused_xfull`` in interpret mode,
and their gradients against the float32 plain gradient (and, marked slow,
against ``jax.grad`` through JAX's bf16 kernels: ~100 s a case); each plain
version bit for bit the float32 plain version on widened inputs, rounded
once; the launch checks' instance pairs; the bf16 model's fused path against JAX's
``_fused_exciter_newt``; a bf16 training step with the fields against the
unfused bf16 step; the bf16 lookup's plain version against JAX's XLA lookup,
bit for bit; and a bf16 FastNEWT render against JAX's bf16 apply. The card's
cases (the bf16 instances against these plain versions) are in
tests/test_torch_cuda.py.

Both sides get the same float32 wrapped phase, made with numpy, and the same
bf16 values (rounded once, to nearest even, by torch; JAX's ``astype`` rounds
the same way).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.convert import load_reference_checkpoint
from neural_waveshaping_synthesis_tpu.kernels import newt_fused as jnf
from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.models.newt import fast_newt_lookup as j_fast_newt_lookup
from neural_waveshaping_synthesis_tpu.ops import oscillator as j_oscillator
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.kernels import fast_newt
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.models.modules import cast_params
from neural_waveshaping_synthesis_tpu_torch.training import Optimizer, TrainConfig, train_step

CKPT = str(Path(__file__).resolve().parents[1] / "docs" / "results" / "run120k_cr" / "checkpoint"
           / "best.ckpt")
B, TC, HOP, H, SR = 2, 6, 16, 101, 16000.0  # JAX's _xcr_inputs (tests/test_newt_fused.py)
BF16 = torch.bfloat16
KERNEL_BAR = 0.08  # JAX's bf16 kernel bar (kernel 1's, tests/test_newt_fused.py)
MODEL_BAR = {"rtol": 0.1, "atol": 0.05}  # JAX's test_model_fused_exciter_bf16
FILM_DTYPES = {"bf16": (BF16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _nrms(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _exact_wrapped_phase(f0, sample_rate):
    """The phase both sides get: float64 cumulative sum, wrapped, float32."""
    phase = 2 * np.pi * np.cumsum(np.asarray(f0, np.float64), axis=-1) / sample_rate
    return np.mod(phase, 2 * np.pi).astype(np.float32)


def _torch_tree(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype), tree)


@pytest.fixture(scope="module")
def xcr():
    """JAX's setup_xcr at B=2, Tc=6, hop 16, H=101: NEWT params, a
    0.1-scaled random mixer and w_out, f0 up to ~1.7 kHz (the antialias mask
    cuts real harmonics), offsets, film."""
    params = JNEWT().init(jax.random.PRNGKey(5))
    rng = np.random.default_rng(13)
    mixer = {"w": (rng.standard_normal((H, 64)) * 0.1).astype(np.float32),
             "b": (rng.standard_normal(64) * 0.1).astype(np.float32)}
    f0 = (220.0 * 2.0 ** rng.uniform(0, 3, (B, TC * HOP))).astype(np.float32)
    offsets = rng.uniform(-np.pi, np.pi, H).astype(np.float32)
    film_c = rng.standard_normal((B, TC, 256)).astype(np.float32)
    w_out = np.asarray(params["mixer"]["w"])[:, 0].copy()
    return params["shaping_fn"], mixer, w_out, f0, _exact_wrapped_phase(f0, SR), offsets, film_c


def _jax_kernel(kind, phase, f0, offsets, film, mixer, w_out, shaper, dtype):
    """JAX's exciter-fused kernel in interpret mode, its mixer (and w_out)
    packed in ``dtype``: the model's call (JAX models/neural_waveshaping.py)."""
    common = (jnp.asarray(phase), jnp.asarray(f0), jnf.pack_offsets(jnp.asarray(offsets), H), film,
              jnf.pack_mixer(mixer, dtype))
    if kind == "xcr":
        return jnf.bank_film_shaper_fused_xcr(*common, jnf.pack_weights_fl(shaper), H, SR, HOP, True)
    return jnf.bank_newt_fused_xfull(*common, jnf.pack_out_mixer({"w": w_out[:, None]}, dtype),
                                     jnf.pack_weights_fl(shaper), H, SR, HOP, True)


def _port_plain(kind, phase, f0, offsets, film, mixer, w_out, shaper):
    args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets), film, mixer)
    if kind == "xcr":
        return nf.bank_film_shaper_xcr_plain(*args, shaper, H, SR, HOP)
    return nf.bank_newt_xfull_plain(*args, w_out, shaper, H, SR, HOP)


def _bf16_inputs(xcr, film_dtype):
    """The port's bf16 mixer, w_out and shaper and its film in
    ``film_dtype``, and JAX's bf16 shaper tree and film of the same values."""
    shaper, mixer, w_out, _, _, _, film_c = xcr
    tdt, jdt = FILM_DTYPES[film_dtype]
    film_t = torch.from_numpy(film_c).to(tdt)
    film_j = jnp.asarray(film_t.float().numpy()).astype(jdt)
    shaper_j = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), shaper)
    port = (film_t, _torch_tree(mixer, BF16), torch.from_numpy(w_out).to(BF16),
            _torch_tree(shaper, BF16))
    return port, (film_j, shaper_j)


# measured when written, port against JAX (bf16 / f32 film): xcr max |diff|
# 0.031 / 0.031 (|JAX| up to 3.53), nRMS 3.4e-3 / 3.6e-3; xfull 0.0078 /
# 0.0039 (|JAX| up to 1.13), nRMS 4.1e-3 / 4.0e-3; JAX's bf16 output reads
# 4.0e-3 / 3.6e-3 (xcr) and 6.1e-3 / 5.2e-3 (xfull) from the port's float32
# plain version. The port keeps the exciter and the FiLM float32 inside the
# kernel, JAX rounds them to bf16 (ROADMAP section 3).
@pytest.mark.parametrize("film_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_plain_forward_in_bf16_matches_jax_kernel(xcr, kind, film_dtype):
    """The plain forward with a bf16 mixer (and w_out) and a bf16 or float32
    film against JAX's kernel in interpret mode on the same values: the
    output bf16 in both, within rtol/atol 0.08 (JAX's bf16 kernel bar)."""
    shaper, mixer, w_out, f0, phase, offsets, _ = xcr
    (film_t, mixer_t, w_out_t, shaper_t), (film_j, shaper_j) = _bf16_inputs(xcr, film_dtype)
    ref = _jax_kernel(kind, phase, f0, offsets, film_j, mixer, w_out, shaper_j, jnp.bfloat16)
    out = _port_plain(kind, phase, f0, offsets, film_t, mixer_t, w_out_t, shaper_t)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert out.shape == ((B, TC * HOP, 64) if kind == "xcr" else (B, TC * HOP))
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=KERNEL_BAR, atol=KERNEL_BAR)
    assert not np.array_equal(_f32(out), _f32(ref))  # JAX rounds inside its kernel; the port does not


@pytest.mark.parametrize("film_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_plain_in_bf16_is_the_float32_plain_rounded_once(xcr, kind, film_dtype):
    """Each bf16 plain version, forward and backward, is the float32 plain
    version on the widened inputs with each output rounded once to its
    input's dtype, bit for bit: float32 between load and store, as the
    kernels compute."""
    _, _, _, f0, phase, offsets, _ = xcr
    (film_t, mixer_t, w_out_t, shaper_t), _ = _bf16_inputs(xcr, film_dtype)
    shape = (B, TC * HOP, 64) if kind == "xcr" else (B, TC * HOP)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(BF16)
    wide = (film_t.float(), cast_params(mixer_t, torch.float32), w_out_t.float(),
            cast_params(shaper_t, torch.float32))
    out = _port_plain(kind, phase, f0, offsets, film_t, mixer_t, w_out_t, shaper_t)
    ref = _port_plain(kind, phase, f0, offsets, *wide)
    assert torch.equal(out, ref.to(BF16))
    args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets))
    grads, grads32 = [
        (nf.bank_film_shaper_xcr_grad_plain(*args, film, mixer, shaper, H, SR, HOP, g)
         if kind == "xcr" else
         nf.bank_newt_xfull_grad_plain(*args, film, mixer, wo, shaper, H, SR, HOP, g))
        for film, mixer, wo, shaper, g in ((film_t, mixer_t, w_out_t, shaper_t, dy),
                                           (*wide, dy.float()))]
    dtypes = [film_t.dtype, BF16, BF16, torch.float32] + ([BF16] if kind == "xfull" else [])
    assert len(grads) == len(grads32) == len(dtypes)
    for g, g32, dtype in zip(grads, grads32, dtypes):
        assert g.dtype == dtype and torch.equal(g, g32.to(dtype))


def _jax_bf16_vjp(kind, phase, f0, offsets, film_j, mixer, w_out_j, shaper_j, dy):
    """jax.grad of sum(out * dy) through JAX's bf16 kernel in interpret mode
    (its backward _fused_bwd_xcr / _fused_bwd_xfull) -> (d_film, d_mixer,
    d_w_out, d_shaper)."""
    def loss(film, mp, wo, sp):
        common = (jnp.asarray(phase), jnp.asarray(f0), jnf.pack_offsets(jnp.asarray(offsets), H), film,
                  jnf.pack_mixer(mp, jnp.bfloat16))
        if kind == "xcr":
            out = jnf.bank_film_shaper_fused_xcr(*common, jnf.pack_weights_fl(sp), H, SR, HOP, True)
        else:
            out = jnf.bank_newt_fused_xfull(*common, jnp.concatenate([wo, wo])[None, :],
                                            jnf.pack_weights_fl(sp), H, SR, HOP, True)
        return jnp.sum(out.astype(jnp.float32) * dy)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        film_j, jax.tree_util.tree_map(jnp.asarray, mixer), w_out_j, shaper_j)


def _port_grads(kind, phase, f0, offsets, film, mixer, w_out, shaper, dy):
    """The plain backward -> [d_film, d_w, d_b, the shaper's 9 leaves (JAX
    order), d_w_out for xfull], as float32 numpy arrays."""
    args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets), film, mixer)
    if kind == "xcr":
        grads = nf.bank_film_shaper_xcr_grad_plain(*args, shaper, H, SR, HOP, dy)
    else:
        grads = nf.bank_newt_xfull_grad_plain(*args, w_out, shaper, H, SR, HOP, dy)
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), nf.unpack_weight_grads(grads[3].detach())))
    return [_f32(g) for g in grads[:3]] + leaves + [_f32(g) for g in grads[4:]]


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_plain_backward_in_bf16_tracks_the_float32_plain_gradient(xcr, kind):
    """The bf16 plain backward (bf16 mixer, w_out, shaper, film and
    cotangent, as the bf16 model hands them) against the float32 plain
    backward on the unrounded inputs, which tests/test_torch_exciter_fused.py
    holds against jax.grad through JAX's float32 kernel: each gradient
    (d_film, d_w, d_b, the shaper's leaves, xfull's d_w_out) in its input's
    dtype and within relative norm 0.08 (JAX's bf16 gradient bar), and not
    the float32 gradient. Measured when written: at most 0.056 (xcr) and
    0.071 (xfull), both the mixer's d_w, a sum over the samples that
    cancels."""
    shaper, mixer, w_out, f0, phase, offsets, film_c = xcr
    (film_t, mixer_t, w_out_t, shaper_t), _ = _bf16_inputs(xcr, "bf16")
    shape = (B, TC * HOP, 64) if kind == "xcr" else (B, TC * HOP)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(21))
    args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets), film_t, mixer_t)
    grads = (nf.bank_film_shaper_xcr_grad_plain(*args, shaper_t, H, SR, HOP, dy.to(BF16))
             if kind == "xcr" else
             nf.bank_newt_xfull_grad_plain(*args, w_out_t, shaper_t, H, SR, HOP, dy.to(BF16)))
    assert [g.dtype for g in grads] == [BF16, BF16, BF16, torch.float32] + [BF16] * (kind == "xfull")
    ours = _port_grads(kind, phase, f0, offsets, film_t, mixer_t, w_out_t, shaper_t, dy.to(BF16))
    ref = _port_grads(kind, phase, f0, offsets, torch.from_numpy(film_c), _torch_tree(mixer),
                      torch.from_numpy(w_out), _torch_tree(shaper), dy)
    rels = [_rel(a, b) for a, b in zip(ours, ref)]
    assert len(rels) == 12 + (kind == "xfull") and max(rels) < KERNEL_BAR, rels
    assert min(rels) > 0.0


# measured when written (relative norm from JAX's bf16 VJP: the port in
# bf16 / the port in float32): xcr at Tc=4 d_film 0.024 / 0.027, d_w 0.050 /
# 0.086, d_b 0.128 / 0.143, the shaper's leaves <= 0.052 / 0.071; xfull at
# Tc=2 d_film 0.015 / 0.015, d_w 0.052 / 0.105, d_b 0.039 / 0.032, the
# leaves <= 0.047 / 0.045, d_w_out 0.0041 / 0.0044. JAX's kernel rounds the
# exciter, its FiLM planes and (xfull) dpre to bf16 inside; the port does
# not, so JAX's d_b at Tc=4 sits 0.143 from the float32 gradient.
@pytest.mark.slow  # ~100 s a case here: jax.grad through the interpret-mode bf16 kernel
@pytest.mark.parametrize("kind,tc", [("xcr", 4), ("xfull", 2)])
def test_plain_backward_in_bf16_matches_jax_vjp(xcr, kind, tc):
    """The bf16 plain backward against jax.grad through JAX's bf16 kernel in
    interpret mode on the first clip: each gradient within relative norm
    0.08 of JAX's (its bf16 gradient bar), or, where JAX's in-kernel bf16
    roundings put its gradient farther than that from the float32 one, no
    farther from JAX's than the port's float32 gradient is, plus 0.02."""
    shaper, mixer, w_out, f0, phase, offsets, film_c = xcr
    ta = tc * HOP
    f0, phase, film_c = f0[:1, :ta], phase[:1, :ta], film_c[:1, :tc]
    film_t = torch.from_numpy(film_c).to(BF16)
    film_j = jnp.asarray(film_t.float().numpy()).astype(jnp.bfloat16)
    shaper_j = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), shaper)
    shape = (1, ta, 64) if kind == "xcr" else (1, ta)
    dy_t = torch.randn(shape, generator=torch.Generator().manual_seed(21)).to(BF16)
    g_film, g_mixer, g_wo, g_shaper = _jax_bf16_vjp(
        kind, phase, f0, offsets, film_j, mixer, jnp.asarray(w_out).astype(jnp.bfloat16), shaper_j,
        dy_t.float().numpy())
    ref = [_f32(g) for g in (g_film, g_mixer["w"], g_mixer["b"], *jax.tree_util.tree_leaves(g_shaper))]
    ref += [_f32(g_wo)] if kind == "xfull" else []
    ours = _port_grads(kind, phase, f0, offsets, film_t, _torch_tree(mixer, BF16),
                       torch.from_numpy(w_out).to(BF16), _torch_tree(shaper, BF16), dy_t)
    wide = _port_grads(kind, phase, f0, offsets, film_t.float(), _torch_tree(mixer), torch.from_numpy(w_out),
                       _torch_tree(shaper), dy_t.float())
    for a, a32, b in zip(ours, wide, ref):
        assert _rel(a, b) < max(KERNEL_BAR, _rel(a32, b) + 0.02), (_rel(a, b), _rel(a32, b))
    assert np.abs(ref[1]).max() > 1e-2  # the mixer gradient is not vacuous


def _x_args(mixer=torch.float32, film=torch.float32, w_out=None, **dtypes):
    rng = np.random.default_rng(1)
    ta = TC * HOP

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    a = dict(phase=t(B, ta), f0=t(B, ta), offsets=t(H), film_c=t(B, TC, 256, dtype=film),
             w=t(H, 64, dtype=mixer), b=t(64, dtype=mixer), weights=t(170, 64),
             w_out=None if w_out is None else t(64, dtype=w_out))
    for name, dtype in dtypes.items():
        a[name] = a[name].to(dtype)
    return a


def _check(a):
    return nf._check_x(a["phase"], a["f0"], a["offsets"], a["film_c"], a["w"], a["b"], a["weights"],
                       a["w_out"], H, HOP)


@pytest.mark.parametrize("mixer,film,suffix", [
    (torch.float32, torch.float32, ""), (BF16, BF16, "_bf16"), (BF16, torch.float32, "_bf16_f32")])
@pytest.mark.parametrize("xfull", [False, True])
def test_check_x_takes_the_three_pairs(mixer, film, suffix, xfull):
    """(mixer, film) float32 / float32, bf16 / bf16 and bf16 / float32, for
    xcr and for xfull (w_out in the mixer's dtype): the symbol suffix of the
    instance."""
    assert _check(_x_args(mixer=mixer, film=film, w_out=mixer if xfull else None)) == suffix


@pytest.mark.parametrize("case", ["f32_mixer_bf16_film", "mixer_b", "w_out", "phase", "f0", "offsets",
                                  "weights", "float16"])
def test_check_x_refuses_mixed_others(case):
    """Any other mix raises TypeError before a launch: a float32 mixer with
    a bf16 film, a mixer whose b or w_out is not of w's dtype, a bf16 phase,
    f0, offsets or planes, float16."""
    a = {"f32_mixer_bf16_film": lambda: _x_args(film=BF16),
         "mixer_b": lambda: _x_args(mixer=BF16, film=BF16, b=torch.float32),
         "w_out": lambda: _x_args(mixer=BF16, film=BF16, w_out=torch.float32),
         "phase": lambda: _x_args(mixer=BF16, film=BF16, phase=BF16),
         "f0": lambda: _x_args(mixer=BF16, film=BF16, f0=BF16),
         "offsets": lambda: _x_args(mixer=BF16, offsets=BF16),
         "weights": lambda: _x_args(mixer=BF16, film=BF16, weights=BF16),
         "float16": lambda: _x_args(mixer=torch.float16, film=torch.float16)}[case]()
    with pytest.raises(TypeError):
        _check(a)


# ---------------------------------------------------------------------------
# the model: NeuralWaveshaping(compute_dtype="bfloat16") with the fields
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_model_params():
    return JNeuralWaveshaping().init(jax.random.PRNGKey(0))


def _model(jparams, **fields):
    model = NeuralWaveshaping(**fields)
    model.load_params(params_from_jax(jparams))
    return model


def _spy(monkeypatch):
    """Count the model's calls of the two fused wrappers."""
    calls = {"xcr": 0, "xfull": 0}
    for kind, name in (("xcr", "bank_film_shaper_xcr"), ("xfull", "bank_newt_xfull")):
        real = getattr(nf, name)

        def spy(*args, _kind=kind, _real=real, **kwargs):
            calls[_kind] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(nf, name, spy)
    return calls


_WRAPPERS = (nf.bank_film_shaper_xcr, nf.bank_newt_xfull)  # the counters' owners, before any spy


def _launches():
    return [getattr(w, f"{p}launches{s}") for w in _WRAPPERS
            for p in ("", "bwd_") for s in ("", "_bf16", "_bf16_f32")]


# measured when written (B=2, Tc=6, hop 16, the JAX init's weights), max
# |port - JAX|: xcr 0.0027, xfull 0.0020 (|JAX| up to 0.38); the port's bf16
# output 0.0031 / 0.0036 from its float32 output.
@pytest.mark.parametrize("fuse_out_mixer", [False, True])
def test_bf16_fused_model_matches_jax(jax_model_params, monkeypatch, fuse_out_mixer):
    """NeuralWaveshaping(compute_dtype="bfloat16")._fused_exciter_newt on the
    CPU (the plain version, one wrapper call, no kernel launch) against JAX's
    bf16 _fused_exciter_newt(..., force=True) (its kernel in interpret mode)
    on the same f0, embedding and offsets, JAX given the port's exact phase:
    float32 out, within JAX's bar (rtol 0.1, atol 0.05), and not the float32
    output."""
    rng = np.random.default_rng(4)
    f0_up = (220.0 * 2.0 ** rng.uniform(0, 3, (B, TC * HOP))).astype(np.float32)
    emb = rng.standard_normal((B, TC, 128)).astype(np.float32)
    offsets = rng.uniform(-np.pi, np.pi, H).astype(np.float32)
    monkeypatch.setattr(j_oscillator, "phase_accumulate",
                        lambda f, sr: jnp.asarray(_exact_wrapped_phase(f, sr)))
    jmodel = JNeuralWaveshaping(fuse_exciter=True, fuse_out_mixer=fuse_out_mixer,
                                compute_dtype="bfloat16")
    ref = np.asarray(jmodel._fused_exciter_newt(
        jax_model_params, jnp.asarray(f0_up), jnp.asarray(emb), None, jnp.asarray(offsets), force=True))
    fields = dict(fuse_exciter=True, fuse_out_mixer=fuse_out_mixer)
    model = _model(jax_model_params, compute_dtype="bfloat16", **fields)
    f0_t, emb_t, off_t = (torch.from_numpy(a) for a in (f0_up, emb, offsets))
    with torch.no_grad():
        out32 = _model(jax_model_params, **fields)._fused_exciter_newt(f0_t, emb_t, off_t)
        calls, before = _spy(monkeypatch), _launches()
        out = model._fused_exciter_newt(f0_t, emb_t, off_t)
    assert calls == {"xcr": int(not fuse_out_mixer), "xfull": int(fuse_out_mixer)}
    assert _launches() == before
    assert out.dtype == torch.float32 and out.shape == ref.shape == (B, TC * HOP, 1)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_BAR)
    assert float(np.max(np.abs(out.numpy() - out32.numpy()))) > 1e-3  # it computed in bf16


def test_bf16_fused_model_honours_cr_film_f32(jax_model_params, monkeypatch):
    """NEWT.cr_film_f32 hands the exciter-fused wrapper a float32 film with the
    bf16 mixer (the (bf16, f32) pair), as JAX's path does. The film's values
    are bf16 either way (cast after the bf16 FiLM MLP) and the kernels compute
    in float32, so both pairs give the same bits."""
    rng = np.random.default_rng(8)
    f0_up = torch.from_numpy((220.0 * 2.0 ** rng.uniform(0, 3, (B, TC * HOP))).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((B, TC, 128)).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-np.pi, np.pi, H).astype(np.float32))
    seen = []
    real = nf.bank_film_shaper_xcr

    def spy(phase, f0, offsets, film_c, mixer, *args, **kwargs):
        seen.append((film_c.dtype, mixer["w"].dtype, mixer["b"].dtype))
        return real(phase, f0, offsets, film_c, mixer, *args, **kwargs)

    monkeypatch.setattr(nf, "bank_film_shaper_xcr", spy)
    model = _model(jax_model_params, compute_dtype="bfloat16", fuse_exciter=True)
    with torch.no_grad():
        out16 = model._fused_exciter_newt(f0_up, emb, off)
        model.newt.cr_film_f32 = True
        out_f32_film = model._fused_exciter_newt(f0_up, emb, off)
    assert seen == [(BF16, BF16, BF16), (torch.float32, BF16, BF16)]
    assert out_f32_film.dtype == torch.float32 and torch.equal(out16, out_f32_film)


def _step_inputs():
    rng = np.random.default_rng(7)
    tc = 20  # the loss's largest STFT frame, 2048, needs more than 2048 samples
    f0 = np.geomspace(220.0, 1700.0, tc).astype(np.float32)
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, 128)) / 16000
    batch = {"f0": torch.from_numpy(f0[None]),
             "control": torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32)),
             "audio": torch.from_numpy((0.1 * np.sin(phase) + 0.05 * np.sin(3 * phase))[None].astype(np.float32))}
    offsets = torch.from_numpy(rng.uniform(-np.pi, np.pi, H).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    return batch, offsets, noise


def _step(jparams, **fields):
    """One train_step (loss, backward, clip, Adam) of a model with these
    fields from the JAX init's weights -> (loss, {name: grad}, parameter dtypes)."""
    batch, offsets, noise = _step_inputs()
    model = _model(jparams, **fields)
    opt = Optimizer(model.parameters(), TrainConfig())
    metrics = train_step(model, opt, batch, phase_offset=offsets, noise=noise)
    return (float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
            {t.dtype for t in model.parameters()})


@pytest.fixture(scope="module")
def reference_steps(jax_model_params):
    """The unfused bf16 step and the float32 step, shared by both fields."""
    return _step(jax_model_params, compute_dtype="bfloat16"), _step(jax_model_params)


# measured when written (Tc=20, one clip), against the unfused bf16 step:
# loss 1.8e-5 (xcr) and 1.3e-5 (xfull) relative (the float32 step's 1.4e-3);
# all gradients together 0.034 / 0.043; the harmonic mixer's w 0.70 / 0.88,
# where the unfused bf16 step is 1.00 from the float32 one; every other leaf
# <= 0.10 / 0.14, each below its own bf16-vs-float32 distance.
@pytest.mark.parametrize("fields", [{"fuse_exciter": True},
                                    {"fuse_exciter": True, "fuse_out_mixer": True}])
def test_bf16_train_step_with_the_fields_tracks_the_unfused_bf16_step(jax_model_params, reference_steps,
                                                                       fields):
    """One bf16 train_step (loss, backward, clip, Adam) from the same
    weights, batch, offsets and noise with the fields set and without (the
    bf16 path: kernel 1's plain version), and the float32 step: the loss
    within 1e-3 relative of the unfused bf16 step's (the bf16 step's bar
    against JAX; the float32 step is farther); all gradients together within
    relative norm 0.08 of the unfused bf16 step's (the bf16 gradient bar),
    and each leaf float32, nonzero and within 0.08 of it or no farther from
    it than the unfused bf16 step is from float32 (the harmonic mixer's w
    gradient is a sum that cancels: bf16's roundings move it by its own
    size on every bf16 path); the parameters float32 after the update."""
    (loss0, grads0, _), (loss32, grads32, _) = reference_steps
    loss1, grads1, dtypes = _step(jax_model_params, compute_dtype="bfloat16", **fields)
    assert np.isfinite(loss1) and abs(loss1 - loss0) <= 1e-3 * abs(loss0) < abs(loss32 - loss0)
    assert dtypes == {torch.float32}
    flat = [np.concatenate([g[n].numpy().ravel() for n in sorted(g)]) for g in (grads1, grads0)]
    assert _rel(*flat) < KERNEL_BAR, _rel(*flat)
    for name, g in grads1.items():
        assert g.dtype == torch.float32 and torch.count_nonzero(g) > 0, name
        rel, bf16_gap = _rel(g.numpy(), grads0[name].numpy()), _rel(grads0[name].numpy(), grads32[name].numpy())
        assert rel < max(KERNEL_BAR, bf16_gap), (name, rel, bf16_gap)


# ---------------------------------------------------------------------------
# FastNEWT under bf16: the lookup's bf16 index, and the render
# ---------------------------------------------------------------------------
def _lookup_inputs(s, seed):
    """(S, 64) table and a (2, 300, 64) x uniform over [-3.5, 3.5] (both
    table edges passed, half of it at bf16 indices >= S/2, where a bf16 step
    is 8 or 16 bins), with its first rows at the edges and the grid points
    min, 0, max and a huge value."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((s, 64)).astype(np.float32)
    x = rng.uniform(-3.5, 3.5, (2, 300, 64)).astype(np.float32)
    x[0, :6] = np.array([-3.0, 0.0, 2.999, 3.0, 3.5, 1e30], np.float32)[:, None]
    xt = torch.from_numpy(x).to(BF16)
    return table, xt, jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("s", [4096, 256])
def test_bf16_plain_lookup_matches_jax_bit_for_bit(s):
    """The plain lookup on a bf16 x against JAX's XLA fast_newt_lookup (the
    model path's lookup) on the same bf16 x, op by op: float32 out, bit for
    bit, the edges too (a clamped lower of S - 1 = 4095 is 4096 in bf16).
    Its bf16 index is not the float32 one: up to 16 bins away inside the
    table at S = 4096 (1 at S = 256), so a lookup that widened x first would
    fail."""
    table, xt, xj = _lookup_inputs(s, seed=s)
    ours = fast_newt.fast_newt_lookup_plain(torch.from_numpy(table), xt)
    ref = np.asarray(j_fast_newt_lookup(jnp.asarray(table), xj))
    assert ours.dtype == torch.float32 and ref.dtype == np.float32
    assert np.all(np.isfinite(ours.numpy())) and np.array_equal(ours.numpy(), ref)
    widened = fast_newt.fast_newt_lookup_plain(torch.from_numpy(table), xt.float())
    idx16 = np.floor(_f32((s * (xt - fast_newt.TABLE_MIN)) / torch.tensor(fast_newt.SPAN, dtype=BF16)))
    idx32 = np.floor(s * (xt.float().numpy() - fast_newt.TABLE_MIN) / fast_newt.SPAN)
    inside = (idx32 >= 0) & (idx32 < s)
    assert np.abs(idx16 - idx32)[inside].max() >= (8 if s == 4096 else 1)
    assert np.mean(idx32[inside] >= s // 2) > 0.4
    assert not np.array_equal(widened.numpy(), ours.numpy())


def test_bf16_lookup_wrapper_takes_a_bf16_x_on_the_cpu():
    """fast_newt_lookup on a CPU bf16 x is the plain version (no launch);
    the launch checks take a bf16 x (the _bf16 instance) and refuse a bf16
    table or a float16 x."""
    table, xt, _ = _lookup_inputs(4096, seed=1)
    table = torch.from_numpy(table)
    before = (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16)
    assert torch.equal(fast_newt.fast_newt_lookup(table, xt), fast_newt.fast_newt_lookup_plain(table, xt))
    assert (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16) == before
    with pytest.raises(ValueError, match="CUDA"):  # dtypes pass; the device does not
        fast_newt._check(table, xt)
    with pytest.raises(TypeError, match="table must be float32"):
        fast_newt._check(table.to(BF16), xt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fast_newt._check(table, xt.to(torch.float16))


@pytest.fixture(scope="module")
def jax_ckpt():
    return load_reference_checkpoint(CKPT)[0]


# measured when written (Tc=16, run120k_cr weights, its 4096-entry table),
# nRMS: 4.8e-3 from JAX's jitted bf16 apply, 1.45e-2 from the port's float32
# FastNEWT render, which reads 1.47e-2 from JAX's bf16 apply. The bf16 index
# moves in steps of up to 16 bins, so the FiLM MLP's bf16 roundings, which
# the two frameworks place apart, reach the output as whole bins: the bar
# sits between the two, so a float32 render fails it.
@pytest.mark.parametrize("fused", ["cr", "full_lane"])
def test_bf16_fast_newt_render_matches_jax_bf16_apply(jax_ckpt, fused):
    """NeuralWaveshaping(compute_dtype="bfloat16") with a FastNEWT table on
    the CPU (the lookup's plain version: no launch) against JAX's bf16 apply
    with the same table (run120k_cr's weights, Tc=16, injected offsets and
    noise): float32 out, within nRMS 0.01 of JAX's and at least 1e-3 from the
    port's float32 FastNEWT render. NEWT's fused setting
    does not matter with a table, as in JAX."""
    rng = np.random.default_rng(9)
    tc = 16
    base = 220.0 * 2.0 ** rng.uniform(0, 2, (2, 1))
    f0 = (base * np.linspace(1.0, 1.3, tc) + rng.standard_normal((2, tc))).astype(np.float32)
    control = rng.standard_normal((2, tc, 2)).astype(np.float32)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)
    m16 = _model(jax_ckpt, compute_dtype="bfloat16")
    m32 = _model(jax_ckpt)
    m16.newt.fused = m32.newt.fused = fused
    with torch.no_grad():
        table = m32.newt.bake_lookup_table()
    ref = np.asarray(jax.jit(
        lambda p, f, c, o, n, t: JNeuralWaveshaping(compute_dtype="bfloat16").apply(
            p, f, c, lookup_table=t, phase_offset=o, noise=n)
    )(jax_ckpt, f0, control, offset, noise, jnp.asarray(table.numpy())))
    before = (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16)
    outs = []
    for m in (m16, m32):
        with torch.inference_mode():
            outs.append(m(torch.from_numpy(f0), torch.from_numpy(control), phase_offset=torch.from_numpy(offset),
                          noise=torch.from_numpy(noise), lookup_table=table).numpy())
    out16, out32 = outs
    assert (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16) == before
    assert out16.dtype == np.float32 and np.all(np.isfinite(out16))
    assert _nrms(out16, ref) < 0.01, _nrms(out16, ref)
    assert _nrms(out16, out32) > 1e-3, _nrms(out16, out32)


def test_bf16_fast_newt_is_jax_s_lookup_path_op_by_op(jax_ckpt):
    """NEWT with a table on a bf16 exciter, from its bf16 FiLM on, against
    the JAX NEWT's table path (models/newt.py) run op by op on the same bf16
    FiLM and exciter: linear_upsample and the first FiLM in bf16, the lookup
    (bf16 index, float32 lerp), the second FiLM in float32 and dense_apply of
    the mixer cast to bf16 on a float32 x. float32 out from both, the same
    bits but for the float32 mixer's summation order (rtol 1e-6, atol
    1e-7)."""
    from neural_waveshaping_synthesis_tpu.models.modules import dense_apply as j_dense_apply
    from neural_waveshaping_synthesis_tpu.models.modules import film as j_film
    from neural_waveshaping_synthesis_tpu.ops.upsample import linear_upsample as j_linear_upsample

    rng = np.random.default_rng(10)
    exc = torch.from_numpy((rng.standard_normal((2, 256, 64)) * 0.7).astype(np.float32)).to(BF16)
    emb = torch.from_numpy(rng.standard_normal((2, 2, 128)).astype(np.float32)).to(BF16)
    model = _model(jax_ckpt, compute_dtype="bfloat16")
    with torch.inference_mode():
        table = model.newt.bake_lookup_table()
        out = model.newt(exc, emb, lookup_table=table)
        fp = model.newt.film_params(emb)
    assert out.dtype == torch.float32 and fp.dtype == BF16

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    gi, bi, gn, bn = jnp.split(j_linear_upsample(j(fp), 256), 4, axis=-1)
    x = j_fast_newt_lookup(jnp.asarray(table.numpy()), j_film(j(exc), gi, bi))
    mixer = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jax_ckpt["newt"]["mixer"])
    ref = j_dense_apply(mixer, j_film(x, gn, bn))
    assert ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
