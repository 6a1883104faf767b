"""The exciter-fused path of the port: ``newt_fused.bank_film_shaper_xcr`` /
``bank_newt_xfull`` and ``NeuralWaveshaping.fuse_exciter`` /
``fuse_out_mixer``.

On the CPU: the plain versions and their gradients against the JAX TPU
kernels ``bank_film_shaper_fused_xcr`` / ``bank_newt_fused_xfull`` and their
backwards (run by the JAX package in interpret mode), the gate, the launch
checks, the wrappers' CPU dispatch, the model's fused path against JAX's
``_fused_exciter_newt`` and against its own unfused path, its fallbacks, its
gin bindings and a training step. Both sides get the same float32 wrapped
phase, made with numpy. The card's cases are in tests/test_torch_cuda.py.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.kernels import newt_fused as jnf
from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping as JNeuralWaveshaping
from neural_waveshaping_synthesis_tpu.ops import oscillator as j_oscillator
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping, TrainableNonlinearity
from neural_waveshaping_synthesis_tpu_torch.ops import (
    bank_from_phase,
    bank_from_wrapped_phase,
    phase_accumulate,
    wrap_phase,
)
from neural_waveshaping_synthesis_tpu_torch.training import Optimizer, TrainConfig, train_step

CKPT = str(Path(__file__).resolve().parents[1] / "docs" / "results" / "run120k_cr" / "checkpoint"
           / "best.ckpt")
B, TC, HOP, H, SR = 2, 6, 16, 101, 16000.0  # JAX's _xcr_inputs (tests/test_newt_fused.py)


def _exact_wrapped_phase(f0, sample_rate):
    """The phase both sides get: float64 cumulative sum, wrapped, float32."""
    phase = 2 * np.pi * np.cumsum(np.asarray(f0, np.float64), axis=-1) / sample_rate
    return np.mod(phase, 2 * np.pi).astype(np.float32)


@pytest.fixture(scope="module")
def xcr():
    """JAX's setup_xcr: NEWT params, a 0.1-scaled random mixer, f0 up to
    ~1.7 kHz (so the antialias mask cuts real harmonics), offsets, film."""
    params = JNEWT().init(jax.random.PRNGKey(5))
    rng = np.random.default_rng(13)
    mixer = {"w": (rng.standard_normal((H, 64)) * 0.1).astype(np.float32),
             "b": (rng.standard_normal(64) * 0.1).astype(np.float32)}
    f0 = (220.0 * 2.0 ** rng.uniform(0, 3, (B, TC * HOP))).astype(np.float32)
    offsets = rng.uniform(-np.pi, np.pi, H).astype(np.float32)
    film_c = rng.standard_normal((B, TC, 256)).astype(np.float32)
    return params, mixer, f0, _exact_wrapped_phase(f0, SR), offsets, film_c


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), tree)


def _jax_kernel(kind, phase, f0, offsets, film, mixer, w_out, shaper):
    common = (jnp.asarray(phase), jnp.asarray(f0), jnf.pack_offsets(jnp.asarray(offsets), H), film,
              jnf.pack_mixer(mixer))
    if kind == "xcr":
        return jnf.bank_film_shaper_fused_xcr(*common, jnf.pack_weights_fl(shaper), H, SR, HOP, True)
    return jnf.bank_newt_fused_xfull(*common, jnf.pack_out_mixer({"w": w_out}),
                                     jnf.pack_weights_fl(shaper), H, SR, HOP, True)


def _port_plain(kind, phase, f0, offsets, film, mixer, w_out, shaper):
    args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets),
            torch.from_numpy(film), _t(mixer))
    if kind == "xcr":
        return nf.bank_film_shaper_xcr_plain(*args, shaper, H, SR, HOP)
    return nf.bank_newt_xfull_plain(*args, torch.from_numpy(np.asarray(w_out)[:, 0].copy()), shaper, H, SR, HOP)


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_plain_matches_jax_kernel(xcr, kind):
    """The plain forward against the JAX kernel in interpret mode, rtol
    1e-4, atol 1e-5 (the JAX suite's kernel-vs-chain bar)."""
    params, mixer, f0, phase, offsets, film_c = xcr
    w_out = params["mixer"]["w"]
    ref = _jax_kernel(kind, phase, f0, offsets, jnp.asarray(film_c), mixer, w_out, params["shaping_fn"])
    out = _port_plain(kind, phase, f0, offsets, film_c, mixer, w_out, params_from_jax(params["shaping_fn"]))
    assert out.shape == ((B, TC * HOP, 64) if kind == "xcr" else (B, TC * HOP))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_plain_gradients_match_jax_kernel(xcr, kind):
    """The plain backward (d_film_c, mixer d_w and d_b, the 170 planes
    unpacked to the shaper tree, and for xfull d_w_out) against jax.grad
    through the JAX kernel in interpret mode, whose backward is
    _fused_bwd_xcr / _fused_bwd_xfull: rtol 1e-3, atol 1e-2, the JAX
    suite's gradient bar (tests/test_newt_fused.py:767-769)."""
    params, mixer, f0, phase, offsets, film_c = xcr
    w_out = params["mixer"]["w"]
    shape = (B, TC * HOP, 64) if kind == "xcr" else (B, TC * HOP)
    dy = np.random.default_rng(21).standard_normal(shape).astype(np.float32)

    def loss(film, mp, wo, sp):
        return jnp.sum(_jax_kernel(kind, phase, f0, offsets, film, mp, wo, sp) * dy)

    g_film, g_mixer, g_wo, g_shaper = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(film_c), jax.tree_util.tree_map(jnp.asarray, mixer), w_out, params["shaping_fn"])
    plain_args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets),
                  torch.from_numpy(film_c), _t(mixer))
    shaper = params_from_jax(params["shaping_fn"])
    if kind == "xcr":
        ours = nf.bank_film_shaper_xcr_grad_plain(*plain_args, shaper, H, SR, HOP, torch.from_numpy(dy))
    else:
        ours = nf.bank_newt_xfull_grad_plain(*plain_args, torch.from_numpy(np.asarray(w_out)[:, 0].copy()),
                                             shaper, H, SR, HOP, torch.from_numpy(dy))
        np.testing.assert_allclose(ours[4].numpy(), np.asarray(g_wo)[:, 0], rtol=1e-3, atol=1e-2)
    d_film, d_w, d_b, d_planes = ours[:4]
    pairs = [(d_film, g_film), (d_w, g_mixer["w"]), (d_b, g_mixer["b"])]
    pairs += zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(),
                                                                  nf.unpack_weight_grads(d_planes))),
                 jax.tree_util.tree_leaves(g_shaper))
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-2)
    assert np.abs(np.asarray(g_mixer["w"])).max() > 1e-2  # the mixer gradient is not vacuous


def test_wrapped_phase_is_the_bank_s_phase():
    """The fused path's phase (float64 sum, wrapped, cast) is the tensor
    bank_from_phase expands: the two banks are equal bit for bit."""
    f0 = torch.from_numpy((220.0 * 2.0 ** np.random.default_rng(3).uniform(0, 3, (2, 4000))).astype(np.float32))
    offsets = torch.rand(H, generator=torch.Generator().manual_seed(0))
    phase64 = phase_accumulate(f0, SR)
    phase = wrap_phase(phase64, f0.dtype)
    assert phase.dtype == torch.float32 and float(phase.min()) >= 0.0
    assert torch.equal(bank_from_wrapped_phase(phase, f0, H, SR, offsets),
                       bank_from_phase(phase64, f0, H, SR, offsets))


def test_hopper_gate_on_the_jax_cases():
    """supports_xcr on tests/test_newt_fused.py's cases: the same answers,
    except hop 10 and odd Tc, which were TPU compiler limits and which the
    Hopper gate takes (as supports_cr does)."""
    shaper = TrainableNonlinearity(64, 8, depth=4)
    jshaper = JNEWT().shaping_fn
    for ta, tc, h in ((96, 6, 101), (96, 6, 128), (96, 6, 129), (96, 6, 1)):
        assert nf.supports_xcr(shaper, ta, tc, h) == jnf.supports_xcr(jshaper, ta, tc, h)
    assert nf.supports_xcr(shaper, 96, 6, 2) and not nf.supports_xcr(shaper, 96, 6, 129)
    assert nf.supports_xcr(shaper, 60, 6, 101) and nf.supports_xcr(shaper, 80, 5, 101)
    assert not nf.supports_xcr(shaper, 130, 4, 101)  # no integer hop
    assert not nf.supports_xcr(TrainableNonlinearity(64, 8, depth=3), 96, 6, 101)


def _x_args(h=H, b=B, tc=TC, hop=HOP):
    rng = np.random.default_rng(1)
    ta = tc * hop

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return dict(phase=t(b, ta), f0=t(b, ta), offsets=t(h), film_c=t(b, tc, 256), w=t(h, 64),
                b=t(64), weights=t(170, 64), w_out=t(64), n_harmonics=h, hop=hop)


@pytest.mark.parametrize("case", [
    "dtype", "phase_shape", "f0_shape", "film_width", "batch", "hop", "harmonics_low",
    "harmonics_high", "offsets", "mixer_w", "mixer_b", "weights", "w_out", "contiguity", "device",
])
def test_launch_checks_refuse_what_the_kernels_do_not_take(case):
    """The checks run before any launch; here on CPU tensors, which is where
    they can be exercised without a card."""
    a = _x_args()
    if case == "dtype":
        a["f0"] = a["f0"].double()
    elif case == "phase_shape":
        a["phase"] = a["phase"][None]
    elif case == "f0_shape":
        a["f0"] = a["f0"][:, 1:]
    elif case == "film_width":
        a["film_c"] = a["film_c"][..., :128].contiguous()
    elif case == "batch":
        a["film_c"] = a["film_c"][:1].contiguous()
    elif case == "hop":
        a["hop"] = HOP + 1
    elif case == "harmonics_low":
        a = _x_args(h=1)
    elif case == "harmonics_high":
        a = _x_args(h=nf.H_MAX + 1)
    elif case == "offsets":
        a["offsets"] = a["offsets"][1:].contiguous()
    elif case == "mixer_w":
        a["w"] = a["w"][:, :32].contiguous()
    elif case == "mixer_b":
        a["b"] = a["b"][:32].contiguous()
    elif case == "weights":
        a["weights"] = a["weights"][1:].contiguous()
    elif case == "w_out":
        a["w_out"] = a["w_out"][:63].contiguous()
    elif case == "contiguity":
        a["w"] = torch.zeros(64, H).T
    elif case == "device":
        a["film_c"] = a["film_c"].to("meta")
    with pytest.raises((ValueError, TypeError)):
        nf._check_x(a["phase"], a["f0"], a["offsets"], a["film_c"], a["w"], a["b"], a["weights"],
                    a["w_out"], a["n_harmonics"], a["hop"])
    ok = _x_args()
    nf._check_x(ok["phase"], ok["f0"], ok["offsets"], ok["film_c"], ok["w"], ok["b"], ok["weights"],
                None, H, HOP)


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_wrappers_dispatch_cpu_tensors_to_plain(xcr, kind):
    params, mixer, f0, phase, offsets, film_c = xcr
    shaper = params_from_jax(params["shaping_fn"])
    args = (torch.from_numpy(phase), torch.from_numpy(f0), torch.from_numpy(offsets),
            torch.from_numpy(film_c), _t(mixer))
    w_out = torch.from_numpy(np.asarray(params["mixer"]["w"])[:, 0].copy())
    before = (nf.bank_film_shaper_xcr.launches, nf.bank_newt_xfull.launches)
    if kind == "xcr":
        out = nf.bank_film_shaper_xcr(*args, shaper, H, SR, HOP)
        ref = nf.bank_film_shaper_xcr_plain(*args, shaper, H, SR, HOP)
    else:
        out = nf.bank_newt_xfull(*args, w_out, shaper, H, SR, HOP)
        ref = nf.bank_newt_xfull_plain(*args, w_out, shaper, H, SR, HOP)
    assert (nf.bank_film_shaper_xcr.launches, nf.bank_newt_xfull.launches) == before
    assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# the model: NeuralWaveshaping.fuse_exciter / fuse_out_mixer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_model_params():
    return JNeuralWaveshaping().init(jax.random.PRNGKey(0))


def _model(jparams, **fields):
    model = NeuralWaveshaping(**fields)
    model.load_params(params_from_jax(jparams))
    return model


def _model_inputs(seed=4):
    """(B, Ta) audio-rate f0 up to ~1.7 kHz, a (B, Tc, 128) embedding, (H,) offsets."""
    rng = np.random.default_rng(seed)
    f0_up = (220.0 * 2.0 ** rng.uniform(0, 3, (B, TC * HOP))).astype(np.float32)
    emb = rng.standard_normal((B, TC, 128)).astype(np.float32)
    return f0_up, emb, rng.uniform(-np.pi, np.pi, H).astype(np.float32)


@pytest.mark.parametrize("fuse_out_mixer", [False, True])
def test_fused_model_matches_jax_and_its_unfused_path(jax_model_params, monkeypatch, fuse_out_mixer):
    """NeuralWaveshaping._fused_exciter_newt on the CPU against JAX's
    _fused_exciter_newt(..., force=True) (its kernel in interpret mode) on
    the same f0, embedding and offsets, JAX given the port's exact phase
    (its own float32 cumulative sum drifts, ROADMAP section 3), and against
    the port's bank -> mixer -> NEWT: rtol 1e-4, atol 1e-5."""
    f0_up, emb, offsets = _model_inputs()
    monkeypatch.setattr(j_oscillator, "phase_accumulate",
                        lambda f, sr: jnp.asarray(_exact_wrapped_phase(f, sr)))
    jmodel = JNeuralWaveshaping(fuse_exciter=True, fuse_out_mixer=fuse_out_mixer)
    ref = np.asarray(jmodel._fused_exciter_newt(
        jax_model_params, jnp.asarray(f0_up), jnp.asarray(emb), None, jnp.asarray(offsets), force=True))
    model = _model(jax_model_params, fuse_exciter=True, fuse_out_mixer=fuse_out_mixer)
    f0_t, emb_t, off_t = (torch.from_numpy(a) for a in (f0_up, emb, offsets))
    with torch.no_grad():
        out = model._fused_exciter_newt(f0_t, emb_t, off_t)
        unfused = model.newt(model.harmonic_mixer(model.osc(f0_t, phase_offset=off_t)), emb_t)
    assert out.shape == ref.shape == (B, TC * HOP, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), unfused.numpy(), rtol=1e-4, atol=1e-5)


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


def _forward(model, f0, control, offsets, noise, table=None):
    with torch.no_grad():
        return model(f0, control, phase_offset=offsets, noise=noise, lookup_table=table)


@pytest.mark.parametrize("fields,expect", [
    ({"fuse_exciter": True}, {"xcr": 1, "xfull": 0}),
    ({"fuse_exciter": True, "fuse_out_mixer": True}, {"xcr": 0, "xfull": 1}),
    ({"fuse_out_mixer": True}, {"xcr": 0, "xfull": 0}),
])
def test_forward_takes_the_fused_path_when_set(jax_model_params, monkeypatch, fields, expect):
    """forward runs one fused wrapper per call as the fields say
    (fuse_out_mixer alone does nothing, as in JAX), with the unfused
    forward's output: on the CPU both run the same plain arithmetic."""
    rng = np.random.default_rng(5)
    tc = 4
    f0 = torch.from_numpy(np.geomspace(200, 1800, tc)[None].repeat(B, 0).astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((B, tc, 2)).astype(np.float32))
    offsets = torch.from_numpy(rng.uniform(-np.pi, np.pi, H).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    ref = _forward(_model(jax_model_params), f0, control, offsets, noise)
    calls = _spy(monkeypatch)
    out = _forward(_model(jax_model_params, **fields), f0, control, offsets, noise)
    assert calls == expect
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["per_batch_offsets", "lookup_table", "fused_false", "fused_full_lane",
                                  "harmonics_129"])
def test_fallbacks_give_the_unfused_result_exactly(jax_model_params, monkeypatch, case):
    """Where the fused path does not apply the model runs the bank, the
    mixer and NEWT, bit for bit the model without the fields: (B, H)
    offsets (the streaming layout), a FastNEWT table, NEWT.fused not a
    control-rate spelling, and a harmonic count the gate refuses."""
    rng = np.random.default_rng(6)
    tc, h = 4, H
    if case == "harmonics_129":
        h = nf.H_MAX + 1
        gin.clear_config()
        gin.parse_config(f"HarmonicOscillator.n_harmonics = {h}")
    try:
        fused = NeuralWaveshaping(fuse_exciter=True, fuse_out_mixer=True,
                                  generator=torch.Generator().manual_seed(1))
        plain = NeuralWaveshaping(generator=torch.Generator().manual_seed(1))
    finally:
        gin.clear_config()
    if case != "harmonics_129":
        for m in (fused, plain):
            m.load_params(params_from_jax(jax_model_params))
    if case.startswith("fused_"):
        fused.newt.fused = plain.newt.fused = False if case == "fused_false" else "full_lane"
    f0 = torch.from_numpy(np.geomspace(200, 1800, tc)[None].repeat(B, 0).astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((B, tc, 2)).astype(np.float32))
    shape = (B, h) if case == "per_batch_offsets" else (h,)
    offsets = torch.from_numpy(rng.uniform(-np.pi, np.pi, shape).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    table = fused.newt.bake_lookup_table(256) if case == "lookup_table" else None
    calls = _spy(monkeypatch)
    out = _forward(fused, f0, control, offsets, noise, table)
    assert calls == {"xcr": 0, "xfull": 0}
    assert torch.equal(out, _forward(plain, f0, control, offsets, noise, table))


def test_the_fields_bind_from_gin():
    """Both fields (and compute_dtype) are parameters of the configurable,
    so gin reaches them, also in the model Synthesizer.from_checkpoint
    builds; no binding, both off. compute_dtype = 'bfloat16' binds through
    gin into Synthesizer.from_checkpoint's model; a name other than
    'float32' and 'bfloat16' raises ValueError."""
    assert (NeuralWaveshaping().fuse_exciter, NeuralWaveshaping().fuse_out_mixer) == (False, False)
    gin.clear_config()
    try:
        gin.parse_config("NeuralWaveshaping.fuse_exciter = True\nNeuralWaveshaping.fuse_out_mixer = True\n"
                         "NeuralWaveshaping.compute_dtype = 'float32'")
        assert gin.validate_config() == []
        model = Synthesizer.from_checkpoint(CKPT, device="cpu").model
        assert (model.fuse_exciter, model.fuse_out_mixer) == (True, True)
        gin.clear_config()
        gin.parse_config("NeuralWaveshaping.compute_dtype = 'bfloat16'")
        model = Synthesizer.from_checkpoint(CKPT, device="cpu").model
        assert model.compute_dtype == "bfloat16" and not model.fuse_exciter
    finally:
        gin.clear_config()
    with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
        NeuralWaveshaping(compute_dtype="float16")


@pytest.mark.parametrize("fields", [{"fuse_exciter": True},
                                    {"fuse_exciter": True, "fuse_out_mixer": True}])
def test_train_step_with_the_fields_matches_the_unfused_step(jax_model_params, fields):
    """One train_step (loss, backward, clip, Adam) from the same weights,
    batch, offsets and noise, with the fields set and without: the same
    loss (1e-6 relative), every gradient leaf nonzero and within 1e-5
    normalised, the same updated parameters (rtol 1e-5)."""
    rng = np.random.default_rng(7)
    tc = 20  # the loss's largest STFT frame, 2048, needs more than 2048 samples
    f0 = np.geomspace(220.0, 1700.0, tc).astype(np.float32)
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, 128)) / 16000
    batch = {"f0": torch.from_numpy(f0[None]),
             "control": torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32)),
             "audio": torch.from_numpy((0.1 * np.sin(phase) + 0.05 * np.sin(3 * phase))[None].astype(np.float32))}
    offsets = torch.from_numpy(rng.uniform(-np.pi, np.pi, H).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    runs = []
    for kw in ({}, fields):
        model = _model(jax_model_params, **kw)
        opt = Optimizer(model.parameters(), TrainConfig())
        metrics = train_step(model, opt, batch, phase_offset=offsets, noise=noise)
        runs.append((float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    (loss0, grads0, params0), (loss1, grads1, params1) = runs
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for name, g in grads1.items():
        assert torch.count_nonzero(g) > 0, name
        assert torch.linalg.norm(g - grads0[name]) <= 1e-5 * torch.linalg.norm(grads0[name]), name
        np.testing.assert_allclose(params1[name].numpy(), params0[name].numpy(), rtol=1e-5, atol=1e-7)
