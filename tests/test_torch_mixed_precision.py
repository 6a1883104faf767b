"""Mixed precision in the port: the model's ``compute_dtype = "bfloat16"``.

On the CPU, against the JAX package: the dense layer's contract, LayerNorm
and the polynomial sine in bfloat16, the shaper bank, the plain versions of
kernels 1 and 2 under bfloat16 I/O against the JAX kernel
``film_shaper_fused_cr`` and its VJP in interpret mode, those of kernels 5
and 6 (the audio-rate pair) against ``film_shaper_fused_fl`` /
``film_shaper_fused`` and the full-lane VJP, NEWT's audio-rate dispatch under
bf16, ``NEWT.cr_film_f32``, the whole model against its float32 render and
the JAX bfloat16 apply, one training step against JAX's, the bf16
checkpoint's render, and the paths whose bf16 I/O is not ported. The card's
cases (the bf16 kernel instances against their plain versions) are in
tests/test_torch_cuda.py.
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
from neural_waveshaping_synthesis_tpu.models.modules import (
    TrainableNonlinearity as JTrainableNonlinearity,
    dense_apply as j_dense_apply,
    layer_norm_apply as j_layer_norm_apply,
)
from neural_waveshaping_synthesis_tpu.ops.fastmath import fast_sin as j_fast_sin
from neural_waveshaping_synthesis_tpu.ops.upsample import linear_upsample as j_linear_upsample
from neural_waveshaping_synthesis_tpu.training.loss import (
    multi_resolution_stft_loss as j_multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.models.modules import (
    cast_params,
    dense_apply,
    layer_norm_apply,
    shaper_apply,
)
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample
from neural_waveshaping_synthesis_tpu_torch.ops.fastmath import fast_sin
from neural_waveshaping_synthesis_tpu_torch.streaming import StreamingSynth
from neural_waveshaping_synthesis_tpu_torch.training import Optimizer, TrainConfig, train_step

REPO = Path(__file__).resolve().parents[1]
CKPT = str(REPO / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt")
CKPT_BF16 = str(REPO / "docs" / "results" / "run120k_bf16" / "checkpoint" / "best.ckpt")
BF16 = torch.bfloat16
ULP = 2.0**-7  # one bfloat16 ulp, relative: 8 significant bits
KERNEL_BAR = 0.08  # JAX's bf16 kernel-vs-chain bar (tests/test_newt_fused.py)
B, TC, HOP = 2, 6, 16  # JAX setup_cr's shape


def _nrms(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _bf16(x: np.ndarray):
    """-> (the torch bfloat16 tensor, the same values as a JAX bfloat16 array)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def jax_ckpt():
    return load_reference_checkpoint(CKPT)[0]


@pytest.fixture(scope="module")
def jax_newt():
    newt = JNEWT()
    return newt, newt.init(jax.random.PRNGKey(2))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------
def test_dense_apply_in_bf16_rounds_once_as_jax():
    """bf16 x and w with a float32 bias (the harmonic mixer's) -> a bf16
    result, summed in float32 and rounded once: within one bf16 ulp of JAX
    ``dense_apply`` (rtol 2^-7; atol 1e-6 for sums that cancel, where the
    two float32 sums' order shows; 1 element of 9,600 differs when written).
    torch's own bf16 matmul and the float32 bias would return float32."""
    rng = np.random.default_rng(0)
    x, jx = _bf16(rng.standard_normal((3, 50, 101)))
    w, jw = _bf16(rng.standard_normal((101, 64)) / 10)
    b = rng.standard_normal(64).astype(np.float32)
    out = dense_apply({"w": w, "b": torch.from_numpy(b)}, x)
    ref = j_dense_apply({"w": jw, "b": jnp.asarray(b)}, jx)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=ULP, atol=1e-6)
    assert (torch.matmul(x, w) + torch.from_numpy(b)).dtype == torch.float32


def test_dense_apply_in_float32_is_the_plain_product():
    """The float32 path is ``x @ w + b``, bit for bit (the parent's code)."""
    rng = np.random.default_rng(1)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((4, 7, 128), (128, 256), (256,)))
    assert torch.equal(dense_apply({"w": w, "b": b}, x), torch.matmul(x, w) + b)


def test_layer_norm_takes_bf16_scale_and_bias_as_jax():
    """LayerNorm of a bf16 x with the bf16 scale and bias of JAX's cast
    NEWT tree: statistics in float32, bf16 out, within one bf16 ulp of JAX
    (atol 1e-6 near zero)."""
    rng = np.random.default_rng(2)
    x, jx = _bf16(rng.standard_normal((2, 9, 128)) * 3 + 1)
    scale, jscale = _bf16(1 + rng.standard_normal(128) / 5)
    bias, jbias = _bf16(rng.standard_normal(128) / 5)
    out = layer_norm_apply({"scale": scale, "bias": bias}, x)
    ref = j_layer_norm_apply({"scale": jscale, "bias": jbias}, jx)
    assert out.dtype == BF16
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=ULP, atol=1e-6)


def test_fast_sin_keeps_bf16_in_and_out():
    """fast_sin of a bf16 x evaluates its polynomial in bf16, as JAX's: bf16
    out, bit for bit JAX's (measured when written: 0 elements differ), and
    its custom backward returns a bf16 cotangent. Both are within 2^-5 of
    the exact sine and cosine of the bf16 x over shaper-sized arguments
    (0.017 and 0.020 when written: the bf16 range reduction rounds at x's
    own ulp, 2^-4 for |x| >= 8)."""
    rng = np.random.default_rng(3)
    x, jx = _bf16(rng.standard_normal(4096) * 3)
    x.requires_grad_()
    y = fast_sin(x)
    assert y.dtype == BF16
    np.testing.assert_array_equal(_f32(y), _f32(j_fast_sin(jx)))
    np.testing.assert_allclose(_f32(y), np.sin(_f32(x)), rtol=0, atol=2.0**-5)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.dtype == BF16
    np.testing.assert_allclose(_f32(g), np.cos(_f32(x)), rtol=0, atol=2.0**-5)


def test_shaper_bank_in_bf16_matches_jax(jax_newt):
    """The einsum chain of the shaper bank in bf16, on the bf16-cast JAX
    tree: bf16 out, bit for bit the JAX chain's (each einsum sums in float32
    and rounds once in both frameworks, and fast_sin matches bit for bit)."""
    _, p = jax_newt
    rng = np.random.default_rng(4)
    x, jx = _bf16(rng.standard_normal((2, 40, 64)) * 0.5)
    jsp = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p["shaping_fn"])
    sp = cast_params(params_from_jax(p["shaping_fn"]), BF16)
    out = shaper_apply(sp, x)
    ref = JTrainableNonlinearity(64, 8, depth=4).apply(jsp, jx)
    assert out.dtype == BF16
    np.testing.assert_array_equal(_f32(out), _f32(ref))


# ---------------------------------------------------------------------------
# kernels 1 and 2: their plain versions under bf16 I/O
# ---------------------------------------------------------------------------
def _cr_inputs(film_dtype, seed=7):
    rng = np.random.default_rng(seed)
    exc = rng.standard_normal((B, TC * HOP, 64)) * 0.5
    film_c = rng.standard_normal((B, TC, 256))
    dy = rng.standard_normal((B, TC * HOP, 64))
    exc, jexc = _bf16(exc)
    dy, jdy = _bf16(dy)
    if film_dtype == "bfloat16":
        film, jfilm = _bf16(film_c)
    else:
        film = torch.from_numpy(film_c.astype(np.float32))
        jfilm = jnp.asarray(film_c.astype(np.float32))
    return exc, jexc, film, jfilm, dy, jdy


@pytest.mark.parametrize("film_dtype", ["bfloat16", "float32"])
def test_cr_plain_forward_in_bf16_matches_jax_kernel(jax_newt, film_dtype):
    """Kernel 1's plain version with (bf16, bf16) and (bf16 exciter,
    float32 FiLM) I/O against the JAX kernel in interpret mode on the same
    bf16 inputs and bf16-cast weights: bf16 out, rtol 0.08, atol 0.08 (JAX's
    bar: the JAX kernel rounds its FiLM planes and each layer to bf16, the
    port computes in float32 between load and store). Measured when
    written: max |diff| 0.047 (bf16 FiLM) and 0.066 (float32 FiLM)."""
    _, p = jax_newt
    exc, jexc, film, jfilm, _, _ = _cr_inputs(film_dtype)
    jsp = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p["shaping_fn"])
    ref = jnf.film_shaper_fused_cr(jexc, jfilm, jnf.pack_weights_fl(jsp), HOP, True)
    out = nf.film_shaper_cr_plain(exc, film, cast_params(params_from_jax(p["shaping_fn"]), BF16), HOP)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=KERNEL_BAR, atol=KERNEL_BAR)


def test_cr_plain_in_bf16_is_the_float32_chain_rounded_once(jax_newt):
    """What the kernel's bf16 instances compute: the float32 plain version on
    the widened inputs and weights, rounded once to bf16, bit for bit."""
    _, p = jax_newt
    exc, _, film, _, _, _ = _cr_inputs("bfloat16")
    sp = cast_params(params_from_jax(p["shaping_fn"]), BF16)
    out = nf.film_shaper_cr_plain(exc, film, sp, HOP)
    ref = nf.film_shaper_cr_plain(exc.float(), film.float(), cast_params(sp, torch.float32), HOP)
    assert torch.equal(out, ref.to(BF16))


def _weight_grads(d_planes):
    return [_f32(g) for g in _leaves(nf.unpack_weight_grads(d_planes))]


def test_cr_plain_backward_in_bf16_matches_jax_vjp(jax_newt):
    """Kernel 2's plain version with (bf16, bf16) I/O against the JAX
    kernel's VJP in interpret mode, on the same bf16 inputs, cotangent and
    bf16-cast weights, at B=1, Tc=2, hop 16 (both clamps; the JAX VJP takes
    ~80 s in interpret mode even there): d_exciter and d_film bf16, every
    leaf finite; d_exciter, d_film and each shaper weight gradient within
    relative norm 0.08 of JAX's (the JAX suite's bf16 gradient bar,
    tests/test_newt_fused.py:180-188; elementwise the two reach 0.5 on
    values up to 10, where JAX rounds each layer to bf16 and the port does
    not), and the weight gradients within 0.08 of the float32 chain's.
    Measured when written: at most 0.052 against JAX, 0.034 against the
    float32 chain."""
    _, p = jax_newt
    rng = np.random.default_rng(7)
    exc, jexc = _bf16(rng.standard_normal((1, 2 * HOP, 64)) * 0.5)
    film, jfilm = _bf16(rng.standard_normal((1, 2, 256)))
    dy, jdy = _bf16(rng.standard_normal((1, 2 * HOP, 64)))
    jsp = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p["shaping_fn"])
    sp32 = params_from_jax(p["shaping_fn"])
    d_exc, d_film, d_planes = nf.film_shaper_cr_grad_plain(exc, film, cast_params(sp32, BF16), HOP, dy)
    assert (d_exc.dtype, d_film.dtype, d_planes.dtype) == (BF16, BF16, torch.float32)
    assert all(torch.isfinite(g.float()).all() for g in (d_exc, d_film, d_planes))

    def f(e, fc, sp):
        return jnf.film_shaper_fused_cr(e, fc, jnf.pack_weights_fl(sp), HOP, True)

    _, vjp = jax.vjp(f, jexc, jfilm, jsp)
    jd_exc, jd_film, jd_sp = vjp(jdy)
    assert _rel(_f32(d_exc), _f32(jd_exc)) < KERNEL_BAR
    assert _rel(_f32(d_film), _f32(jd_film)) < KERNEL_BAR
    _, _, chain32 = nf.film_shaper_cr_grad_plain(exc.float(), film.float(), sp32, HOP, dy.float())
    for a, j, c in zip(_weight_grads(d_planes), _leaves(jd_sp), _weight_grads(chain32)):
        assert _rel(a, _f32(j)) < KERNEL_BAR and _rel(a, c) < KERNEL_BAR


def test_cr_plain_backward_with_a_float32_film(jax_newt):
    """Kernel 2's plain version with (bf16 exciter, float32 FiLM) I/O, the
    cr_film_f32 call: d_film float32 and d_exciter bf16 (JAX's dtypes,
    tests/test_newt_fused.py:489), every leaf finite, and d_exciter, d_film
    and each shaper weight gradient within relative norm 0.08 of the float32
    chain's on the widened inputs."""
    _, p = jax_newt
    exc, _, film, _, dy, _ = _cr_inputs("float32")
    sp32 = params_from_jax(p["shaping_fn"])
    got = nf.film_shaper_cr_grad_plain(exc, film, cast_params(sp32, BF16), HOP, dy)
    assert [g.dtype for g in got] == [BF16, torch.float32, torch.float32]
    assert all(torch.isfinite(g.float()).all() for g in got)
    ref = nf.film_shaper_cr_grad_plain(exc.float(), film, sp32, HOP, dy.float())
    assert _rel(_f32(got[0]), _f32(ref[0])) < KERNEL_BAR
    assert _rel(_f32(got[1]), _f32(ref[1])) < KERNEL_BAR
    for a, c in zip(_weight_grads(got[2]), _weight_grads(ref[2])):
        assert _rel(a, c) < KERNEL_BAR


def test_cr_wrapper_on_the_cpu_takes_the_bf16_pairs_and_refuses_others(jax_newt):
    """film_shaper_cr on CPU tensors runs the plain version for the kernel's
    dtype pairs; the kernels' check refuses a bf16 FiLM with a float32
    exciter and a float16 exciter (TypeError)."""
    _, p = jax_newt
    exc, _, film, _, _, _ = _cr_inputs("bfloat16")
    sp = cast_params(params_from_jax(p["shaping_fn"]), BF16)
    out = nf.film_shaper_cr(exc, film, sp, HOP)
    assert out.dtype == BF16 and torch.equal(out, nf.film_shaper_cr_plain(exc, film, sp, HOP))
    w = nf.pack_weights(sp)
    assert w.dtype == torch.float32
    assert nf._check(exc, film, w, HOP) == "_bf16"
    assert nf._check(exc, film.float(), w, HOP) == "_bf16_f32"
    assert nf._check(exc.float(), film.float(), w, HOP) == ""
    with pytest.raises(TypeError, match="needs a bfloat16 exciter"):
        nf._check(exc.float(), film, w, HOP)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        nf._check(exc.half(), film, w, HOP)
    with pytest.raises(TypeError, match="shaper_weights must be float32"):
        nf._check(exc, film, w.to(BF16), HOP)


# ---------------------------------------------------------------------------
# kernels 5 and 6 (the audio-rate pair): their plain versions under bf16 I/O
# ---------------------------------------------------------------------------
FL_BAR = 0.06  # JAX's bf16 bar for its full-lane kernel (tests/test_newt_fused.py:146)
FL_B, FL_TA = 2, 128  # one 128-row tile of row pairs for the full-lane JAX kernel
# the two TPU lane layouts of one function: (JAX kernel, its weight packing)
FL_LAYOUTS = {
    "full_lane": (jnf.film_shaper_fused_fl, jnf.pack_weights_fl),
    "half_lane": (jnf.film_shaper_fused, jnf.pack_weights),
}


def _fl_inputs(seed=21):
    """bf16 exciter, audio-rate FiLM and cotangent, as (torch, JAX) pairs."""
    rng = np.random.default_rng(seed)
    exc = _bf16(rng.standard_normal((FL_B, FL_TA, 64)) * 0.5)
    film = _bf16(rng.standard_normal((FL_B, FL_TA, 256)))
    dy = _bf16(rng.standard_normal((FL_B, FL_TA, 64)))
    return exc, film, dy


def test_fl_plain_in_bf16_is_the_float32_chain_rounded_once(jax_newt):
    """What kernel 5's bf16 instance computes: the float32 plain version on
    the widened exciter, FiLM and shaper weights, rounded once to bf16, bit
    for bit; the output bf16. Under float32 the plain version is the chain
    itself (the parent's code), bit for bit."""
    _, p = jax_newt
    (exc, _), (film, _), _ = _fl_inputs()
    sp = cast_params(params_from_jax(p["shaping_fn"]), BF16)
    out = nf.film_shaper_fl_plain(exc, film, sp)
    sp32 = cast_params(sp, torch.float32)
    ref = nf.film_shaper_fl_plain(exc.float(), film.float(), sp32)
    assert out.dtype == BF16 and torch.equal(out, ref.to(BF16))
    assert torch.equal(ref, nf.film_shaper_chain(exc.float(), film.float(), sp32))


@pytest.mark.parametrize("layout", sorted(FL_LAYOUTS))
def test_fl_plain_forward_in_bf16_matches_jax_kernel(jax_newt, layout):
    """Kernel 5's plain version with (bf16, bf16) I/O against each JAX
    layout's kernel in interpret mode (tile 128) on the same bf16 inputs and
    bf16-cast weights: bf16 out, rtol 0.06, atol 0.06, JAX's own bar for its
    bf16 full-lane kernel (the JAX kernel rounds its FiLM planes and each
    layer to bf16, the port computes in float32 between load and store).
    Measured when written: max |diff| 0.066 in both layouts, on an element
    whose rtol share keeps it under the bar."""
    _, p = jax_newt
    kernel, pack = FL_LAYOUTS[layout]
    (exc, jexc), (film, jfilm), _ = _fl_inputs()
    jsp = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p["shaping_fn"])
    ref = kernel(jexc, jfilm, pack(jsp), 128, True)
    out = nf.film_shaper_fl_plain(exc, film, cast_params(params_from_jax(p["shaping_fn"]), BF16))
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=FL_BAR, atol=FL_BAR)


def test_fl_plain_backward_in_bf16_matches_jax_vjp(jax_newt):
    """Kernel 6's plain version with (bf16, bf16) I/O, by autograd through
    the plain forward, against the VJP of JAX's full-lane kernel in
    interpret mode on the same bf16 inputs, cotangent and bf16-cast weights:
    d_exciter and d_film bf16, d_planes float32, every leaf finite;
    d_exciter and d_film within relative norm 0.08 of JAX's, and each shaper
    weight gradient within 0.08 of the float32 chain's on the widened inputs
    (JAX's bar, tests/test_newt_fused.py:146) and of JAX's. Measured when
    written: d_exciter 0.043, d_film 0.025 from JAX; the weight gradients
    at most 0.058 from the float32 chain and 0.052 from JAX."""
    _, p = jax_newt
    (exc, jexc), (film, jfilm), (dy, jdy) = _fl_inputs()
    jsp = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p["shaping_fn"])
    sp32 = params_from_jax(p["shaping_fn"])
    d_exc, d_film, d_planes = nf.film_shaper_fl_grad_plain(exc, film, cast_params(sp32, BF16), dy)
    assert (d_exc.dtype, d_film.dtype, d_planes.dtype) == (BF16, BF16, torch.float32)
    assert all(torch.isfinite(g.float()).all() for g in (d_exc, d_film, d_planes))

    def f(e, fa, sp):
        return jnf.film_shaper_fused_fl(e, fa, jnf.pack_weights_fl(sp), 128, True)

    _, vjp = jax.vjp(f, jexc, jfilm, jsp)
    jd_exc, jd_film, jd_sp = vjp(jdy)
    assert _rel(_f32(d_exc), _f32(jd_exc)) < KERNEL_BAR
    assert _rel(_f32(d_film), _f32(jd_film)) < KERNEL_BAR
    _, _, chain32 = nf.film_shaper_fl_grad_plain(exc.float(), film.float(), sp32, dy.float())
    for a, j, c in zip(_weight_grads(d_planes), _leaves(jd_sp), _weight_grads(chain32)):
        assert _rel(a, c) < KERNEL_BAR and _rel(a, _f32(j)) < KERNEL_BAR


def test_fl_check_takes_the_two_instances_and_refuses_mixed_pairs():
    """_check_fl (the audio-rate kernels' check, here on CPU tensors) takes
    (float32, float32) and (bf16, bf16) and names the instance; a mixed
    pair, a float16 exciter and bf16 planes raise TypeError. The backward's
    4-byte staging copies get a word-aligned view: a bf16 view at an odd
    offset is copied, an aligned one passed through."""
    exc = torch.zeros(1, 7, 64, dtype=BF16)
    film = torch.zeros(1, 7, 256, dtype=BF16)
    w = torch.zeros(170, 64)
    assert nf._check_fl(exc, film, w) == "_bf16"
    assert nf._check_fl(exc.float(), film.float(), w) == ""
    with pytest.raises(TypeError, match="film of the exciter's dtype"):
        nf._check_fl(exc, film.float(), w)
    with pytest.raises(TypeError, match="film of the exciter's dtype"):
        nf._check_fl(exc.float(), film, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        nf._check_fl(exc.half(), film, w)
    with pytest.raises(TypeError, match="shaper_weights must be float32"):
        nf._check_fl(exc, film, w.to(BF16))
    flat = torch.arange(1 + 7 * 64, dtype=BF16)
    odd = flat[1:].view(1, 7, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 4 == 2
    fixed = nf._word_aligned(odd)
    assert fixed.data_ptr() % 4 == 0 and torch.equal(fixed, odd)
    assert nf._word_aligned(exc) is exc


def _count_fl_plain(monkeypatch):
    calls = []
    plain = nf.film_shaper_fl_plain

    def counted(*args):
        calls.append(args[0].dtype)
        return plain(*args)

    monkeypatch.setattr(nf, "film_shaper_fl_plain", counted)
    return calls


@pytest.mark.parametrize("fused,ta,tc", [(True, 128, 4), ("full_lane", 128, 4), ("fl", 128, 4),
                                         ("full_lane_cr", 130, 4)])
def test_newt_audio_rate_in_bf16_on_the_cpu_runs_the_plain_version(jax_newt, monkeypatch, fused,
                                                                    ta, tc):
    """NEWT under bf16 on the CPU with True / "full_lane" / "fl", and with
    "full_lane_cr" at Ta=130, Tc=4 (a non-integer hop: JAX's fallback to the
    audio-rate kernel), runs kernel 5's plain version once (float32 between
    bf16 load and store, as the card's bf16 instance), not the per-op bf16
    chain: its output is the mixer of that plain version bit for bit and
    differs from the chain's; float32 runs the chain. Against JAX's NEWT
    with the same ``fused`` on its bf16-cast tree (its Pallas kernel in
    interpret mode): within JAX's bar, 0.06. At Ta=130 the port rounds the
    float32 FiLM lerp to bf16 for the kernel (ROADMAP.md section 3), where
    JAX's NEWT raises; there the reference is JAX's kernel and mixer on the
    bf16 FiLM. Measured when written: max |diff| 0.0039 in every case."""
    newt_j, p = jax_newt
    rng = np.random.default_rng(22)
    exc = torch.from_numpy((rng.standard_normal((1, ta, 64)) * 0.5).astype(np.float32)).to(BF16)
    emb = torch.from_numpy(rng.standard_normal((1, tc, 128)).astype(np.float32))
    newt = NEWT(fused=fused)
    newt.load_params(params_from_jax(p))
    calls = _count_fl_plain(monkeypatch)
    with torch.no_grad():
        out = newt(exc, emb)
        assert calls == [BF16]
        chain = newt(exc, emb, fused=False)
        newt(exc.float(), emb)
    assert calls == [BF16] and out.dtype == BF16
    with torch.no_grad():
        film_a = linear_upsample(newt.film_params(emb.to(BF16)), ta).to(BF16)
        plain = nf.film_shaper_fl_plain(exc, film_a, newt._shaper_params(BF16))
        assert torch.equal(out, newt.mixer(plain))
    assert not torch.equal(out, chain)
    jp16 = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p)
    jexc = jnp.asarray(_f32(exc)).astype(jnp.bfloat16)
    jemb = jnp.asarray(emb.numpy()).astype(jnp.bfloat16)
    if ta % tc == 0:
        ref = newt_j.apply(jp16, jexc, jemb, fused=fused)
    else:
        # JAX's own fallback raises here: its lerp promotes the FiLM to
        # float32, and its kernel cannot store the float32 result in the bf16
        # output. The port hands the kernel the FiLM in the exciter's dtype;
        # the reference is JAX's kernel on those inputs.
        with pytest.raises(ValueError, match="dtype"):
            newt_j.apply(jp16, jexc, jemb, fused=fused)
        jfilm = j_linear_upsample(newt_j.film_params(jp16, jemb), ta).astype(jnp.bfloat16)
        shaped = jnf.film_shaper_fused_fl(jexc, jfilm, jnf.pack_weights_fl(jp16["shaping_fn"]),
                                          128, True)
        ref = j_dense_apply(jp16["mixer"], shaped)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=FL_BAR, atol=FL_BAR)


def test_bf16_chain_at_a_non_integer_hop_promotes_as_jax(jax_newt):
    """NEWT(fused=False) under bf16 at Ta=130, Tc=4: the FiLM lerp at a
    non-integer hop is float32 (bf16 frames times float32 weights, in both
    frameworks), so the chain runs in float32 from the first FiLM on, its
    shaper einsums promoting the bf16 weights as ``jnp.einsum`` does, and
    returns float32, as JAX's NEWT does. Within atol 1e-2 of JAX's (the bf16
    FiLM MLPs differ by a bf16 ulp here and there; 0.0028 when written)."""
    newt_j, p = jax_newt
    rng = np.random.default_rng(23)
    exc = torch.from_numpy((rng.standard_normal((2, 130, 64)) * 0.5).astype(np.float32)).to(BF16)
    emb = torch.from_numpy(rng.standard_normal((2, 4, 128)).astype(np.float32))
    newt = NEWT(fused=False)
    newt.load_params(params_from_jax(p))
    with torch.no_grad():
        out = newt(exc, emb)
    jp16 = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p)
    ref = newt_j.apply(jp16, jnp.asarray(_f32(exc)).astype(jnp.bfloat16),
                       jnp.asarray(emb.numpy()).astype(jnp.bfloat16), fused=False)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# NEWT and the model
# ---------------------------------------------------------------------------
def test_newt_cr_film_f32_is_bit_exact_under_float32(jax_newt):
    """NEWT(cr_film_f32=True) under float32 equals the default bit for bit
    (JAX test_newt_apply_cr_film_f32_field); under bf16 it hands the
    kernel's plain version a float32 FiLM, within JAX's bar of JAX's NEWT
    with the field on its bf16-cast tree."""
    _, p = jax_newt
    rng = np.random.default_rng(6)
    exc = rng.standard_normal((2, 5 * 16, 64)).astype(np.float32) * 0.5
    emb = rng.standard_normal((2, 5, 128)).astype(np.float32)
    base, field = NEWT(), NEWT(cr_film_f32=True)
    for m in (base, field):
        m.load_params(params_from_jax(p))
    with torch.no_grad():
        ref = base(torch.from_numpy(exc), torch.from_numpy(emb))
        out = field(torch.from_numpy(exc), torch.from_numpy(emb))
        out16 = field(torch.from_numpy(exc).to(BF16), torch.from_numpy(emb))
    assert torch.equal(out, ref)
    jp16 = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), p)
    jref16 = JNEWT(cr_film_f32=True).apply(
        jp16, jnp.asarray(exc).astype(jnp.bfloat16), jnp.asarray(emb).astype(jnp.bfloat16),
        fused="cr")
    assert out16.dtype == BF16
    np.testing.assert_allclose(_f32(out16), _f32(jref16), rtol=KERNEL_BAR, atol=KERNEL_BAR)


def test_newt_cr_film_f32_binds_from_gin():
    gin.clear_config()
    try:
        gin.parse_config("NEWT.cr_film_f32 = True")
        assert gin.validate_config() == []
        assert NEWT().cr_film_f32 and NeuralWaveshaping().newt.cr_film_f32
    finally:
        gin.clear_config()
    assert not NEWT().cr_film_f32


def test_newt_packs_bf16_rounded_planes_and_keys_its_cache_by_dtype(jax_newt):
    """Under bf16 the kernel's planes are float32 copies of the bf16-rounded
    shaper leaves, as JAX packs its cast tree; without grad the cache keeps
    one pack per dtype."""
    _, p = jax_newt
    newt = NEWT()
    newt.load_params(params_from_jax(p))
    with torch.no_grad():
        p32 = newt._packed_shaper()
        p16 = newt._packed_shaper(BF16)
        assert p16.dtype == torch.float32
        assert torch.equal(p16, nf.pack_weights(params_from_jax(p["shaping_fn"])).to(BF16).float())
        assert not torch.equal(p16, p32)
        assert newt._packed_shaper(BF16) is p16
        assert torch.equal(newt._packed_shaper(), p32)
    planes = newt._packed_shaper(BF16)
    planes.sum().backward()
    assert newt.shaping_fn.input_scale.grad.dtype == torch.float32


def _model_inputs(tc, seed):
    rng = np.random.default_rng(seed)
    base = 220.0 * 2.0 ** rng.uniform(0, 2, (2, 1))
    f0 = (base * np.linspace(1.0, 1.3, tc) + rng.standard_normal((2, tc))).astype(np.float32)
    control = rng.standard_normal((2, tc, 2)).astype(np.float32)
    offset = rng.uniform(-np.pi, np.pi, 101).astype(np.float32)
    noise = rng.uniform(0, 1, tc * 128 - 1).astype(np.float32)
    return f0, control, offset, noise


def _render(model, f0, control, offset, noise):
    with torch.inference_mode():
        return model(torch.from_numpy(f0), torch.from_numpy(control),
                     phase_offset=torch.from_numpy(offset), noise=torch.from_numpy(noise)).numpy()


# measured when written (Tc=16, run120k_cr weights), nRMS: port bf16 vs the
# JAX bf16 apply 0.0019 (chain) and 0.0046 (cr); the port's float32 render vs
# the JAX bf16 apply 0.0059 (as JAX float32 vs JAX bf16: the port's float32
# is 2.9e-5 from JAX's); port bf16 vs port float32 0.0061 (chain), 0.0052 (cr).
# The chain's bar sits between its 0.0019 and the float32 model's 0.0059, so a
# model that ignored compute_dtype fails it. "cr" runs kernel 1's plain
# version, float32 between bf16 load and store by design, so it sits near the
# float32 gap (0.0046 against 0.0059) and keeps JAX's looser 0.02; the floor on
# its distance from the float32 render (below both 0.005s, above 0) is what
# tells it from a float32 run.
JAX_BF16_BAR = {False: 0.003, "cr": 0.02, "full_lane": 0.02}
BF16_FLOOR = 1e-3


@pytest.mark.parametrize("fused", [False, "cr", "full_lane"])
def test_bf16_model_tracks_float32_and_the_jax_bf16_apply(jax_ckpt, fused):
    """NeuralWaveshaping(compute_dtype="bfloat16") on the shipped
    architecture (run120k_cr weights), with injected phase offsets and
    noise, returns float32; it is within nRMS 0.05 of the port's float32
    render (JAX's bar, tests/test_model_golden.py) but at least 1e-3 from it
    (it computes in bf16), and within JAX_BF16_BAR of the JAX bf16 apply
    (its chain on the CPU) at Tc=16, where the float32 phase's drift stays
    out. ``"cr"`` runs kernel 1's plain version and ``"full_lane"`` kernel
    5's, each computing in float32 between bf16 load and store;
    ``"full_lane"`` keeps ``"cr"``'s bar (measured when written: 0.0043
    from JAX's bf16 apply, 0.0055 from the port's float32 render)."""
    f0, control, offset, noise = _model_inputs(16, 16)
    ref16 = np.asarray(jax.jit(
        lambda p, f, c, o, n: JNeuralWaveshaping(compute_dtype="bfloat16").apply(
            p, f, c, phase_offset=o, noise=n)
    )(jax_ckpt, f0, control, offset, noise))
    m32, m16 = NeuralWaveshaping(), NeuralWaveshaping(compute_dtype="bfloat16")
    for m in (m32, m16):
        m.load_params(params_from_jax(jax_ckpt))
        m.newt.fused = fused
    out32 = _render(m32, f0, control, offset, noise)
    out16 = _render(m16, f0, control, offset, noise)
    assert out16.dtype == np.float32 and out16.shape == (2, 16 * 128)
    assert np.all(np.isfinite(out16))
    assert BF16_FLOOR < _nrms(out16, out32) < 0.05, _nrms(out16, out32)
    assert _nrms(out16, ref16) < JAX_BF16_BAR[fused], _nrms(out16, ref16)


def test_bf16_scope_is_the_jax_scope(jax_ckpt):
    """bf16 exactly where JAX's apply casts: the exciter, NEWT's inputs,
    its FiLM and output (hooks); float32 for the embedding, the noise MLP,
    the parameters. The parameters stay float32 tensors."""
    f0, control, offset, noise = _model_inputs(8, 3)
    model = NeuralWaveshaping(compute_dtype="bfloat16")
    model.load_params(params_from_jax(jax_ckpt))
    seen = {}
    hooks = [
        model.newt.register_forward_pre_hook(
            lambda m, a: seen.update(exciter=a[0].dtype, embedding=a[1].dtype)),
        model.newt.register_forward_hook(lambda m, a, out: seen.update(newt_out=out.dtype)),
        model.newt.mlp.register_forward_hook(lambda m, a, out: seen.update(film=out.dtype)),
        model.h_generator.register_forward_hook(lambda m, a, out: seen.update(noise_mlp=out.dtype)),
    ]
    try:
        _render(model, f0, control, offset, noise)
    finally:
        for h in hooks:
            h.remove()
    assert seen == {"exciter": BF16, "embedding": torch.float32, "film": BF16,
                    "newt_out": BF16, "noise_mlp": torch.float32}
    assert {t.dtype for t in model.parameters()} == {torch.float32}


def test_compute_dtype_takes_two_names():
    assert NeuralWaveshaping(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    for name in ("float16", "bf16", "float64"):
        with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
            NeuralWaveshaping(compute_dtype=name)


def test_bf16_training_step_matches_jax(jax_ckpt):
    """One train_step (loss, backward, clip, Adam) of the bf16 model with
    the recipe's chain (NEWT.fused = None) from the run120k_cr weights, B=2,
    Tc=16, the same injected randomness: the loss finite and within 1e-3
    relative of JAX's bf16 loss (measured when written: 2.1e-4; the float32
    model's step reads 2.0e-3 from it, so the bar tells the two apart; 1.7e-3
    with NEWT "cr", kernel 1's plain version, not run here); every gradient
    leaf and Adam moment float32 and finite, and the parameters float32
    after the update."""
    rng = np.random.default_rng(4)
    f0, control, offset, noise = _model_inputs(16, 5)
    audio = (rng.standard_normal((2, 16 * 128)) * 0.1).astype(np.float32)

    def loss_fn(p):
        recon = JNeuralWaveshaping(compute_dtype="bfloat16").apply(
            p, f0, control, phase_offset=offset, noise=noise)
        return j_multi_resolution_stft_loss(recon, audio)

    ref_loss = float(jax.jit(loss_fn)(jax_ckpt))
    model = NeuralWaveshaping(compute_dtype="bfloat16")
    model.load_params(params_from_jax(jax_ckpt))
    model.newt.fused = None
    optimizer = Optimizer(model.parameters(), TrainConfig())
    batch = {"f0": torch.from_numpy(f0), "control": torch.from_numpy(control),
             "audio": torch.from_numpy(audio)}
    metrics = train_step(model, optimizer, batch, phase_offset=torch.from_numpy(offset),
                         noise=torch.from_numpy(noise))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and np.isfinite(float(metrics["grad_norm"]))
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss), (loss, ref_loss)
    for t in model.parameters():
        assert t.dtype == torch.float32 and t.grad.dtype == torch.float32
        assert torch.isfinite(t.grad).all()
        state = optimizer.adam.state[t]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32


def test_bf16_checkpoint_renders_in_float32_as_jax():
    """docs/results/run120k_bf16 (trained with the bf16 recipe) served in
    float32 by default, as its gin file says: the port's render within the
    1e-3 nRMS golden bar of JAX's float32 render of the same checkpoint
    (2.7e-5 when written)."""
    jparams = load_reference_checkpoint(CKPT_BF16)[0]
    f0, control, offset, noise = _model_inputs(16, 9)
    ref = np.asarray(jax.jit(
        lambda p, f, c, o, n: JNeuralWaveshaping().apply(p, f, c, phase_offset=o, noise=n)
    )(jparams, f0, control, offset, noise))
    model = Synthesizer.from_checkpoint(CKPT_BF16, device="cpu").model
    assert model.compute_dtype == "float32"
    assert {t.dtype for t in model.parameters()} == {torch.float32}
    out = _render(model, f0, control, offset, noise)
    assert _nrms(out, ref) <= 1e-3, _nrms(out, ref)


# ---------------------------------------------------------------------------
# paths whose bf16 I/O is not ported
# ---------------------------------------------------------------------------
def test_the_exciter_fused_path_raises_under_bf16(jax_ckpt):
    """Where fuse_exciter would engage, bf16 raises the named
    NotImplementedError on every device (the CPU shows what the card does);
    off, or where the path does not apply, the bf16 model renders."""
    f0, control, offset, noise = _model_inputs(8, 11)
    model = NeuralWaveshaping(compute_dtype="bfloat16", fuse_exciter=True)
    model.load_params(params_from_jax(jax_ckpt))
    with pytest.raises(NotImplementedError, match="queue 1, Mixed precision"):
        _render(model, f0, control, offset, noise)
    model.newt.fused = False  # not a cr spelling: the path does not apply
    assert np.all(np.isfinite(_render(model, f0, control, offset, noise)))


def test_the_stream_of_a_bf16_model_is_the_float32_stream(jax_ckpt):
    """JAX's streaming synth never reads compute_dtype: a bf16-configured
    model streams in float32, bit for bit the float32 model's stream."""
    streams = []
    for cd in ("float32", "bfloat16"):
        model = NeuralWaveshaping(compute_dtype=cd)
        model.load_params(params_from_jax(jax_ckpt))
        ss = StreamingSynth(model, 4)
        state = ss.init_state(2, torch.Generator().manual_seed(0), device="cpu")
        spec = ss.ir_partition_spectra()
        rng = np.random.default_rng(12)
        out = []
        with torch.inference_mode():
            for _ in range(3):
                f0 = torch.from_numpy((300 + 50 * rng.standard_normal((2, 4))).astype(np.float32))
                ctrl = torch.from_numpy(rng.standard_normal((2, 4, 2)).astype(np.float32))
                audio, state = ss.step(state, f0, ctrl, spec)
                out.append(audio)
        streams.append(torch.cat(out, dim=1))
    assert streams[1].dtype == torch.float32
    assert torch.equal(streams[0], streams[1])
