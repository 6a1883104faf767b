"""The port on the card: the CUDA kernels (forward, backward, the
streaming forward, the audio-rate forward and backward, the FastNEWT
lookup, and the exciter-fused forwards and backwards; kernels 1, 2, 4, 5,
6, 7 and 8 in their bf16 instances too) against their plain versions, and
the model (also with ``fuse_exciter`` / ``fuse_out_mixer`` and FastNEWT,
each in bf16 too), a training step, a streamed buffer, timbre transfer and
the preprocessing extractors (pYIN, CREPE, MFCC) on the card against the
same on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it runs where the card is and JAX is not:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the parity tests.)
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint
from neural_waveshaping_synthesis_tpu_torch.inference import Synthesizer, extract_features, timbre_transfer
from neural_waveshaping_synthesis_tpu_torch.kernels import fast_newt
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.models.modules import cast_params
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample, segment_interp
from neural_waveshaping_synthesis_tpu_torch.streaming import StreamingSynth
from neural_waveshaping_synthesis_tpu_torch.training import compute_loss

CKPT = str(
    Path(__file__).resolve().parents[1]
    / "docs" / "results" / "run120k_cr" / "checkpoint" / "best.ckpt"
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params():
    return load_checkpoint(CKPT)[0]


def _shaper(params, device):
    p = params["newt"]["shaping_fn"]
    return {
        "input_scale": p["input_scale"].to(device),
        "layers": [{k: v.to(device) for k, v in layer.items()} for layer in p["layers"]],
    }


def _inputs(b, tc, hop, seed=0):
    rng = np.random.default_rng(seed)
    exc = torch.from_numpy((rng.standard_normal((b, tc * hop, 64)) * 0.5).astype(np.float32))
    film_c = torch.from_numpy(rng.standard_normal((b, tc, 256)).astype(np.float32))
    return exc, film_c


@pytest.mark.parametrize("b,tc,hop", [(2, 6, 16), (1, 37, 128), (2, 5, 10), (1, 3, 1), (3, 1, 64),
                                      (3, 1, 3)])
def test_kernel_matches_plain(cuda, params, b, tc, hop):
    """Kernel vs plain version on the same CUDA tensors, rtol=1e-4,
    atol=1e-5 (the JAX suite's kernel-vs-chain tolerance); odd Tc and
    hops the TPU gate refused included, and 3-sample clips, where a
    thread's group of 4 samples straddles two clips. One launch per call."""
    exc, film_c = (t.to(cuda) for t in _inputs(b, tc, hop))
    w = _shaper(params, cuda)
    before = nf.film_shaper_cr.launches
    with torch.inference_mode():
        out = nf.film_shaper_cr(exc, film_c, w, hop)
        ref = nf.film_shaper_cr_plain(exc, film_c, w, hop)
    torch.cuda.synchronize()
    assert nf.film_shaper_cr.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tc,hop", [(6, 16), (37, 128), (5, 5), (1, 3)])
def test_kernel_film_interpolation_bit_exact(cuda, params, tc, hop):
    """With gamma_out = 0 the kernel's output is its in-register beta_out
    lerp (0*y + beta_out is exact), which must equal linear_upsample —
    on the CPU, where it is bit-exact to the JAX function — bit for bit."""
    exc, film_c = _inputs(2, tc, hop, seed=1)
    film_c[..., 128:192] = 0.0
    with torch.inference_mode():
        out = nf.film_shaper_cr(exc.to(cuda), film_c.to(cuda), _shaper(params, cuda), hop)
    ref = linear_upsample(film_c, tc * hop)[..., 192:]
    assert torch.equal(out.cpu(), ref)


def test_kernel_refuses_what_it_does_not_take(cuda, params):
    exc, film_c = (t.to(cuda) for t in _inputs(1, 4, 8))
    w = _shaper(params, cuda)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            nf.film_shaper_cr(exc.double(), film_c, w, 8)
        strided = torch.empty(1, 64, 32, device=cuda).transpose(1, 2)
        with pytest.raises(ValueError):
            nf.film_shaper_cr(strided, film_c, w, 8)
        with pytest.raises(ValueError):
            nf.film_shaper_cr(exc, film_c.cpu(), w, 8)
    # planes packed without autograd would give the shapers no gradient
    leaves = {"input_scale": w["input_scale"].clone().requires_grad_(), "layers": w["layers"]}
    with torch.no_grad():
        packed = nf.pack_weights(leaves)
    with pytest.raises(ValueError):
        nf.film_shaper_cr(exc, film_c, leaves, 8, packed=packed)


# ---------------------------------------------------------------------------
# mixed precision: the bf16 instances of kernels 1 and 2
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16
BF16_PAIRS = [(BF16, BF16), (BF16, torch.float32)]


def _bf16_planes(params, cuda):
    """The float32 planes of the bf16-rounded shaper, as NEWT packs them
    under bf16, and their tree."""
    packed = nf.pack_weights(cast_params(_shaper(params, cuda), BF16))
    return packed, nf.unpack_weight_grads(packed)


def _ulp_close(out, ref, atol=1e-5):
    """One bf16 ulp (rtol 2^-7) plus atol: the kernel and the plain version
    both compute in float32, and their float32 results differ by FMA
    contraction (1e-4), so the rounded results differ by at most one ulp."""
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=2.0**-7, atol=atol)


@pytest.mark.parametrize("exc_dtype,film_dtype", BF16_PAIRS)
@pytest.mark.parametrize("b,tc,hop", [(2, 6, 16), (1, 37, 128), (3, 1, 3)])
def test_bf16_kernel_matches_plain(cuda, params, exc_dtype, film_dtype, b, tc, hop):
    """Kernel 1's bf16 instances vs the plain version (float32 between bf16
    load and store) within one bf16 ulp; the output bf16; the instance's
    counter moves; with gamma_out = 0 the output is linear_upsample of the
    widened FiLM rounded to bf16, bit for bit."""
    exc, film_c = _inputs(b, tc, hop, seed=4)
    exc, film_c = exc.to(cuda, exc_dtype), film_c.to(cuda, film_dtype)
    packed, tree = _bf16_planes(params, cuda)
    name = "launches_bf16" if film_dtype == BF16 else "launches_bf16_f32"
    before = getattr(nf.film_shaper_cr, name)
    with torch.inference_mode():
        out = nf.film_shaper_cr(exc, film_c, tree, hop, packed=packed)
        ref = nf.film_shaper_cr_plain(exc, film_c, tree, hop)
        film_c[..., 128:192] = 0.0
        lerp = nf.film_shaper_cr(exc, film_c, tree, hop, packed=packed)
    torch.cuda.synchronize()
    assert out.dtype == BF16 and getattr(nf.film_shaper_cr, name) == before + 2
    _ulp_close(out, ref)
    expect = linear_upsample(film_c.float().cpu(), tc * hop)[..., 192:].to(BF16)
    assert torch.equal(lerp.cpu(), expect)


@pytest.mark.parametrize("exc_dtype,film_dtype", BF16_PAIRS)
@pytest.mark.parametrize("b,tc,hop", [(2, 6, 16), (1, 5, 33)])
def test_bf16_backward_kernel_matches_plain(cuda, params, exc_dtype, film_dtype, b, tc, hop):
    """Kernel 2's bf16 instances vs autograd through the plain version:
    d_exciter bf16 and d_film in the FiLM's dtype within one bf16 ulp beyond
    the float32 gradient bar (rtol 1e-3 + 2^-7, atol 1e-3 * max|plain|),
    d_planes float32 at the float32 bar; two calls bit-identical."""
    exc, film_c = _inputs(b, tc, hop, seed=5)
    exc, film_c = exc.to(cuda, exc_dtype), film_c.to(cuda, film_dtype)
    dy = torch.randn(exc.shape, generator=torch.Generator().manual_seed(6)).to(cuda, exc_dtype)
    packed, tree = _bf16_planes(params, cuda)
    out = nf._launch_backward(exc, film_c, packed, dy, hop)
    again = nf._launch_backward(exc, film_c, packed, dy, hop)
    ref = nf.film_shaper_cr_grad_plain(exc, film_c, tree, hop, dy)
    torch.cuda.synchronize()
    assert [t.dtype for t in out] == [BF16, film_dtype, torch.float32]
    assert all(torch.equal(a, r) for a, r in zip(out, again))
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.float().cpu().numpy(), r.float().cpu().numpy(),
                                   rtol=1e-3 + 2.0**-7, atol=1e-3 * float(r.float().abs().max()))
    _grad_close(out[2], ref[2])


def test_bf16_model_on_the_card_launches_the_bf16_instances(cuda, params):
    """A bf16 model with NEWT "cr" launches kernel 1's (bf16, bf16)
    instance, with cr_film_f32 its (bf16, f32) one, and kernels 1 and 2
    with "full_lane_cr" and a gradient; its render is within 0.05 nRMS of
    the float32 render but at least 1e-3 from it (it computes in bf16), and
    within 2e-3 of the CPU's bf16 render (chip_smoke.py's bar: a card path
    that computed in float32 would read the bf16-vs-float32 gap)."""
    rng = np.random.default_rng(7)
    tc = 64
    f0 = torch.from_numpy(np.geomspace(150, 600, tc)[None].astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    outs = {}
    for label, cd, dev in (("f32", "float32", cuda), ("bf16", "bfloat16", cuda),
                           ("bf16_cpu", "bfloat16", torch.device("cpu"))):
        model = NeuralWaveshaping(compute_dtype=cd)
        model.load_params(params)
        model.to(dev)
        before = nf.film_shaper_cr.launches_bf16
        with torch.inference_mode():
            y = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev))
        outs[label] = y.cpu().numpy()
        assert nf.film_shaper_cr.launches_bf16 == before + (label == "bf16")
        if label == "bf16":
            model.newt.cr_film_f32 = True
            before = nf.film_shaper_cr.launches_bf16_f32
            with torch.inference_mode():
                model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev))
            assert nf.film_shaper_cr.launches_bf16_f32 == before + 1
            model.newt.fused = "full_lane_cr"
            before = nf.film_shaper_cr.bwd_launches_bf16_f32
            loss = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev),
                         noise=noise.to(dev)).square().mean()
            loss.backward()
            assert nf.film_shaper_cr.bwd_launches_bf16_f32 == before + 1
            assert all(p.grad.dtype == torch.float32 for p in model.parameters())

    def nrms(a, b):
        return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2))

    assert 1e-3 < nrms(outs["bf16"], outs["f32"]) < 0.05, nrms(outs["bf16"], outs["f32"])
    assert nrms(outs["bf16"], outs["bf16_cpu"]) < 2e-3, nrms(outs["bf16"], outs["bf16_cpu"])


def test_newt_on_the_card_launches_the_kernel(cuda, params):
    newt = NEWT()
    newt.load_params(params["newt"])
    newt.to(cuda)
    rng = np.random.default_rng(2)
    exc = torch.from_numpy((rng.standard_normal((2, 15 * 128, 64)) * 0.5).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((2, 15, 128)).astype(np.float32))
    before = nf.film_shaper_cr.launches
    with torch.inference_mode():
        out = newt(exc.to(cuda), emb.to(cuda))
        chain = newt(exc.to(cuda), emb.to(cuda), fused=False)
    assert nf.film_shaper_cr.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), chain.cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_newt_refuses_a_shaper_the_kernel_does_not_take(cuda):
    """fused="cr" (and "full_lane_cr") with a shaper the kernel does not
    take raises on the card, with or without gradients, where JAX's "cr"
    would run its chain; fused=False is the way to the plain chain."""
    newt = NEWT(shaping_fn_depth=3).to(cuda)
    exc = torch.zeros(1, 4 * 8, 64, device=cuda)
    emb = torch.zeros(1, 4, 128, device=cuda)
    launches = nf.film_shaper_cr.launches
    for fused in ("cr", "full_lane_cr"):
        with torch.inference_mode(), pytest.raises(ValueError, match="fused=False"):
            newt(exc, emb, fused=fused)
        with pytest.raises(ValueError, match="fused=False"):
            newt(exc, emb, fused=fused)
    assert nf.film_shaper_cr.launches == launches
    newt(exc, emb, fused=False).sum().backward()


def test_model_on_the_card_matches_the_cpu(cuda, params):
    """Same weights, inputs, phase offsets and noise: 1e-3 nRMS."""
    rng = np.random.default_rng(3)
    tc = 64
    f0 = torch.from_numpy(np.geomspace(150, 600, tc)[None].astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model = NeuralWaveshaping()
        model.load_params(params)
        model.to(dev)
        with torch.inference_mode():
            y = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev))
        outs.append(y.cpu().numpy())
    card, cpu = outs
    assert np.sqrt(np.mean((card - cpu) ** 2)) / np.sqrt(np.mean(cpu**2)) <= 1e-3


def _grad_close(out, ref):
    """The JAX suite's gradient bar, rtol=1e-3, with atol = 1e-3 * max|plain|
    per tensor: weight grads are sums over every sample, so an absolute
    bar set for unit-size values does not scale to them."""
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())


def _cr_grad_plain_by_clip(exc, film_c, w, hop, dy):
    """film_shaper_cr_grad_plain one clip at a time (d_planes summed over
    the clips), so that the largest geometry's autograd fits the card."""
    parts = [nf.film_shaper_cr_grad_plain(exc[i : i + 1], film_c[i : i + 1], w, hop, dy[i : i + 1])
             for i in range(exc.shape[0])]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]), sum(p[2] for p in parts)


# The kernel's lanes are samples of a segment, 32 at a time, one segment per
# block: hops below, at and across a multiple of 32 (partial lane-groups),
# odd B*Tc, and (8, 1000, 128) with more segments than resident blocks.
@pytest.mark.parametrize("b,tc,hop", [
    (2, 6, 16), (1, 37, 128), (2, 5, 10), (1, 3, 1), (3, 1, 64),
    (2, 5, 31), (2, 5, 33), (1, 9, 100), (3, 7, 129), (1, 4, 300), (8, 1000, 128)])
def test_backward_kernel_matches_plain(cuda, params, b, tc, hop):
    """d_exciter, d_film_c and the 170 weight-gradient planes of the CUDA
    backward against autograd through the plain version; one launch."""
    exc, film_c = (t.to(cuda) for t in _inputs(b, tc, hop, seed=4))
    dy = torch.randn(exc.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    w = _shaper(params, cuda)
    before = nf.film_shaper_cr.bwd_launches
    out = nf._launch_backward(exc, film_c, nf.pack_weights(w), dy, hop)
    ref = _cr_grad_plain_by_clip(exc, film_c, w, hop, dy)
    torch.cuda.synchronize()
    assert nf.film_shaper_cr.bwd_launches == before + 1
    for o, r in zip(out, ref):
        _grad_close(o, r)


@pytest.mark.parametrize("b,tc", [(2, 50), (8, 500)])
def test_backward_kernel_is_deterministic(cuda, params, b, tc):
    """Lane sums and per-block partials in a fixed order, no atomics: two
    calls on the same inputs give the same bits, also at the training
    step's shape (8 clips of 4 s)."""
    exc, film_c = (t.to(cuda) for t in _inputs(b, tc, 128, seed=6))
    dy = torch.randn(exc.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    packed = nf.pack_weights(_shaper(params, cuda))
    first = nf._launch_backward(exc, film_c, packed, dy, 128)
    second = nf._launch_backward(exc, film_c, packed, dy, 128)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_backward_clamp_gradients(cuda, params):
    """A loss that reads only the first half-hop and the last hop: the
    FiLM cotangents of the clamped head and tail fold onto frames 0 and
    Tc-1 (the JAX test_cr_head_and_tail_clamp_gradients case), through
    the autograd Function."""
    hop = 16
    exc, film_c = (t.to(cuda) for t in _inputs(2, 6, hop, seed=8))
    w = _shaper(params, cuda)

    def film_grad(fn):
        f = film_c.clone().requires_grad_()
        out = fn(f)
        (out[:, : hop // 2].square().sum() + out[:, -hop:].square().sum()).backward()
        return f.grad

    before = nf.film_shaper_cr.bwd_launches
    got = film_grad(lambda f: nf.film_shaper_cr(exc, f, w, hop))
    assert nf.film_shaper_cr.bwd_launches == before + 1
    ref = film_grad(lambda f: nf.film_shaper_cr_plain(exc, f, w, hop))
    _grad_close(got, ref)


def test_every_newt_leaf_gets_a_gradient_on_the_card(cuda, params):
    """NEWT with gradients on the card: both kernels launch once, every
    parameter (the 9 shaper leaves among them) gets a nonzero gradient,
    within 1e-3 normalised of the same NEWT on the CPU."""
    rng = np.random.default_rng(9)
    exc = torch.from_numpy((rng.standard_normal((2, 15 * 128, 64)) * 0.5).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((2, 15, 128)).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        newt = NEWT()
        newt.load_params(params["newt"])
        newt.to(dev)
        launches = (nf.film_shaper_cr.launches, nf.film_shaper_cr.bwd_launches)
        newt(exc.to(dev), emb.to(dev)).square().sum().backward()
        if dev.type == "cuda":
            assert (nf.film_shaper_cr.launches, nf.film_shaper_cr.bwd_launches) == (
                launches[0] + 1, launches[1] + 1)
        grads.append({n: p.grad.cpu() for n, p in newt.named_parameters()})
    card, cpu = grads
    for name, g in card.items():
        assert torch.count_nonzero(g) > 0, name
        assert torch.linalg.norm(g - cpu[name]) <= 1e-3 * torch.linalg.norm(cpu[name]), name


def test_one_training_step_on_the_card_matches_the_cpu(cuda):
    """The loss and every parameter's gradient of one step, from the same
    seeded random weights, batch (a 1-s harmonic tone and its controls),
    phase offsets and noise: loss within 1e-4 relative, no gradient zero
    on the card, each within 1e-3 normalised of the CPU's. The
    log-magnitude L1 term of the loss divides by each bin's magnitude, so
    float32 rounding alone moves some leaves by ~1e-3 (harmonic_mixer.w
    reads 1.4e-3 card vs CPU here): a leaf beyond 1e-3 passes when the
    card's gradient is no farther from the float64 gradient than the
    CPU's float32 gradient is, plus 1e-3. scripts/torch_grad_bar.py
    measures this rule on the card, sound and with planted faults
    (PERF.md, PR 2)."""
    rng = np.random.default_rng(10)
    tc = 125
    f0 = np.geomspace(220.0, 440.0, tc).astype(np.float32)
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, 128)) / 16000
    audio = 0.1 * sum(np.sin(k * phase) / k for k in range(1, 11))
    batch = {
        "f0": torch.from_numpy(f0[None]),
        "control": torch.from_numpy(np.stack([(f0 - 330.0) / 60.0, np.zeros(tc)], -1)[None].astype(np.float32)),
        "audio": torch.from_numpy(audio[None].astype(np.float32)),
    }
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    base = NeuralWaveshaping(generator=torch.Generator().manual_seed(3))
    results = []
    for dev, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float32),
                       (torch.device("cpu"), torch.float64)):
        model = copy.deepcopy(base).to(dev, dtype)
        loss = compute_loss(model, {k: v.to(dev, dtype) for k, v in batch.items()},
                            phase_offset=offset.to(dev, dtype), noise=noise.to(dev, dtype))
        loss.backward()
        results.append((float(loss.detach()),
                        {n: p.grad.cpu().double() for n, p in model.named_parameters()}))
    (card_loss, card), (cpu_loss, cpu), (_, exact) = results

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    for name, g in card.items():
        assert torch.count_nonzero(g) > 0, name
        if rel(g, cpu[name]) > 1e-3:
            assert rel(g, exact[name]) <= rel(cpu[name], exact[name]) + 1e-3, name


# ---------------------------------------------------------------------------
# audio rate: the forward and backward kernels (JAX film_shaper_fused_fl and
# film_shaper_fused, and their backwards) and NEWT's audio-rate dispatch
# ---------------------------------------------------------------------------
def _fl_inputs(b, ta, seed=0):
    rng = np.random.default_rng(seed)
    exc = torch.from_numpy((rng.standard_normal((b, ta, 64)) * 0.5).astype(np.float32))
    film_a = torch.from_numpy(rng.standard_normal((b, ta, 256)).astype(np.float32))
    return exc, film_a


# odd B*Ta, ragged chunks, under one chunk, a chunk across clips, more chunks
# than resident blocks
_FL_SHAPES = [(2, 96), (1, 37), (3, 333), (1, 1), (2, 1025), (1, 31), (3, 47), (3, 1500)]


@pytest.mark.parametrize("b,ta", _FL_SHAPES + [(8, 65536)])
def test_fl_kernel_matches_plain(cuda, params, b, ta):
    """The audio-rate forward against its plain version on the same CUDA
    tensors, rtol=1e-4, atol=1e-5; odd B*Ta (JAX needed it even), B*Ta
    not a multiple of a thread's 4 samples, groups across clips, and at a
    batch-8 render's (8, 65536) more groups of 4 samples than the card
    holds threads at once. One launch per call."""
    exc, film_a = (t.to(cuda) for t in _fl_inputs(b, ta, seed=ta))
    w = _shaper(params, cuda)
    before = nf.film_shaper_fl.launches
    with torch.inference_mode():
        out = nf.film_shaper_fl(exc, film_a, w)
        ref = nf.film_shaper_fl_plain(exc, film_a, w)
    torch.cuda.synchronize()
    assert nf.film_shaper_fl.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tc,hop", [(6, 16), (37, 128)])
def test_fl_kernel_matches_the_cr_kernel_on_the_upsampled_film(cuda, params, tc, hop):
    """The audio-rate forward fed linear_upsample of a control-rate FiLM
    computes what the control-rate forward computes from that FiLM: rtol
    1e-5, atol 2e-6, the JAX test_cr_forward_matches_fl_kernel bar."""
    exc, film_c = (t.to(cuda) for t in _inputs(2, tc, hop, seed=tc))
    w = _shaper(params, cuda)
    with torch.inference_mode():
        fl = nf.film_shaper_fl(exc, linear_upsample(film_c, tc * hop), w)
        cr = nf.film_shaper_cr(exc, film_c, w, hop)
    np.testing.assert_allclose(fl.cpu().numpy(), cr.cpu().numpy(), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("b,ta", _FL_SHAPES + [(8, 64000)])
def test_fl_backward_kernel_matches_plain(cuda, params, b, ta):
    """d_exciter, d_film and the 170 weight-gradient planes of the
    audio-rate backward against autograd through the plain version; one
    launch; two calls give the same bits, also at the full_lane training
    step's shape (8, 64000)."""
    exc, film_a = (t.to(cuda) for t in _fl_inputs(b, ta, seed=ta + 1))
    dy = torch.randn(exc.shape, generator=torch.Generator().manual_seed(ta)).to(cuda)
    w = _shaper(params, cuda)
    packed = nf.pack_weights(w)
    before = nf.film_shaper_fl.bwd_launches
    out = nf._launch_backward_fl(exc, film_a, packed, dy)
    again = nf._launch_backward_fl(exc, film_a, packed, dy)
    ref = nf.film_shaper_fl_grad_plain(exc, film_a, w, dy)
    torch.cuda.synchronize()
    assert nf.film_shaper_fl.bwd_launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    for o, r in zip(out, ref):
        _grad_close(o, r)


def test_fl_kernel_refuses_what_it_does_not_take(cuda, params):
    exc, film_a = (t.to(cuda) for t in _fl_inputs(1, 16))
    w = _shaper(params, cuda)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            nf.film_shaper_fl(exc.double(), film_a, w)
        with pytest.raises(ValueError):
            nf.film_shaper_fl(exc, film_a[:, :8].contiguous(), w)
        with pytest.raises(ValueError):
            nf.film_shaper_fl(exc, film_a.cpu(), w)
        with pytest.raises(ValueError):
            nf.film_shaper_fl(exc[:, :0], film_a[:, :0], w)


@pytest.mark.parametrize("fused", [True, "full_lane", "fl"])
def test_newt_audio_rate_on_the_card(cuda, params, fused):
    """NEWT(fused=True | "full_lane" | "fl") on the card launches the
    audio-rate forward (and with gradients its backward) and never the
    control-rate kernels; output and gradients agree with the same NEWT
    on the CPU (1e-4/1e-5, and 1e-3 normalised per leaf)."""
    rng = np.random.default_rng(11)
    exc = torch.from_numpy((rng.standard_normal((2, 15 * 128, 64)) * 0.5).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((2, 15, 128)).astype(np.float32))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        newt = NEWT(fused=fused)
        newt.load_params(params["newt"])
        newt.to(dev)
        before = (nf.film_shaper_fl.launches, nf.film_shaper_fl.bwd_launches,
                  nf.film_shaper_cr.launches, nf.film_shaper_cr.bwd_launches)
        out = newt(exc.to(dev), emb.to(dev))
        out.square().sum().backward()
        if dev.type == "cuda":
            after = (nf.film_shaper_fl.launches, nf.film_shaper_fl.bwd_launches,
                     nf.film_shaper_cr.launches, nf.film_shaper_cr.bwd_launches)
            assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
        runs.append((out.detach().cpu(), {n: p.grad.cpu() for n, p in newt.named_parameters()}))
    (card, card_g), (cpu, cpu_g) = runs
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=1e-4, atol=1e-5)
    for name, g in card_g.items():
        assert torch.count_nonzero(g) > 0, name
        assert torch.linalg.norm(g - cpu_g[name]) <= 1e-3 * torch.linalg.norm(cpu_g[name]), name


def test_newt_full_lane_cr_falls_back_to_the_audio_rate_kernel(cuda, params):
    """At a non-integer hop (Ta=130, Tc=4) the cr kernel refuses the
    geometry: "full_lane_cr" runs the audio-rate kernel, as JAX falls
    back, and "cr" raises."""
    rng = np.random.default_rng(12)
    exc = torch.from_numpy((rng.standard_normal((1, 130, 64)) * 0.5).astype(np.float32)).to(cuda)
    emb = torch.from_numpy(rng.standard_normal((1, 4, 128)).astype(np.float32)).to(cuda)
    newt = NEWT(fused="full_lane_cr")
    newt.load_params(params["newt"])
    newt.to(cuda)
    before = (nf.film_shaper_fl.launches, nf.film_shaper_cr.launches)
    with torch.inference_mode():
        out = newt(exc, emb)
        ref = newt(exc, emb, fused=False)
        with pytest.raises(ValueError, match="fused=False"):
            newt(exc, emb, fused="cr")
    assert (nf.film_shaper_fl.launches, nf.film_shaper_cr.launches) == (before[0] + 1, before[1])
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_newt_audio_rate_refuses_a_shaper_the_kernel_does_not_take(cuda):
    newt = NEWT(shaping_fn_depth=3, fused="full_lane").to(cuda)
    exc = torch.zeros(1, 4 * 8, 64, device=cuda)
    emb = torch.zeros(1, 4, 128, device=cuda)
    for fused in (True, "full_lane", "fl"):
        with pytest.raises(ValueError, match="fused=False"):
            newt(exc, emb, fused=fused)
    newt(exc, emb, fused=False).sum().backward()


def _fl_counts():
    f = nf.film_shaper_fl
    return {"fl": f.launches, "fl_bwd": f.bwd_launches, "fl_bf16": f.launches_bf16,
            "fl_bwd_bf16": f.bwd_launches_bf16, "cr": nf.film_shaper_cr.launches,
            "cr_bf16": nf.film_shaper_cr.launches_bf16}


def _moved(before, **expect):
    """The counters that moved since ``before``, each by its ``expect``."""
    after = _fl_counts()
    assert {k: after[k] - before[k] for k in after} == {k: expect.get(k, 0) for k in after}


@pytest.mark.parametrize("b,ta", _FL_SHAPES + [(8, 65536)])
def test_bf16_fl_kernel_matches_plain(cuda, params, b, ta):
    """Kernel 5's (bf16, bf16) instance vs its plain version (float32
    between bf16 load and store, rounded once) within one bf16 ulp (rtol
    2^-7, atol 1e-5); the output bf16; one launch of the bf16 instance and
    none of the float32 one; the shapes of the float32 test (odd B*Ta,
    ragged groups, groups across clips, a batch-8 render's (8, 65536))."""
    exc, film_a = (t.to(cuda, BF16) for t in _fl_inputs(b, ta, seed=ta + 2))
    packed, tree = _bf16_planes(params, cuda)
    before = _fl_counts()
    with torch.inference_mode():
        out = nf.film_shaper_fl(exc, film_a, tree, packed=packed)
    _moved(before, fl_bf16=1)
    with torch.inference_mode():
        ref = nf.film_shaper_fl_plain(exc, film_a, tree)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    _ulp_close(out, ref)


@pytest.mark.parametrize("b,ta", _FL_SHAPES + [(8, 64000)])
def test_bf16_fl_backward_kernel_matches_plain(cuda, params, b, ta):
    """Kernel 6's (bf16, bf16) instance vs autograd through the plain
    version: d_exciter and d_film bf16 within one bf16 ulp beyond the
    float32 gradient bar (rtol 1e-3 + 2^-7, atol 1e-3 * max|plain|),
    d_planes float32 at the float32 bar; two calls bit-identical (in the
    bf16 tiles lanes write adjacent halves of a word); two launches of the
    bf16 instance and none of the float32 one; at the full_lane training
    step's (8, 64000) too."""
    exc, film_a = (t.to(cuda, BF16) for t in _fl_inputs(b, ta, seed=ta + 3))
    dy = torch.randn(exc.shape, generator=torch.Generator().manual_seed(ta)).to(cuda, BF16)
    packed, tree = _bf16_planes(params, cuda)
    before = _fl_counts()
    out = nf._launch_backward_fl(exc, film_a, packed, dy)
    again = nf._launch_backward_fl(exc, film_a, packed, dy)
    _moved(before, fl_bwd_bf16=2)
    ref = nf.film_shaper_fl_grad_plain(exc, film_a, tree, dy)
    torch.cuda.synchronize()
    assert [t.dtype for t in out] == [BF16, BF16, torch.float32]
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.float().cpu().numpy(), r.float().cpu().numpy(),
                                   rtol=1e-3 + 2.0**-7, atol=1e-3 * float(r.float().abs().max()))
    _grad_close(out[2], ref[2])


def test_bf16_fl_kernels_take_views_at_an_odd_offset(cuda, params):
    """The backward's 4-byte staging copies need word-aligned bf16 data: a
    contiguous view at an odd bf16 offset is copied first, and gives the
    aligned tensors' bits; the forward reads 2-byte elements and takes it
    as it is. Mixed pairs are refused."""
    exc, film_a = (t.to(cuda, BF16) for t in _fl_inputs(1, 40, seed=5))
    dy = torch.randn(exc.shape, generator=torch.Generator().manual_seed(1)).to(cuda, BF16)
    packed, tree = _bf16_planes(params, cuda)

    def odd(t):
        flat = torch.empty(t.numel() + 1, dtype=BF16, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 4 == 2
        return view

    grads = nf._launch_backward_fl(exc, film_a, packed, dy)
    moved = nf._launch_backward_fl(odd(exc), odd(film_a), packed, odd(dy))
    assert all(torch.equal(a, c) for a, c in zip(grads, moved))
    with torch.inference_mode():
        assert torch.equal(nf._launch_forward_fl(odd(exc), odd(film_a), packed),
                           nf._launch_forward_fl(exc, film_a, packed))
        with pytest.raises(TypeError, match="film of the exciter's dtype"):
            nf.film_shaper_fl(exc, film_a.float(), tree, packed=packed)
        with pytest.raises(TypeError, match="film of the exciter's dtype"):
            nf.film_shaper_fl(exc.float(), film_a, tree, packed=packed)
    with pytest.raises(ValueError, match="dy must be"):
        nf._launch_backward_fl(exc, film_a, packed, dy.float())


@pytest.mark.parametrize("fused,ta,tc", [(True, 15 * 128, 15), ("full_lane", 15 * 128, 15),
                                         ("fl", 15 * 128, 15), ("full_lane_cr", 130, 4)])
def test_bf16_newt_audio_rate_on_the_card(cuda, params, fused, ta, tc):
    """Under bf16 on the card, NEWT with True / "full_lane" / "fl", and
    "full_lane_cr" at Ta=130, Tc=4 (the fallback), launches the audio-rate
    kernels' bf16 instances (forward, and backward with a gradient) and no
    float32 instance and no control-rate kernel; the output bf16 within one
    bf16 ulp of the same NEWT on the CPU (its plain version; atol 2^-8 for
    the bf16 FiLM MLP's roundings, which cuBLAS and the CPU may place
    apart), and every float32 master gets a gradient within 2e-2
    normalised of the CPU's."""
    rng = np.random.default_rng(13)
    exc = torch.from_numpy((rng.standard_normal((2, ta, 64)) * 0.5).astype(np.float32)).to(BF16)
    emb = torch.from_numpy(rng.standard_normal((2, tc, 128)).astype(np.float32))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        newt = NEWT(fused=fused)
        newt.load_params(params["newt"])
        newt.to(dev)
        before = _fl_counts()
        out = newt(exc.to(dev), emb.to(dev))
        out.float().square().sum().backward()
        if dev.type == "cuda":
            _moved(before, fl_bf16=1, fl_bwd_bf16=1)
        runs.append((out.detach().float().cpu(), {n: t.grad.cpu() for n, t in newt.named_parameters()}))
    (card, card_g), (cpu, cpu_g) = runs
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=2.0**-7, atol=2.0**-8)
    for name, g in card_g.items():
        assert g.dtype == torch.float32 and torch.count_nonzero(g) > 0, name
        assert torch.linalg.norm(g - cpu_g[name]) <= 2e-2 * torch.linalg.norm(cpu_g[name]), name


# ---------------------------------------------------------------------------
# streaming: the stream kernel (JAX film_shaper_fused_stream) and a step
# ---------------------------------------------------------------------------
def _stream_inputs(b, k, hop, seed=0):
    exc, film_c = _inputs(b, k, hop, seed)
    prev = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal((b, 256)).astype(np.float32))
    return exc, prev, film_c


@pytest.mark.parametrize("b,k,hop", [(2, 1, 128), (2, 3, 128), (1, 8, 128), (2, 4, 64),
                                     (1, 3, 5), (2, 4, 3), (2, 5, 33), (3, 3, 129), (256, 1, 128)])
def test_stream_kernel_matches_plain(cuda, params, b, k, hop):
    """Stream kernel vs its plain version on the same CUDA tensors, rtol
    1e-4, atol 1e-5, and two calls give the same bits; K = 1 and odd K
    (which the TPU gate refused) and hop 64 included. The kernel shapes
    several samples per thread, so also: B*Ta not a multiple of that
    (B = 1, K = 3, hop 5), a hop below it (hop 3), groups across a segment
    and a buffer boundary (hops 33 and 129) and K = 1 at 256 streams. One
    launch per call."""
    exc, prev, film_c = (t.to(cuda) for t in _stream_inputs(b, k, hop, seed=k))
    w = _shaper(params, cuda)
    before = nf.film_shaper_stream.launches
    with torch.inference_mode():
        out = nf.film_shaper_stream(exc, prev, film_c, w, hop)
        ref = nf.film_shaper_stream_plain(exc, prev, film_c, w, hop)
        again = nf.film_shaper_stream(exc, prev, film_c, w, hop)
    torch.cuda.synchronize()
    assert nf.film_shaper_stream.launches == before + 2
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(out, again)


@pytest.mark.parametrize("k,hop", [(8, 128), (3, 5), (4, 3)])
def test_stream_kernel_ramp_bit_exact(cuda, params, k, hop):
    """With gamma_out = 0 the output is the kernel's in-register beta_out
    ramp, which must equal segment_interp on the CPU bit for bit."""
    exc, prev, film_c = _stream_inputs(2, k, hop, seed=1)
    film_c[..., 128:192] = 0.0
    prev[..., 128:192] = 0.0
    with torch.inference_mode():
        out = nf.film_shaper_stream(exc.to(cuda), prev.to(cuda), film_c.to(cuda), _shaper(params, cuda), hop)
    assert torch.equal(out.cpu(), segment_interp(prev, film_c, hop)[..., 192:])


@pytest.mark.parametrize("hop", [128, 33])
def test_stream_kernel_split_is_bit_identical(cuda, params, hop):
    """Two buffers (3 + 5 frames, the second carrying the first's last
    frame) give the bits of one 8-frame buffer; at hop 33 the cut (99
    samples) is not a multiple of the samples a thread shapes at once."""
    cut = 3
    exc, prev, film_c = (t.to(cuda) for t in _stream_inputs(2, 8, hop, seed=2))
    w = _shaper(params, cuda)
    with torch.inference_mode():
        whole = nf.film_shaper_stream(exc, prev, film_c, w, hop)
        first = nf.film_shaper_stream(exc[:, : cut * hop].contiguous(), prev,
                                      film_c[:, :cut].contiguous(), w, hop)
        second = nf.film_shaper_stream(exc[:, cut * hop :].contiguous(),
                                       film_c[:, cut - 1].contiguous(),
                                       film_c[:, cut:].contiguous(), w, hop)
    assert torch.equal(whole, torch.cat([first, second], dim=1))


def test_newt_stream_refuses_a_shaper_the_kernel_does_not_take(cuda):
    newt = NEWT(shaping_fn_depth=3).to(cuda)
    exc = torch.zeros(1, 2 * 8, 64, device=cuda)
    prev, film_c = torch.zeros(1, 256, device=cuda), torch.zeros(1, 2, 256, device=cuda)
    launches = nf.film_shaper_stream.launches
    with torch.inference_mode():
        with pytest.raises(ValueError, match="fused=False"):
            newt.forward_stream(exc, prev, film_c)
        newt.forward_stream(exc, prev, film_c, fused=False)
    assert nf.film_shaper_stream.launches == launches


def test_streamed_buffers_on_the_card_match_the_cpu(cuda, params):
    """Two 1024-sample buffers of one stream from the same state (injected
    phase offsets) and the same injected noise, on the card and on the
    CPU: 1e-3 nRMS each. On the card each step launches the stream kernel
    once, never the offline kernels, and waits for nothing (sync debug
    mode "error")."""
    rng = np.random.default_rng(4)
    k = 8
    f0 = torch.from_numpy(np.geomspace(200, 400, 2 * k)[None].astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((1, 2 * k, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, (1, 101)).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, (2, 1, k * 128)).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model = NeuralWaveshaping()
        model.load_params(params)
        synth = StreamingSynth(model.to(dev), k)
        state = synth.init_state(1, phase_offset=offset, device=dev)
        spec = synth.ir_partition_spectra()
        args = [(f0[:, i * k : (i + 1) * k].to(dev), control[:, i * k : (i + 1) * k].to(dev),
                 noise[i].to(dev)) for i in range(2)]
        launches = (nf.film_shaper_stream.launches, nf.film_shaper_cr.launches)
        audio = []
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for f, c, n in args:
                y, state = synth.step(state, f, c, spec, noise=n)
                audio.append(y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if dev.type == "cuda":
            assert (nf.film_shaper_stream.launches, nf.film_shaper_cr.launches) == (
                launches[0] + 2, launches[1])
        outs.append(torch.cat(audio, dim=-1).cpu().numpy())
    card, cpu = outs
    assert card.shape == (1, 2 * k * 128) and np.all(np.isfinite(card))
    for i in range(2):
        a, b = card[:, i * k * 128 : (i + 1) * k * 128], cpu[:, i * k * 128 : (i + 1) * k * 128]
        assert np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)) <= 1e-3


# ---------------------------------------------------------------------------
# FastNEWT: the lookup kernel (JAX fast_newt_lookup_pallas) and timbre transfer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,shape", [(4096, (2, 1000, 64)), (256, (3, 333, 64)), (2, (1, 7, 5))])
def test_lookup_kernel_matches_plain_bit_for_bit(cuda, s, shape):
    """The kernel against its plain version on the same CUDA tensors: bit
    for bit (both round each step as written, no FMA), over x in [-4, 4]
    with both edges crossed and the exact grid points; S = 2 and a channel
    count other than 64 included. One launch per call."""
    rng = np.random.default_rng(s)
    table = torch.from_numpy(rng.standard_normal((s, shape[-1])).astype(np.float32)).to(cuda)
    x = rng.uniform(-4, 4, shape).astype(np.float32)
    x.reshape(-1)[:s] = np.float32(-3) + np.arange(s, dtype=np.float32) * np.float32(6 / s)
    x = torch.from_numpy(x).to(cuda)
    before = fast_newt.fast_newt_lookup.launches
    with torch.inference_mode():
        out = fast_newt.fast_newt_lookup(table, x)
        ref = fast_newt.fast_newt_lookup_plain(table, x)
    torch.cuda.synchronize()
    assert fast_newt.fast_newt_lookup.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape,offset,path", [((2, 1000, 64), 1, "scalar"), ((3, 333, 64), 0, "vec4"),
                                               ((1, 7, 5), 0, "scalar")])
def test_lookup_kernel_paths_match_plain_bit_for_bit(cuda, shape, offset, path):
    """Both paths of the one kernel against the plain version, torch.equal:
    a contiguous C = 64 view at storage offset 1 (4 B past 16-B alignment)
    takes the scalar path, 999 rows (not a multiple of a block pass's 16)
    the vec4 path, C = 5 the scalar path."""
    rng = np.random.default_rng(shape[1] + offset)
    table = torch.from_numpy(rng.standard_normal((4096, shape[-1])).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.uniform(-4, 4, shape).astype(np.float32)).to(cuda)
    x = torch.empty(x.numel() + offset, device=cuda)[offset:].view(shape).copy_(x)
    assert fast_newt._lookup_path(x, torch.empty_like(x)) == path
    with torch.inference_mode():
        out = fast_newt.fast_newt_lookup(table, x)
        ref = fast_newt.fast_newt_lookup_plain(table, x)
    assert torch.equal(out, ref)


def test_lookup_kernel_refuses_what_it_does_not_take(cuda):
    table, x = torch.zeros(256, 64, device=cuda), torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        fast_newt.fast_newt_lookup(table.cpu(), x)
    with pytest.raises(TypeError):
        fast_newt.fast_newt_lookup(table, x.double())
    with pytest.raises(ValueError):
        fast_newt.fast_newt_lookup(table, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        fast_newt.fast_newt_lookup(table, x.requires_grad_())


def test_fast_newt_model_on_the_card_matches_the_cpu(cuda, params):
    """The whole model with the baked table: the lookup kernel launches,
    the cr kernel does not, and card and CPU agree within 1e-3 nRMS."""
    rng = np.random.default_rng(12)
    tc = 64
    f0 = torch.from_numpy(np.geomspace(150, 600, tc)[None].astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        model = NeuralWaveshaping()
        model.load_params(params)
        model.to(dev)
        launches = (fast_newt.fast_newt_lookup.launches, nf.film_shaper_cr.launches)
        with torch.inference_mode():
            table = model.newt.bake_lookup_table()
            y = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev),
                      lookup_table=table)
        if dev.type == "cuda":
            assert (fast_newt.fast_newt_lookup.launches, nf.film_shaper_cr.launches) == (
                launches[0] + 1, launches[1])
        outs.append(y.cpu().numpy())
    card, cpu = outs
    assert np.sqrt(np.mean((card - cpu) ** 2)) / np.sqrt(np.mean(cpu**2)) <= 1e-3


def test_timbre_transfer_on_the_card(cuda):
    """Features on the card against the CPU (loudness atol 1e-4, f0 rtol
    1e-4 on the voiced frames), and ``timbre_transfer`` with and without
    FastNEWT: finite, not silent, Tc * 128 samples."""
    sr = 44100
    t = np.arange(int(1.5 * sr)) / sr
    audio = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    card = extract_features(audio, sr, device=cuda)
    cpu = extract_features(audio, sr, device="cpu")
    voiced = cpu[2] > 0.5
    assert voiced.mean() > 0.9
    np.testing.assert_allclose(card[3], cpu[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(card[1][voiced], cpu[1][voiced], rtol=1e-4)
    synth = Synthesizer.from_checkpoint(CKPT, device=cuda)
    for fast in (False, True):
        out, speed = timbre_transfer(synth, audio, sr, use_fast_newt=fast)
        assert out.shape == (len(cpu[1]) * 128,) and np.all(np.isfinite(out)) and speed > 0
        assert np.sqrt(np.mean(out**2)) > 1e-4


# ---------------------------------------------------------------------------
# exciter-fused: the xcr and xfull kernels (JAX bank_film_shaper_fused_xcr,
# bank_newt_fused_xfull) and their backwards, and the model's fused path
# ---------------------------------------------------------------------------
def _x_inputs(b, tc, hop, h=101, seed=0):
    """Wrapped phase and f0 (110 Hz to 1.76 kHz, so the antialias mask cuts
    real harmonics), offsets, control-rate film, mixer and w_out."""
    rng = np.random.default_rng(seed)
    f0 = (110.0 * 2.0 ** rng.uniform(0, 4, (b, tc * hop))).astype(np.float32)
    phase = np.mod(2 * np.pi * np.cumsum(f0.astype(np.float64), -1) / 16000, 2 * np.pi)
    arrays = (phase.astype(np.float32), f0, rng.uniform(-np.pi, np.pi, h).astype(np.float32),
              rng.standard_normal((b, tc, 256)).astype(np.float32),
              (rng.standard_normal((h, 64)) * 0.1).astype(np.float32),
              (rng.standard_normal(64) * 0.1).astype(np.float32),
              (rng.standard_normal(64) * 0.1).astype(np.float32))
    return tuple(torch.from_numpy(a) for a in arrays)


# (B, Tc, hop, H). The backward's lanes are samples of a segment, 32 at a
# time, one segment per block: hops across a multiple of 32 (partial lane
# groups), odd B*Tc, H = 2, 101 and 128, and 300 segments, more than the
# blocks resident on an H100 (132). The forward's threads hold groups of 4
# consecutive samples: 3-sample clips make groups straddle two clips.
_X_SHAPES = [(2, 6, 16, 101), (1, 37, 128, 101), (2, 5, 64, 2), (3, 1, 64, 128), (1, 3, 1, 101),
             (2, 5, 31, 101), (2, 5, 33, 128), (1, 9, 100, 2), (3, 7, 129, 101), (1, 4, 300, 128),
             (2, 150, 33, 101), (3, 1, 3, 101)]


def _x_call(kind, fn_xcr, fn_xfull, phase, f0, off, film_c, w, bias, w_out, shaper, hop, *extra):
    mixer = {"w": w, "b": bias}
    h = off.shape[0]
    if kind == "xcr":
        return fn_xcr(phase, f0, off, film_c, mixer, shaper, h, 16000.0, hop, *extra)
    return fn_xfull(phase, f0, off, film_c, mixer, w_out, shaper, h, 16000.0, hop, *extra)


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
@pytest.mark.parametrize("b,tc,hop,h", _X_SHAPES)
def test_x_kernel_matches_plain(cuda, params, kind, b, tc, hop, h):
    """The exciter-fused forward against its plain version on the same CUDA
    tensors, rtol 1e-4, atol 1e-5 (kernel 1's bar); odd Tc, hop 64 and 1,
    H = 2 and 128, a ragged last pass. One launch per call."""
    args = tuple(t.to(cuda) for t in _x_inputs(b, tc, hop, h, seed=tc + h))
    w = _shaper(params, cuda)
    counter = nf.bank_film_shaper_xcr if kind == "xcr" else nf.bank_newt_xfull
    before = counter.launches
    with torch.inference_mode():
        out = _x_call(kind, nf.bank_film_shaper_xcr, nf.bank_newt_xfull, *args, w, hop)
        ref = _x_call(kind, nf.bank_film_shaper_xcr_plain, nf.bank_newt_xfull_plain, *args, w, hop)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,tc,hop", [(2, 6, 16), (1, 37, 128), (3, 1, 3)])
def test_x_kernel_film_interpolation_bit_exact(cuda, params, b, tc, hop):
    """With gamma_out = 0 the xcr kernel's output is its in-register
    beta_out lerp (0*y + beta_out is exact), which must equal
    linear_upsample on the CPU bit for bit, as kernel 1's does; also where
    a group of 4 samples straddles two clips."""
    phase, f0, off, film_c, w, bias, _ = _x_inputs(b, tc, hop, seed=tc + hop)
    film_c[..., 128:192] = 0.0
    args = tuple(t.to(cuda) for t in (phase, f0, off, film_c, w, bias))
    with torch.inference_mode():
        out = _x_call("xcr", nf.bank_film_shaper_xcr, None, *args, None, _shaper(params, cuda), hop)
    ref = linear_upsample(film_c, tc * hop)[..., 192:]
    assert torch.equal(out.cpu(), ref)


def test_xfull_matches_xcr_and_the_output_mix(cuda, params):
    """xfull plus the output mix's bias against xcr followed by the (64, 1)
    mixer: rtol 1e-4, atol 1e-5 (the JAX suite's bar)."""
    phase, f0, off, film_c, w, bias, w_out = (t.to(cuda) for t in _x_inputs(2, 40, 128, seed=3))
    shaper = _shaper(params, cuda)
    b_out = torch.tensor([0.25], device=cuda)
    mixer = {"w": w, "b": bias}
    with torch.inference_mode():
        xfull = nf.bank_newt_xfull(phase, f0, off, film_c, mixer, w_out, shaper, 101, 16000.0, 128)
        xcr = nf.bank_film_shaper_xcr(phase, f0, off, film_c, mixer, shaper, 101, 16000.0, 128)
        ref = (xcr @ w_out[:, None] + b_out)[..., 0]
    np.testing.assert_allclose((xfull + b_out).cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
@pytest.mark.parametrize("b,tc,hop,h", _X_SHAPES)
def test_x_backward_kernel_matches_plain(cuda, params, kind, b, tc, hop, h):
    """d_film_c, the mixer's d_w and d_b, the 170 planes and (xfull) d_w_out
    of the CUDA backward against autograd through the plain version; one
    launch per call; two calls give the same bits."""
    phase, f0, off, film_c, w, bias, w_out = (t.to(cuda) for t in _x_inputs(b, tc, hop, h, seed=h))
    shaper = _shaper(params, cuda)
    packed = nf.pack_weights(shaper)
    shape = (b, tc * hop) if kind == "xfull" else (b, tc * hop, 64)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(tc)).to(cuda)
    wo = w_out if kind == "xfull" else None
    counter = nf.bank_film_shaper_xcr if kind == "xcr" else nf.bank_newt_xfull
    before = counter.bwd_launches
    args = (phase, f0, off, film_c, w, bias, packed, wo, h, 16000.0, hop, dy)
    out = nf._launch_backward_x(*args)
    again = nf._launch_backward_x(*args)
    mixer = {"w": w, "b": bias}
    if kind == "xcr":
        ref = nf.bank_film_shaper_xcr_grad_plain(phase, f0, off, film_c, mixer, shaper, h, 16000.0, hop, dy)
    else:
        ref = nf.bank_newt_xfull_grad_plain(phase, f0, off, film_c, mixer, w_out, shaper, h, 16000.0, hop, dy)
    torch.cuda.synchronize()
    assert counter.bwd_launches == before + 2 and len(out) == len(ref) == (5 if wo is not None else 4)
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    for o, r in zip(out, ref):
        _grad_close(o, r)


@pytest.mark.parametrize("kind", ["xcr", "xfull"])
def test_x_backward_kernel_is_deterministic(cuda, params, kind):
    """Lane sums, per-chunk mixer products and per-block partials in a fixed
    order, no atomics: two calls give the same bits at the training step's
    shape (8 clips of 4 s, H = 101)."""
    phase, f0, off, film_c, w, bias, w_out = (t.to(cuda) for t in _x_inputs(8, 500, 128, seed=9))
    packed = nf.pack_weights(_shaper(params, cuda))
    shape = (8, 500 * 128) if kind == "xfull" else (8, 500 * 128, 64)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(10)).to(cuda)
    args = (phase, f0, off, film_c, w, bias, packed, w_out if kind == "xfull" else None, 101,
            16000.0, 128, dy)
    first = nf._launch_backward_x(*args)
    second = nf._launch_backward_x(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_x_kernels_refuse_what_they_do_not_take(cuda, params):
    phase, f0, off, film_c, w, bias, w_out = (t.to(cuda) for t in _x_inputs(1, 4, 8))
    shaper = _shaper(params, cuda)
    mixer = {"w": w, "b": bias}
    with torch.inference_mode():
        with pytest.raises(TypeError):
            nf.bank_film_shaper_xcr(phase.double(), f0, off, film_c, mixer, shaper, 101, 16000.0, 8)
        with pytest.raises(ValueError):
            nf.bank_film_shaper_xcr(phase, f0, off, film_c.cpu(), mixer, shaper, 101, 16000.0, 8)
        with pytest.raises(ValueError):
            nf.bank_newt_xfull(phase, f0, off, film_c, {"w": w.T.contiguous().T, "b": bias}, w_out,
                               shaper, 101, 16000.0, 8)
        big = _x_inputs(1, 4, 8, h=129)
        with pytest.raises(ValueError):
            nf.bank_film_shaper_xcr(phase, f0, big[2].to(cuda), film_c, {"w": big[4].to(cuda), "b": bias},
                                    shaper, 129, 16000.0, 8)
    leaves = {"input_scale": shaper["input_scale"].clone().requires_grad_(), "layers": shaper["layers"]}
    with torch.no_grad():
        packed = nf.pack_weights(leaves)
    with pytest.raises(ValueError):
        nf.bank_film_shaper_xcr(phase, f0, off, film_c, mixer, leaves, 101, 16000.0, 8, packed=packed)


def _x_counts():
    return (nf.bank_film_shaper_xcr.launches, nf.bank_film_shaper_xcr.bwd_launches,
            nf.bank_newt_xfull.launches, nf.bank_newt_xfull.bwd_launches,
            nf.film_shaper_cr.launches, nf.film_shaper_cr.bwd_launches)


@pytest.mark.parametrize("fields,expect", [
    ({"fuse_exciter": True}, (1, 0, 0, 0, 0, 0)),
    ({"fuse_exciter": True, "fuse_out_mixer": True}, (0, 0, 1, 0, 0, 0)),
])
def test_fused_model_on_the_card(cuda, params, fields, expect):
    """A render with the fields set launches its exciter-fused kernel once
    and kernel 1 never; it agrees with the unfused render on the card
    (rtol 1e-4, atol 1e-5) and with the fused render on the CPU (the plain
    versions) within 1e-3 nRMS. (B, H) offsets take the unfused path."""
    rng = np.random.default_rng(13)
    tc = 64
    f0 = torch.from_numpy(np.geomspace(150, 1500, tc)[None].repeat(2, 0).astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((2, tc, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    outs = {}
    for name, dev, kw in (("fused", cuda, fields), ("unfused", cuda, {}), ("cpu", torch.device("cpu"), fields)):
        model = NeuralWaveshaping(**kw)
        model.load_params(params)
        model.to(dev)
        before = _x_counts()
        with torch.inference_mode():
            y = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev))
            if name == "fused":
                assert tuple(a - b for a, b in zip(_x_counts(), before)) == expect
                model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev)[None].repeat(2, 1),
                      noise=noise.to(dev))
                assert tuple(a - b for a, b in zip(_x_counts(), before)) == tuple(
                    e + (1 if i == 4 else 0) for i, e in enumerate(expect))
        outs[name] = y.cpu().numpy()
    np.testing.assert_allclose(outs["fused"], outs["unfused"], rtol=1e-4, atol=1e-5)
    assert np.sqrt(np.mean((outs["fused"] - outs["cpu"]) ** 2)) / np.sqrt(np.mean(outs["cpu"] ** 2)) <= 1e-3


@pytest.mark.parametrize("fields,expect", [
    ({"fuse_exciter": True}, (1, 1, 0, 0, 0, 0)),
    ({"fuse_exciter": True, "fuse_out_mixer": True}, (0, 0, 1, 1, 0, 0)),
])
def test_fused_training_step_on_the_card_matches_the_cpu(cuda, fields, expect):
    """One step's loss and gradients with the fields set, card against CPU,
    from the same seeded weights, batch, offsets and noise: the exciter-fused
    kernel pair launches once each and kernels 1-2 never; loss within 1e-4
    relative; every leaf nonzero, within 1e-3 normalised or by the float64
    witness rule of test_one_training_step_on_the_card_matches_the_cpu."""
    rng = np.random.default_rng(14)
    tc = 125
    f0 = np.geomspace(220.0, 880.0, tc).astype(np.float32)
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, 128)) / 16000
    audio = 0.1 * sum(np.sin(k * phase) / k for k in range(1, 11))
    batch = {
        "f0": torch.from_numpy(f0[None]),
        "control": torch.from_numpy(np.stack([(f0 - 440.0) / 200.0, np.zeros(tc)], -1)[None].astype(np.float32)),
        "audio": torch.from_numpy(audio[None].astype(np.float32)),
    }
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    base = NeuralWaveshaping(generator=torch.Generator().manual_seed(5), **fields)
    results = []
    for dev, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float32),
                       (torch.device("cpu"), torch.float64)):
        model = copy.deepcopy(base).to(dev, dtype)
        before = _x_counts()
        loss = compute_loss(model, {k: v.to(dev, dtype) for k, v in batch.items()},
                            phase_offset=offset.to(dev, dtype), noise=noise.to(dev, dtype))
        loss.backward()
        if dev.type == "cuda":
            assert tuple(a - b for a, b in zip(_x_counts(), before)) == expect
        results.append((float(loss.detach()),
                        {n: p.grad.cpu().double() for n, p in model.named_parameters()}))
    (card_loss, card), (cpu_loss, cpu), (_, exact) = results

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    for name, g in card.items():
        assert torch.count_nonzero(g) > 0, name
        if rel(g, cpu[name]) > 1e-3:
            assert rel(g, exact[name]) <= rel(cpu[name], exact[name]) + 1e-3, name


def _vibrato_tone(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 220.0 * 2 ** (np.sin(2 * np.pi * 0.2 * t) + 0.02 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    x = 0.3 * sum(np.sin(k * phase) / k for k in range(1, 6)) + 3e-3 * rng.standard_normal(t.shape)
    return torch.from_numpy(x.astype(np.float32))


def _decoded(fn):
    """fn's result and the bins of its last Viterbi decode."""
    from neural_waveshaping_synthesis_tpu_torch.models import crepe

    seen = []
    decode = crepe.viterbi_decode

    def spy(probs, *args, **kwargs):
        bins = decode(probs, *args, **kwargs)
        seen.append(bins.cpu().numpy())
        return bins

    crepe.viterbi_decode = spy
    try:
        return fn(), seen[-1]
    finally:
        crepe.viterbi_decode = decode


def _f0_card_vs_cpu(card, cpu, periodicity_atol):
    (f0_a, per_a), bins_a = card
    (f0_b, per_b), bins_b = cpu
    n = f0_a.shape[0]
    same = bins_a[:n] == bins_b[:n]
    assert same.mean() >= 0.99
    f0_a, per_a, f0_b, per_b = (t.cpu().numpy() for t in (f0_a, per_a, f0_b, per_b))
    np.testing.assert_allclose(f0_a[same], f0_b[same], rtol=1e-4)
    np.testing.assert_allclose(per_a[same], per_b[same], rtol=0, atol=periodicity_atol)


def test_pyin_on_the_card_matches_the_cpu(cuda):
    """pYIN (its betainc in float64, the Viterbi recursion and the
    doubling backtrack on the card): the same bins on >= 99 % of frames, f0
    rtol 1e-4 and periodicity atol 1e-4 where they agree."""
    from neural_waveshaping_synthesis_tpu_torch.data.preprocess import extract_f0_with_pyin

    x = _vibrato_tone(3, 1)
    _f0_card_vs_cpu(*(_decoded(lambda d=d: extract_f0_with_pyin(x.to(d))) for d in (cuda, "cpu")), 1e-4)


def test_crepe_predict_on_the_card_matches_the_cpu(cuda):
    """CREPE at tiny and full capacity with random weights (TF32 off inside
    ``predict``): the same bins on >= 99 % of frames, f0 rtol 1e-4 and
    periodicity atol 1e-3 where they agree."""
    from neural_waveshaping_synthesis_tpu_torch.models import crepe

    x = _vibrato_tone(1, 2)
    for capacity in ("tiny", "full"):
        torch.manual_seed(0)
        model = crepe.Crepe(capacity)
        runs = []
        for dev in (cuda, torch.device("cpu")):
            m = copy.deepcopy(model).to(dev)
            runs.append(_decoded(lambda: crepe.predict(m, x.to(dev), batch_size=64)))
        _f0_card_vs_cpu(*runs, 1e-3)


def test_extract_mfcc_on_the_card_matches_the_cpu(cuda):
    """MFCCs (cuFFT and the mel and DCT products on the card): atol 1e-2 on
    the dB-scale coefficients."""
    from neural_waveshaping_synthesis_tpu_torch.data.preprocess import extract_mfcc

    x = _vibrato_tone(2.5, 3)
    card = extract_mfcc(x.to(cuda))
    assert card.device.type == "cuda" and card.shape == (16, 1 + x.shape[0] // 128)
    np.testing.assert_allclose(card.cpu().numpy(), extract_mfcc(x).numpy(), rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# mixed precision on the exciter-fused path (kernels 7 and 8's bf16
# instances) and FastNEWT (kernel 4's bf16-x instance)
# ---------------------------------------------------------------------------
X_BF16_PAIRS = [(BF16, BF16, "_bf16"), (BF16, torch.float32, "_bf16_f32")]


def _x_bf16_counts():
    return {f"{kind}_{p}launches{s}": getattr(w, f"{p}launches{s}")
            for kind, w in (("xcr", nf.bank_film_shaper_xcr), ("xfull", nf.bank_newt_xfull))
            for p in ("", "bwd_") for s in ("", "_bf16", "_bf16_f32")}


def _x_moved(before, **expect):
    after = _x_bf16_counts()
    assert {k: after[k] - before[k] for k in after} == {k: expect.get(k, 0) for k in after}


def _x_bf16_inputs(b, tc, hop, h, mixer_dtype, film_dtype, cuda, seed):
    phase, f0, off, film_c, w, bias, w_out = _x_inputs(b, tc, hop, h, seed=seed)
    return (phase.to(cuda), f0.to(cuda), off.to(cuda), film_c.to(cuda, film_dtype),
            w.to(cuda, mixer_dtype), bias.to(cuda, mixer_dtype), w_out.to(cuda, mixer_dtype))


_X_BF16_SHAPES = [(2, 6, 16, 101), (1, 37, 128, 101), (2, 5, 33, 128), (3, 1, 3, 101), (1, 4, 300, 2),
                  (8, 500, 128, 101)]


@pytest.mark.parametrize("mixer_dtype,film_dtype,suffix", X_BF16_PAIRS)
@pytest.mark.parametrize("kind", ["xcr", "xfull"])
@pytest.mark.parametrize("b,tc,hop,h", _X_BF16_SHAPES)
def test_bf16_x_kernel_matches_plain(cuda, params, mixer_dtype, film_dtype, suffix, kind, b, tc, hop, h):
    """Kernel 7's bf16 instances ((bf16 mixer, bf16 FiLM) and (bf16 mixer,
    float32 FiLM)) vs the plain version (float32 between bf16 load and
    store, rounded once) within one bf16 ulp (rtol 2^-7, atol 1e-5); the
    output bf16; one launch of the instance and of nothing else; odd Tc, a
    partial lane group, groups across clips, H = 2 and 128, and a batch-8
    render's (8, 500 x 128)."""
    phase, f0, off, film_c, w, bias, w_out = _x_bf16_inputs(b, tc, hop, h, mixer_dtype, film_dtype, cuda,
                                                            seed=tc + h + 1)
    packed, tree = _bf16_planes(params, cuda)
    before = _x_bf16_counts()
    with torch.inference_mode():
        out = _x_call(kind, nf.bank_film_shaper_xcr, nf.bank_newt_xfull, phase, f0, off, film_c, w, bias,
                      w_out, tree, hop, packed)
    _x_moved(before, **{f"{kind}_launches{suffix}": 1})
    with torch.inference_mode():
        ref = _x_call(kind, nf.bank_film_shaper_xcr_plain, nf.bank_newt_xfull_plain, phase, f0, off, film_c,
                      w, bias, w_out, tree, hop)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == BF16
    _ulp_close(out, ref)


@pytest.mark.parametrize("mixer_dtype,film_dtype,suffix", X_BF16_PAIRS)
@pytest.mark.parametrize("kind", ["xcr", "xfull"])
@pytest.mark.parametrize("b,tc,hop,h", _X_BF16_SHAPES)
def test_bf16_x_backward_kernel_matches_plain(cuda, params, mixer_dtype, film_dtype, suffix, kind, b, tc,
                                              hop, h):
    """Kernel 8's bf16 instances vs autograd through the plain version:
    d_film in the FiLM's dtype, the mixer's d_w and d_b (and xfull's d_w_out)
    in bf16, each within one bf16 ulp beyond the float32 gradient bar (rtol
    1e-3 + 2^-7, atol 1e-3 * max|plain|), d_planes float32 at the float32
    bar; two calls bit-identical; two launches of the instance and of
    nothing else; at a training step's (8, 500 x 128) too."""
    phase, f0, off, film_c, w, bias, w_out = _x_bf16_inputs(b, tc, hop, h, mixer_dtype, film_dtype, cuda,
                                                            seed=h + 2)
    packed, tree = _bf16_planes(params, cuda)
    shape = (b, tc * hop) if kind == "xfull" else (b, tc * hop, 64)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(tc)).to(cuda, BF16)
    wo = w_out if kind == "xfull" else None
    args = (phase, f0, off, film_c, w, bias, packed, wo, h, 16000.0, hop, dy)
    before = _x_bf16_counts()
    out = nf._launch_backward_x(*args)
    again = nf._launch_backward_x(*args)
    _x_moved(before, **{f"{kind}_bwd_launches{suffix}": 2})
    mixer = {"w": w, "b": bias}
    if kind == "xcr":
        ref = nf.bank_film_shaper_xcr_grad_plain(phase, f0, off, film_c, mixer, tree, h, 16000.0, hop, dy)
    else:
        ref = nf.bank_newt_xfull_grad_plain(phase, f0, off, film_c, mixer, w_out, tree, h, 16000.0, hop, dy)
    torch.cuda.synchronize()
    dtypes = [film_dtype, BF16, BF16, torch.float32] + [BF16] * (kind == "xfull")
    assert [t.dtype for t in out] == [t.dtype for t in ref] == dtypes
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    for i, (o, r) in enumerate(zip(out, ref)):
        if i == 3:
            _grad_close(o, r)
        else:
            np.testing.assert_allclose(o.float().cpu().numpy(), r.float().cpu().numpy(),
                                       rtol=1e-3 + 2.0**-7, atol=1e-3 * float(r.float().abs().max()))


def test_bf16_x_kernels_take_odd_offset_views_and_refuse_mixed_pairs(cuda, params):
    """bf16 tensors are read 2 bytes at a time (the backward stages dy by
    plain loads): contiguous views at an odd bf16 offset give the aligned
    tensors' bits, forward and backward. A float32 mixer with a bf16 FiLM,
    a mixer whose b or w_out is not of w's dtype, and a cotangent not of the
    mixer's dtype are refused before a launch."""
    phase, f0, off, film_c, w, bias, w_out = _x_bf16_inputs(2, 6, 33, 101, BF16, BF16, cuda, seed=4)
    packed, tree = _bf16_planes(params, cuda)
    dy = torch.randn(2, 6 * 33, 64, generator=torch.Generator().manual_seed(2)).to(cuda, BF16)

    def odd(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 4 == 2
        return view

    for wo, g in ((None, dy), (w_out, dy[..., 0].contiguous())):
        args = (phase, f0, off, film_c, w, bias, packed, wo, 101, 16000.0, 33)
        moved = (phase, f0, off, odd(film_c), odd(w), odd(bias), packed, None if wo is None else odd(wo),
                 101, 16000.0, 33)
        with torch.inference_mode():
            assert torch.equal(nf._launch_forward_x(*args), nf._launch_forward_x(*moved))
        assert all(torch.equal(a, c) for a, c in zip(nf._launch_backward_x(*args, g),
                                                     nf._launch_backward_x(*moved, odd(g))))
    before = _x_bf16_counts()
    with torch.inference_mode():
        for mixer, wo, film in (({"w": w.float(), "b": bias.float()}, None, film_c),
                                ({"w": w, "b": bias.float()}, None, film_c),
                                ({"w": w, "b": bias}, w_out.float(), film_c)):
            with pytest.raises(TypeError, match="mixer"):
                _x_call("xcr" if wo is None else "xfull", nf.bank_film_shaper_xcr, nf.bank_newt_xfull,
                        phase, f0, off, film, mixer["w"], mixer["b"], wo, tree, 33, packed)
    with pytest.raises(ValueError, match="dy must be"):
        nf._launch_backward_x(phase, f0, off, film_c, w, bias, packed, None, 101, 16000.0, 33, dy.float())
    _x_moved(before)


@pytest.mark.parametrize("fields,kind", [({"fuse_exciter": True}, "xcr"),
                                         ({"fuse_exciter": True, "fuse_out_mixer": True}, "xfull")])
@pytest.mark.parametrize("film_f32", [False, True])
def test_bf16_fused_model_on_the_card(cuda, params, fields, kind, film_f32):
    """A bf16 render with the fields set launches its kernel's (bf16 mixer,
    bf16 FiLM) instance once, or with NEWT.cr_film_f32 its (bf16, f32)
    instance, and nothing else of kernels 7-8; float32 out, 1e-3 to 0.05
    nRMS from the float32 render on the card (it computes in bf16) and less
    than half that from the CPU's bf16 render (its plain versions: 2.5e-3
    against ≈ 8.7e-3 on this input when written; the bf16 FiLM MLP's
    roundings, placed apart by cuBLAS and the CPU, move the shaper's input by
    bf16 ulps). A training step launches the matching backward instance
    once; every gradient float32, finite and nonzero."""
    rng = np.random.default_rng(15)
    tc = 64
    f0 = torch.from_numpy(np.geomspace(150, 1500, tc)[None].repeat(2, 0).astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((2, tc, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    suffix = "_bf16_f32" if film_f32 else "_bf16"
    outs = {}
    for name, dev, cd in (("bf16", cuda, "bfloat16"), ("cpu", torch.device("cpu"), "bfloat16"),
                          ("f32", cuda, "float32")):
        model = NeuralWaveshaping(compute_dtype=cd, **fields)
        model.load_params(params)
        model.newt.cr_film_f32 = film_f32
        model.to(dev)
        before = _x_bf16_counts()
        with torch.inference_mode():
            y = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev))
        if name == "bf16":
            _x_moved(before, **{f"{kind}_launches{suffix}": 1})
            before = _x_bf16_counts()
            loss = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev),
                         noise=noise.to(dev)).square().mean()
            loss.backward()
            _x_moved(before, **{f"{kind}_launches{suffix}": 1, f"{kind}_bwd_launches{suffix}": 1})
            for n, t in model.named_parameters():
                assert t.grad.dtype == torch.float32 and torch.isfinite(t.grad).all(), n
                assert torch.count_nonzero(t.grad) > 0, n
        assert y.dtype == torch.float32
        outs[name] = y.cpu().numpy()

    def nrms(a, b):
        return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2))

    vs_f32 = nrms(outs["bf16"], outs["f32"])
    assert 1e-3 < vs_f32 < 0.05, vs_f32
    assert nrms(outs["bf16"], outs["cpu"]) < 0.5 * vs_f32, (nrms(outs["bf16"], outs["cpu"]), vs_f32)


@pytest.mark.parametrize("s,shape,offset,path", [
    (4096, (2, 1000, 64), 0, "vec4"), (4096, (2, 1000, 64), 1, "scalar"), (4096, (2, 1000, 64), 2, "scalar"),
    (4096, (3, 333, 64), 4, "vec4"), (256, (3, 333, 64), 0, "vec4"), (2, (1, 7, 5), 0, "scalar")])
def test_bf16_lookup_kernel_matches_plain_bit_for_bit(cuda, s, shape, offset, path):
    """Kernel 4's bf16-x instance against the plain version on the same CUDA
    tensors, bit for bit: the index in bf16 (each operation rounded), the
    interpolation float32, the output float32; x over [-4, 4] with both edges
    crossed. A view at a bf16 offset of 1 or 2 (not 8-B aligned) takes the
    scalar path, 4 (8 B) the vec4 path. One launch of the bf16 instance per
    call and none of the float32 one."""
    rng = np.random.default_rng(s + offset)
    table = torch.from_numpy(rng.standard_normal((s, shape[-1])).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.uniform(-4, 4, shape).astype(np.float32)).to(cuda, BF16)
    x = torch.empty(x.numel() + offset, dtype=BF16, device=cuda)[offset:].view(shape).copy_(x)
    assert fast_newt._lookup_path(x, torch.empty(shape, device=cuda)) == path
    before = (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16)
    with torch.inference_mode():
        out = fast_newt.fast_newt_lookup(table, x)
        ref = fast_newt.fast_newt_lookup_plain(table, x)
    torch.cuda.synchronize()
    assert (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16) == (
        before[0], before[1] + 1)
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    assert not torch.equal(out, fast_newt.fast_newt_lookup_plain(table, x.float()))  # the bf16 index


def test_bf16_fast_newt_model_on_the_card_matches_the_cpu(cuda, params):
    """A bf16 model with the baked table on the card launches the lookup's
    bf16 instance once (and not the float32 one, nor kernel 1), renders
    float32 within 5e-3 nRMS of the CPU's bf16 render (its plain version;
    the bf16 index moves in steps of up to 16 bins, so the bf16 FiLM MLP's
    roundings, placed apart by cuBLAS and the CPU, reach the output as whole
    bins: chip_smoke.py's bar) and 1e-3 to 0.05 from the float32 FastNEWT
    render on the card."""
    rng = np.random.default_rng(16)
    tc = 64
    f0 = torch.from_numpy(np.geomspace(150, 600, tc)[None].astype(np.float32))
    control = torch.from_numpy(rng.standard_normal((1, tc, 2)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-np.pi, np.pi, 101).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0, 1, tc * 128 - 1).astype(np.float32))
    outs = {}
    for name, dev, cd in (("bf16", cuda, "bfloat16"), ("cpu", torch.device("cpu"), "bfloat16"),
                          ("f32", cuda, "float32")):
        model = NeuralWaveshaping(compute_dtype=cd)
        model.load_params(params)
        model.to(dev)
        before = (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16,
                  nf.film_shaper_cr.launches_bf16)
        with torch.inference_mode():
            table = model.newt.bake_lookup_table()
            y = model(f0.to(dev), control.to(dev), phase_offset=offset.to(dev), noise=noise.to(dev),
                      lookup_table=table)
        if name == "bf16":
            assert (fast_newt.fast_newt_lookup.launches, fast_newt.fast_newt_lookup.launches_bf16,
                    nf.film_shaper_cr.launches_bf16) == (before[0], before[1] + 1, before[2])
        assert y.dtype == torch.float32
        outs[name] = y.cpu().numpy()

    def nrms(a, b):
        return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2))

    assert nrms(outs["bf16"], outs["cpu"]) < 5e-3, nrms(outs["bf16"], outs["cpu"])
    assert 1e-3 < nrms(outs["bf16"], outs["f32"]) < 0.05, nrms(outs["bf16"], outs["f32"])
