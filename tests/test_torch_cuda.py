"""The port on the card: the CUDA kernel against its plain version, and
the model on the card against the model on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it runs where the card is and JAX is not:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the parity tests.)
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample

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


@pytest.mark.parametrize("b,tc,hop", [(2, 6, 16), (1, 37, 128), (2, 5, 10), (1, 3, 1), (3, 1, 64)])
def test_kernel_matches_plain(cuda, params, b, tc, hop):
    """Kernel vs plain version on the same CUDA tensors, rtol=1e-4,
    atol=1e-5 (the JAX suite's kernel-vs-chain tolerance); odd Tc and
    hops the TPU gate refused included. One launch per call."""
    exc, film_c = (t.to(cuda) for t in _inputs(b, tc, hop))
    w = _shaper(params, cuda)
    before = nf.film_shaper_cr.launches
    with torch.inference_mode():
        out = nf.film_shaper_cr(exc, film_c, w, hop)
        ref = nf.film_shaper_cr_plain(exc, film_c, w, hop)
    torch.cuda.synchronize()
    assert nf.film_shaper_cr.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tc,hop", [(6, 16), (37, 128), (5, 5)])
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
    with pytest.raises(NotImplementedError):  # no backward kernel yet
        nf.film_shaper_cr(exc.requires_grad_(), film_c, w, 8)


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


def test_newt_counts_and_warns_when_the_card_runs_the_chain(cuda):
    """fused="cr" with a shaper the kernel does not take runs the plain
    chain on the card, as JAX's "cr" does, but not silently."""
    newt = NEWT(shaping_fn_depth=3).to(cuda)
    exc = torch.zeros(1, 4 * 8, 64, device=cuda)
    emb = torch.zeros(1, 4, 128, device=cuda)
    before, launches = NEWT.cuda_chain_runs, nf.film_shaper_cr.launches
    with torch.inference_mode(), pytest.warns(UserWarning, match="plain chain"):
        newt(exc, emb)
    assert NEWT.cuda_chain_runs == before + 1
    assert nf.film_shaper_cr.launches == launches


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
