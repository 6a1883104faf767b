"""The control-rate FiLM -> shaper -> FiLM module of the port.

On the CPU: the plain version and its backward against the JAX TPU
kernel ``film_shaper_fused_cr`` and its backward ``_fused_bwd_cr`` (run
by the JAX package in interpret mode on the CPU), the weight-plane
packing both ways, the wrapper's CPU dispatch, the Hopper gate, the
launch checks and NEWT's dispatch and packing. The card's own cases (the CUDA kernel against
the plain version) are in tests/test_torch_cuda.py, which imports no JAX
so that it runs on a machine with a card and no JAX.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_waveshaping_synthesis_tpu.kernels import newt_fused as jnf
from neural_waveshaping_synthesis_tpu.models import NEWT as JNEWT
from neural_waveshaping_synthesis_tpu_torch.convert import params_from_jax
from neural_waveshaping_synthesis_tpu_torch.kernels import newt_fused as nf
from neural_waveshaping_synthesis_tpu_torch.models import NEWT, TrainableNonlinearity


@pytest.fixture(scope="module")
def jax_newt():
    newt = JNEWT()
    return newt, newt.init(jax.random.PRNGKey(2))


def _inputs(b, tc, hop, seed=7):
    rng = np.random.default_rng(seed)
    exciter = (rng.standard_normal((b, tc * hop, 64)) * 0.5).astype(np.float32)
    film_c = rng.standard_normal((b, tc, 256)).astype(np.float32)
    return exciter, film_c


def _shaper_params(p):
    return params_from_jax(p["shaping_fn"])


@pytest.mark.parametrize("tc", [4, 6])
@pytest.mark.parametrize("hop", [8, 16])
def test_plain_matches_jax_cr_kernel(jax_newt, tc, hop):
    """film_shaper_cr_plain vs the JAX kernel in interpret mode, at the
    JAX suite's kernel-vs-chain tolerance rtol=1e-4, atol=1e-5 (the two
    differ only by where each compiler contracts multiply-adds)."""
    newt, p = jax_newt
    exciter, film_c = _inputs(2, tc, hop)
    ref = jnf.film_shaper_fused_cr(
        jnp.asarray(exciter), jnp.asarray(film_c), jnf.pack_weights_fl(p["shaping_fn"]), hop
    )
    out = nf.film_shaper_cr_plain(
        torch.from_numpy(exciter), torch.from_numpy(film_c), _shaper_params(p), hop
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_pack_weights_matches_jax(jax_newt):
    """The kernel's (170, 64) weight planes are the JAX pack_weights
    planes stacked in order, bit for bit."""
    _, p = jax_newt
    ref = np.concatenate([np.asarray(w) for w in jnf.pack_weights(p["shaping_fn"])], axis=0)
    out = nf.pack_weights(_shaper_params(p))
    assert out.shape == (170, 64) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)


@torch.no_grad()
def test_newt_packs_the_shaper_once_per_parameter_change(jax_newt):
    """Without gradients NEWT keeps the kernel's packed planes between
    forwards and packs again after its shaper parameters are loaded anew
    or written in place."""
    _, p = jax_newt
    newt = NEWT()
    newt.load_params(params_from_jax(p))
    packed = newt._packed_shaper()
    assert newt._packed_shaper() is packed
    assert torch.equal(packed, nf.pack_weights(_shaper_params(p)))
    newt.shaping_fn.input_scale.mul_(2.0)
    repacked = newt._packed_shaper()
    assert repacked is not packed
    assert torch.equal(repacked[0], 2.0 * packed[0]) and torch.equal(repacked[1:], packed[1:])
    newt.load_params(params_from_jax(p))
    assert torch.equal(newt._packed_shaper(), packed)


def test_wrapper_dispatches_cpu_tensors_to_plain(jax_newt):
    _, p = jax_newt
    exciter, film_c = _inputs(2, 5, 12, seed=3)
    args = (torch.from_numpy(exciter), torch.from_numpy(film_c), _shaper_params(p), 12)
    before = nf.film_shaper_cr.launches
    out = nf.film_shaper_cr(*args)
    assert nf.film_shaper_cr.launches == before  # no kernel launched
    assert torch.equal(out, nf.film_shaper_cr_plain(*args))


def test_plain_rejects_wrong_hop(jax_newt):
    _, p = jax_newt
    exciter, film_c = _inputs(1, 4, 8)
    with pytest.raises(ValueError):
        nf.film_shaper_cr_plain(
            torch.from_numpy(exciter), torch.from_numpy(film_c), _shaper_params(p), 16
        )


def test_hopper_gate():
    """Shipped architecture + integer hop. Hops the TPU gate refused (not
    a multiple of 8, above 256) and odd control lengths are accepted."""
    shaper = TrainableNonlinearity(64, 8, depth=4)
    assert nf.supports_cr(shaper, 128 * 500, 500)
    assert nf.supports_cr(shaper, 128 * 37, 37)  # odd Tc
    assert nf.supports_cr(shaper, 10 * 4, 4)  # hop 10
    assert nf.supports_cr(shaper, 512 * 8, 8)  # hop 512
    assert nf.supports_cr(shaper, 7, 7)  # hop 1
    assert not nf.supports_cr(shaper, 130, 4)  # non-integer hop
    assert not nf.supports_cr(shaper, 0, 0)
    assert not nf.supports_cr(TrainableNonlinearity(64, 8, depth=3), 128, 1)
    assert not nf.supports_cr(TrainableNonlinearity(32, 8, depth=4), 128, 1)
    relu = TrainableNonlinearity(64, 8, depth=4, nonlinearity="relu")
    assert not nf.supports_cr(relu, 128, 1)


@pytest.mark.parametrize("segments,resident,blocks", [
    (8 * 500, 264, 264),  # the training step on an H100: every block strides
    (21, 264, 21),  # fewer segments than the card holds: one block each
    (1, 264, 1),
    (264, 264, 264),
])
def test_backward_grid_is_one_block_per_segment_at_most_resident(segments, resident, blocks):
    """The cr backward's grid: one block per control segment, capped at
    the blocks resident at once (each block then strides over segments),
    and never a block without a segment, whose weight partial would be
    zeros summed for nothing."""
    assert nf._segment_blocks(segments, resident) == blocks


@pytest.mark.parametrize("samples,resident,blocks", [
    (8 * 64000, 132, 132),  # the full_lane training step on an H100: every block strides
    (37, 132, 2),  # a ragged last chunk
    (1, 132, 1),
    (132 * 32 + 1, 132, 132),  # one chunk more than the card holds: block 0 takes two
])
def test_fl_backward_grid_is_one_block_per_chunk_at_most_resident(samples, resident, blocks):
    """The audio-rate backward's grid: one block per 32-sample chunk of the
    flat sample index, capped at the blocks resident at once (each block
    then strides over chunks), and never a block without a chunk."""
    assert nf._chunk_blocks(samples, resident) == blocks


@pytest.mark.parametrize("b,tc,blocks", [
    (8, 500, 132),  # the training step on an H100, one 16-warp block per SM
    (1, 37, 37),  # odd B*Tc: no block holds two segments at once
    (3, 1, 3),
    (7, 19, 132),  # 133 segments, one more than the card holds: block 0 takes two
])
def test_exciter_fused_backward_grid_is_one_block_per_segment(monkeypatch, b, tc, blocks):
    """The exciter-fused backward's launcher walks control segments as the
    cr backward's does (lanes are a segment's samples): one block per
    segment, capped at the blocks resident at once (132 here), no longer one
    block per two segments. The library is a stand-in that records the grid
    it is handed, so the launcher runs here on CPU tensors."""
    launched = []

    class Lib:
        def newt_fused_x_backward(self, *args):
            launched.append(args)
            return 0

    monkeypatch.setattr(nf, "_lib", lambda *a, **k: Lib())
    monkeypatch.setattr(nf, "_resident_blocks", lambda lib, query, device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=0))
    hop, h = 2, 101
    phase = torch.zeros(b, tc * hop)
    args = (phase, phase.clone(), torch.zeros(h), torch.zeros(b, tc, 256), torch.zeros(h, 64),
            torch.zeros(64), torch.zeros(170, 64), torch.zeros(64), h, 16000.0, hop,
            torch.zeros(b, tc * hop))
    grads = nf._launch_backward_x(*args)
    assert len(launched) == 1 and len(grads) == 5
    assert launched[0][13:18] == (b, tc * hop, tc, h, blocks)  # B, Ta, Tc, H, blocks


@pytest.mark.parametrize("b,tc,hop,blocks", [
    (8, 512, 128, 264),  # a batch-8 render on an H100, two blocks per SM: every block strides
    (2, 8, 16, 11),  # 256 samples, 24 a block pass
    (1, 37, 5, 8),  # 185 samples: a ragged last pass
    (3, 1, 3, 1),  # 9 samples, groups across clips: one block
])
def test_exciter_fused_forward_grid_is_one_block_per_pass(monkeypatch, b, tc, hop, blocks):
    """The exciter-fused forward's launcher: one block per pass of 24
    samples (six 64-thread groups of 4 consecutive samples), capped at the
    blocks resident at once (264 here), so no block is launched without a
    group. The library is a stand-in that records the grid it is handed."""
    launched = []

    class Lib:
        def newt_fused_x_forward(self, *args):
            launched.append(args)
            return 0

    monkeypatch.setattr(nf, "_lib", lambda *a, **k: Lib())
    monkeypatch.setattr(nf, "_resident_blocks", lambda lib, query, device: 264)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=0))
    h = 101
    phase = torch.zeros(b, tc * hop)
    out = nf._launch_forward_x(phase, phase.clone(), torch.zeros(h), torch.zeros(b, tc, 256),
                               torch.zeros(h, 64), torch.zeros(64), torch.zeros(170, 64), None, h,
                               16000.0, hop)
    assert len(launched) == 1 and out.shape == (b, tc * hop, 64)
    # B*Ta, Ta, Tc, hop, H, blocks
    assert launched[0][9:15] == (b * tc * hop, tc * hop, tc, hop, h, blocks)


@pytest.mark.parametrize(
    "case",
    ["dtype", "channels", "film_width", "batch", "hop", "contiguity", "weights", "device"],
)
def test_launch_checks_refuse_what_the_kernel_does_not_take(case):
    """The checks run before any launch; here on CPU tensors, which is
    where they can be exercised without a card."""
    exc = torch.zeros(2, 4 * 8, 64)
    film_c = torch.zeros(2, 4, 256)
    w = torch.zeros(170, 64)
    hop = 8
    if case == "dtype":
        exc = exc.double()
    elif case == "channels":
        exc = torch.zeros(2, 32, 32)
    elif case == "film_width":
        film_c = torch.zeros(2, 4, 128)
    elif case == "batch":
        film_c = torch.zeros(1, 4, 256)
    elif case == "hop":
        hop = 7
    elif case == "contiguity":
        exc = torch.zeros(2, 64, 32).transpose(1, 2)
    elif case == "weights":
        w = torch.zeros(169, 64)
    elif case == "device":
        film_c = film_c.to("meta")
    with pytest.raises((ValueError, TypeError)):
        nf._check(exc, film_c, w, hop)


def test_newt_dispatch_on_cpu_matches_jax_chain(jax_newt):
    """NEWT(fused="cr") on CPU runs the plain chain (JAX's "cr" runs its
    XLA chain off the TPU): same parameters, same inputs, 1e-4/1e-5."""
    newt, p = jax_newt
    rng = np.random.default_rng(11)
    exciter = (rng.standard_normal((2, 15 * 16, 64)) * 0.5).astype(np.float32)
    emb = rng.standard_normal((2, 15, 128)).astype(np.float32)
    ref = np.asarray(newt.apply(p, jnp.asarray(exciter), jnp.asarray(emb), fused="cr"))
    port = NEWT()
    port.load_params(params_from_jax(p))
    with torch.no_grad():
        out = port(torch.from_numpy(exciter), torch.from_numpy(emb))
        chain = port(torch.from_numpy(exciter), torch.from_numpy(emb), fused=False)
    assert torch.equal(out, chain)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", ["fl", "full_lane", True])
def test_newt_unported_options_raise(fused):
    """The audio-rate options, once unported, now run: on the CPU, at
    construction and per call, they compute the plain chain (their parity
    with JAX is in tests/test_torch_newt_fl.py). Only a value that is not
    a JAX ``fused`` spelling raises."""
    g = torch.Generator().manual_seed(1)
    newt = NEWT(fused=fused, generator=g)
    exc, emb = torch.randn(1, 16, 64, generator=g), torch.randn(1, 2, 128, generator=g)
    with torch.no_grad():
        out = newt(exc, emb)
        assert torch.equal(out, newt(exc, emb, fused=False))
        assert torch.equal(out, NEWT(generator=torch.Generator().manual_seed(1))(exc, emb, fused=fused))
    with pytest.raises(ValueError):
        NEWT(fused=str(fused) + "_unknown")
    with pytest.raises(ValueError):
        newt(exc, emb, fused="half_lane")


def test_newt_lookup_table_and_remat_raise():
    """Neither raises any more. remat_shaper runs the plain chain with the
    shaper bank under torch.utils.checkpoint (its gradients against JAX
    are in tests/test_torch_newt_fl.py); a FastNEWT lookup table replaces
    the shaper bank whatever ``fused`` says (its parity with JAX is in
    tests/test_torch_timbre_transfer.py)."""
    remat = NEWT(remat_shaper=True, generator=torch.Generator().manual_seed(2))
    plain = NEWT(generator=torch.Generator().manual_seed(2))
    x, e = torch.randn(1, 16, 64), torch.randn(1, 2, 128)
    assert torch.equal(remat(x, e), plain(x, e))
    g = torch.Generator().manual_seed(0)
    newt = NEWT(generator=g)
    exc, emb = torch.randn(1, 16, 64, generator=g), torch.randn(1, 2, 128, generator=g)
    table = torch.randn(8, 64, generator=g)
    with torch.no_grad():
        out = newt(exc, emb, lookup_table=table)
        assert out.shape == (1, 16, 1) and torch.isfinite(out).all()
        assert torch.equal(out, newt(exc, emb, lookup_table=table, fused=False))
        assert not torch.equal(out, newt(exc, emb))


# ---------------------------------------------------------------------------
# the backward (JAX _fused_bwd_cr) and the packing that carries it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tc", [4, 6])
@pytest.mark.parametrize("hop", [8, 16])
def test_plain_backward_matches_jax_cr_kernel_grad(jax_newt, tc, hop):
    """film_shaper_cr_grad_plain (d_exciter, d_film_c, the 170 weight
    planes unpacked to the shaper tree) against jax.grad through the JAX
    kernel in interpret mode, whose backward is _fused_bwd_cr, at the JAX
    suite's gradient bar rtol=1e-3, atol=1e-2 (tests/test_newt_fused.py
    test_cr_gradients_match_autodiff)."""
    _, p = jax_newt
    exciter, film_c = _inputs(2, tc, hop, seed=tc + hop)
    dy = np.random.default_rng(hop).standard_normal(exciter.shape).astype(np.float32)

    def loss(exc, f, sp):
        out = jnf.film_shaper_fused_cr(exc, f, jnf.pack_weights_fl(sp), hop)
        return jnp.sum(out * dy)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(exciter), jnp.asarray(film_c), p["shaping_fn"]
    )
    d_exc, d_film, d_planes = nf.film_shaper_cr_grad_plain(
        torch.from_numpy(exciter), torch.from_numpy(film_c), _shaper_params(p), hop,
        torch.from_numpy(dy),
    )
    ours = [d_exc, d_film] + jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), nf.unpack_weight_grads(d_planes))
    )
    theirs = jax.tree_util.tree_leaves(ref)
    assert len(ours) == len(theirs) == 11
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-2)


def test_plain_backward_clamp_gradients_match_jax(jax_newt):
    """The head and tail clamps' transpose: a loss that reads only the
    first half-hop and the last hop folds its FiLM cotangents onto frames
    0 and Tc-1 (tests/test_newt_fused.py test_cr_head_and_tail_clamp_gradients,
    rtol=1e-4, atol=1e-5)."""
    _, p = jax_newt
    hop = 16
    exciter, film_c = _inputs(2, 6, hop, seed=12)

    def jloss(f):
        out = jnf.film_shaper_fused_cr(
            jnp.asarray(exciter), f, jnf.pack_weights_fl(p["shaping_fn"]), hop
        )
        return jnp.sum(out[:, : hop // 2] ** 2) + jnp.sum(out[:, -hop:] ** 2)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(film_c)))
    f = torch.from_numpy(film_c).requires_grad_()
    out = nf.film_shaper_cr(torch.from_numpy(exciter), f, _shaper_params(p), hop)
    (out[:, : hop // 2].square().sum() + out[:, -hop:].square().sum()).backward()
    np.testing.assert_allclose(f.grad.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert np.all(ref[:, 2:-2] == 0) and np.any(ref[:, 0] != 0) and np.any(ref[:, -1] != 0)


def test_unpack_weight_grads_matches_jax():
    """(170, 64) planes -> the shaper tree, bit for bit against the JAX
    unpack_weight_grads, and the inverse of pack_weights."""
    planes = np.random.default_rng(13).standard_normal((170, 64)).astype(np.float32)
    splits = np.cumsum([1, 8, 8, 64, 8, 64, 8, 8])
    ref = jnf.unpack_weight_grads(tuple(jnp.asarray(a) for a in np.split(planes, splits)))
    ours = nf.unpack_weight_grads(torch.from_numpy(planes))
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), ours)),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert torch.equal(nf.pack_weights(ours), torch.from_numpy(planes))


def test_newt_packs_with_autograd_when_a_gradient_is_needed(jax_newt):
    """With grad enabled the packed planes are made anew on every call and
    carry a grad_fn back to the 9 shaper leaves (a cached pack made under
    no_grad would give them no gradient, silently); without grad the pack
    stays cached."""
    _, p = jax_newt
    newt = NEWT()
    newt.load_params(params_from_jax(p))
    packed = newt._packed_shaper()
    assert packed.grad_fn is not None and newt._packed_shaper() is not packed
    packed.sum().backward()
    leaves = list(newt.shaping_fn.parameters())
    assert len(leaves) == 9 and all(t.grad is not None and torch.all(t.grad == 1) for t in leaves)
    with torch.no_grad():
        cached = newt._packed_shaper()
        assert cached.grad_fn is None and newt._packed_shaper() is cached
    assert torch.equal(cached, packed.detach())


def test_newt_full_lane_cr_behaves_as_cr(jax_newt):
    """The JAX training recipe's spelling is accepted and computes what
    "cr" computes, with gradients (on the CPU, the plain chain)."""
    _, p = jax_newt
    rng = np.random.default_rng(14)
    exciter = torch.from_numpy((rng.standard_normal((1, 6 * 16, 64)) * 0.5).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((1, 6, 128)).astype(np.float32))
    outs = []
    for fused in ("full_lane_cr", "cr"):
        newt = NEWT(fused=fused)
        newt.load_params(params_from_jax(p))
        out = newt(exciter, emb)
        out.square().sum().backward()
        outs.append((out.detach(), [t.grad for t in newt.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
