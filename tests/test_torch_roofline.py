"""Kernel 9 (the roofline's dependent chains) and
``scripts/torch_roofline_shaper.py`` on the CPU, against the JAX package's
``scripts/roofline_shaper.py``.

The JAX script's ``pallas_chain`` is nested inside its ``main_impl`` (it
needs the chip's backend to be built), so it cannot be imported: the test
rebuilds it from the script's source, the same kernel body over the same
``BlockSpec`` tiling, and runs it in interpret mode on the CPU, together with
the script's XLA chains (``_fast_sin_poly``). The port's plain versions are
held against both at rtol 1e-5: the same float32 operations in the same
order (XLA may contract a multiply-add, which the chain's contraction keeps
within ~50 ulp).

The chains run on an x0 drawn apart from x: the JAX script's timing inputs
(x0 = 0.01 x for the fma chain) make x the chain's fixed point
(x * 0.99 + 0.01 x = x), where every step count gives x back. Each test
also holds a chain of K - 1 steps to fail the same bar, so that the
comparison sees the step count."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from neural_waveshaping_synthesis_tpu.kernels.newt_fused import _psin
from neural_waveshaping_synthesis_tpu.ops.fastmath import _fast_sin_poly
from neural_waveshaping_synthesis_tpu_torch.kernels import _build, launch_counts, roofline

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
N = 4096  # elements of each chain
K_FMA, K_SIN, A = 256, 32, 0.99  # the JAX script's
# the chains' absolute bar beside rtol 1e-5, for the results near 0: XLA
# may contract a multiply-add into one FMA where torch rounds twice, and the
# chain carries that rounding (5.2e-7 at most when written)
CHAIN_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's tests, restored after: the test
    workers share the machine's cores, and torch's default of a thread per
    core in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pallas_chain(chain_len, kind, lanes, rows):
    """The JAX script's ``pallas_chain`` (``roofline_shaper.py:171-190``),
    its tile the whole (rows, lanes) array, in interpret mode."""
    def kernel(x_ref, x0_ref, o_ref):
        x, x0 = x_ref[:], x0_ref[:]
        for _ in range(chain_len):
            x = x * A + x0 if kind == "fma" else _psin(x) + x0
        o_ref[:] = x

    def call(x, x0):
        spec = pl.BlockSpec((rows, lanes), lambda i: (i, 0))
        return pl.pallas_call(kernel, grid=(1,), in_specs=[spec, spec], out_specs=spec,
                              out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                              interpret=True)(x, x0)

    return call


def _inputs(lanes, seed=0):
    """x ~ N(0, 1) and x0 = 0.01 N(0, 1) drawn apart, float32 (n/lanes, lanes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N // lanes, lanes)).astype(np.float32)
    return x, (0.01 * rng.standard_normal((N // lanes, lanes))).astype(np.float32)


def _fails(out, ref, rtol, atol=0.0):
    return not np.allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("lanes", [128, 64])
def test_fma_chain_plain_matches_jax(lanes):
    """The serial chain against the JAX script's Pallas kernel (interpret
    mode) and its XLA chain ``fma_serial``, at 128 and 64 lanes."""
    x, x0 = _inputs(lanes)
    out = roofline.fma_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_FMA, A).numpy()
    ref = np.asarray(_pallas_chain(K_FMA, "fma", lanes, N // lanes)(jnp.asarray(x),
                                                                    jnp.asarray(x0)))

    @jax.jit
    def xla(xx, xx0):
        for _ in range(K_FMA):
            xx = xx * A + xx0
        return xx

    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=CHAIN_ATOL)
    np.testing.assert_allclose(out, np.asarray(xla(x, x0)), rtol=1e-5, atol=CHAIN_ATOL)
    short = roofline.fma_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_FMA - 1, A)
    assert _fails(short.numpy(), ref, 1e-5, CHAIN_ATOL)
    # the wrapper on a CPU tensor is the plain version, and no counter moves
    before = launch_counts()
    again = roofline.fma_chain(torch.from_numpy(x), torch.from_numpy(x0), K_FMA, A)
    assert np.array_equal(again.numpy(), out) and launch_counts() == before


def test_fma_chain_ilp4_plain_matches_jax():
    """Four chains from x, x/2, x/4, x/8 (the JAX script's ``fma_ilp4``),
    summed per element in order."""
    x, x0 = _inputs(128, seed=1)
    out = roofline.fma_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_FMA, A,
                                   ilp=4).numpy()

    @jax.jit
    def xla(xx, xx0):
        xs = [xx, xx * 0.5, xx * 0.25, xx * 0.125]
        for _ in range(K_FMA):
            xs = [c * A + xx0 for c in xs]
        return ((xs[0] + xs[1]) + xs[2]) + xs[3]

    ref = np.asarray(xla(x, x0))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=CHAIN_ATOL)
    short = roofline.fma_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_FMA - 1, A, ilp=4)
    assert _fails(short.numpy(), ref, 1e-5, CHAIN_ATOL)
    assert np.array_equal(
        roofline.fma_chain(torch.from_numpy(x), torch.from_numpy(x0), K_FMA, A, ilp=4).numpy(), out)


def test_psin_chain_plain_matches_jax():
    """The sine chain against the Pallas kernel's inlined ``_psin``
    (``kernels/newt_fused.py:41``) in interpret mode and against the XLA
    chain on ``_fast_sin_poly`` (``ops/fastmath.py:76``), the JAX script's
    ``psin128``."""
    x, x0 = _inputs(128, seed=2)
    out = roofline.psin_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_SIN).numpy()
    ref = np.asarray(_pallas_chain(K_SIN, "sin", 128, N // 128)(jnp.asarray(x), jnp.asarray(x0)))

    @jax.jit
    def xla(xx, xx0):
        for _ in range(K_SIN):
            xx = _fast_sin_poly(xx) + xx0
        return xx

    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=CHAIN_ATOL)
    np.testing.assert_allclose(out, np.asarray(xla(x, x0)), rtol=1e-5, atol=CHAIN_ATOL)
    short = roofline.psin_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_SIN - 1)
    assert _fails(short.numpy(), ref, 1e-5, CHAIN_ATOL)
    assert np.array_equal(
        roofline.psin_chain(torch.from_numpy(x), torch.from_numpy(x0), K_SIN).numpy(), out)


def test_psin_chain_ilp4_plain_matches_jax():
    """Four sine chains from x, x/2, x/4, x/8, summed per element in order,
    against the same chains built on ``_fast_sin_poly``: the sine
    counterpart of ``fma_ilp4`` (the JAX script has no such row)."""
    x, x0 = _inputs(128, seed=3)
    out = roofline.psin_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_SIN,
                                    ilp=4).numpy()

    @jax.jit
    def xla(xx, xx0):
        xs = [xx, xx * 0.5, xx * 0.25, xx * 0.125]
        for _ in range(K_SIN):
            xs = [_fast_sin_poly(c) + xx0 for c in xs]
        return ((xs[0] + xs[1]) + xs[2]) + xs[3]

    ref = np.asarray(xla(x, x0))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=CHAIN_ATOL)
    short = roofline.psin_chain_plain(torch.from_numpy(x), torch.from_numpy(x0), K_SIN - 1, ilp=4)
    assert _fails(short.numpy(), ref, 1e-5, CHAIN_ATOL)
    assert np.array_equal(
        roofline.psin_chain(torch.from_numpy(x), torch.from_numpy(x0), K_SIN, ilp=4).numpy(), out)


def test_chain_wrappers_refuse_what_the_kernel_does_not_take():
    """The launch checks (reached directly: a CPU tensor never gets there),
    the counters listed in ``launch_counts``, the source in the build list."""
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        roofline._check(x, x, 4)
    with pytest.raises(TypeError, match="float32"):
        roofline._check(x.double(), x, 4)
    with pytest.raises(ValueError, match="shape"):
        roofline._check(x, x[:4], 4)
    with pytest.raises(ValueError, match="ilp"):
        roofline.fma_chain(x, x, 4, A, ilp=2)
    with pytest.raises(ValueError, match="ilp"):
        roofline.psin_chain(x, x, 4, ilp=3)
    counts = launch_counts()
    for key in ("fma_chain.launches", "fma_chain.launches_ilp4", "psin_chain.launches",
                "psin_chain.launches_ilp4"):
        assert key in counts
    assert "roofline_chain" in _build.KERNELS
    assert (_build.CSRC / "roofline_chain.cu").exists()


def test_op_counts_and_kernel_flop_match():
    """``shaper_op_counts`` equals the JAX script's (loaded by path); the
    script's kernel bounds come from ``kernels/roofline.py``, the one home
    of the data-sheet rates and per-element counts that ``chip_smoke.py``
    imports too: PERF.md's kernel-6 row at B=8, Tc=500, hop 128; and kernel
    9's bounds at the CLI's 8,388,608 elements: 0.064 (fma), 0.257 (fma,
    ilp 4), 0.076 (sin) and 0.305 ms (sin, ilp 4), bound by operations."""
    ours, theirs = _load("torch_roofline_shaper"), _load("roofline_shaper")
    assert ours.shaper_op_counts() == theirs.shaper_op_counts() == (147, 25, 345, 25)
    assert ours.KERNEL_FLOP == {1: 757, 2: 1721, 5: 743, 6: 1691}
    assert ours.datasheet_bound_ms(6, 8, 500, 128) == pytest.approx(0.827, abs=5e-4)
    n = 8 * 1024 * 1024
    for (kind, k, ilp), ms in ((("fma", 256, 1), 0.0641), (("fma", 256, 4), 0.2572),
                               (("sin", 32, 1), 0.0761), (("sin", 32, 4), 0.3052)):
        got, by = roofline.bound(n * roofline.chain_flop(kind, k, ilp), 12 * n)
        assert got == pytest.approx(ms, abs=5e-5) and by == "operations", (kind, ilp, got)


def test_roofline_cli_on_the_cpu(capsys):
    """``main_impl`` at small sizes on the CPU: every row that is not a
    kernel row, the ceilings, both floors beside the measured chain and the
    kernels' data-sheet bounds; no kernel row, as JAX skips its Pallas rows."""
    script = _load("torch_roofline_shaper")
    results = script.main_impl(1, 2, 1, batch=1, n_frames=2, n_hbm=1 << 14, n_chain=1 << 10,
                               device="cpu")
    text = capsys.readouterr().out
    rows = ("hbm_read", "fma128", "fma128_ilp4", "fma64", "psin128", "xsin128", "shaper_fwd",
            "shaper_fwd_bwd")
    assert set(results) == set(rows)
    for row in rows:
        assert f"  {row} " in text
    assert "cuda_" not in text and "shaper_fused" not in text
    assert "(kernel rows skipped: CPU)" in text
    for what in ("fwd", "bwd", "fwd+bwd"):
        assert f"  {what:<8} floor" in text
    assert "x fwd floor" in text and "x fwd+bwd floor" in text
    for k in (1, 2, 5, 6):
        assert f"kernel {k}: data-sheet bound" in text
