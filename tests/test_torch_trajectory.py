"""The port's 60-step float64 loss trajectory against JAX's, on the CPU.

The recipe (``neural_waveshaping_synthesis_tpu_torch/utils/trajectory.py``):
the port's seeded init at full width, one batch of 2 harmonic tones of 16
frames, the phase offsets and noise of every step drawn with numpy; the
port's ``train_step`` (loss, backward, clip, Adam, StepLR) against JAX's
``value_and_grad`` + ``make_optimizer``, both in float64. JAX's curve and
its own spread are the committed fixture (``tests/data/
jax_loss_trajectory.json``, written by ``tests/jax_trajectory.py``, which
``chip_smoke.py`` holds the card's curve against too); a live run of JAX's
first steps holds the fixture to JAX as it is now.

The gate is JAX's three-tier gate (``tests/test_training.py``
``_assert_same_trajectory``: steps 1-5 within 2e-3, every step within 50 %,
the medians of steps 41-60 within 2.5 %) with the bars of tiers 1 and 3
raised to JAX's own spread where that is larger (``spread_gate``). On this
recipe Adam's first, sign-like updates amplify a float32-sized difference
by 1e2-1e4 a step, and the port's float64 step differs from JAX's by
float32 rounding: both compute LayerNorm statistics in float32, each in its
own order (:func:`test_float64_layer_norms_part_at_float32_rounding`). JAX
against itself with its LayerNorm statistics summed in another order (the
fixture's ``ln_order`` family) or from an init perturbed at float32
rounding (``init``) parts from its own curve by up to 2.5e-2 at step 3,
1.2e-2 at step 5 and 7.0 % on the plateau (fixture, when written), above
JAX's bars. Step 1, the forward alone, is held to 1e-7 besides.

Measured when written (torch on one thread, so that the port's curve is the
same bits every run): the gap to JAX is 1.24e-8 at step 1, 7.19e-5 at step
2, 2.01e-3 at step 3, 1.30e-3 at step 4 and 3.41e-4 at step 5; the largest
gap of any step 14.3 %; the plateau medians 4.93 % apart. Adam is blind to
a gradient's scale, so this gate cannot see one; the gradients themselves
are held against JAX's by ``tests/test_torch_training.py``.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax_trajectory as jt
from neural_waveshaping_synthesis_tpu.models.modules import layer_norm_apply as j_layer_norm_apply
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping
from neural_waveshaping_synthesis_tpu_torch.models.modules import layer_norm_apply
from neural_waveshaping_synthesis_tpu_torch.training import Optimizer, TrainConfig, train_step
from neural_waveshaping_synthesis_tpu_torch.utils import trajectory

STEP1_RTOL = 1e-7  # the forward alone: float32 rounding of the LayerNorm statistics
LIVE_STEPS, LIVE_RTOL = 3, 1e-6  # JAX's first steps, run live, against the fixture


@pytest.fixture(scope="module")
def fixture():
    return json.loads(jt.FIXTURE.read_text())


@pytest.fixture(scope="module")
def port_curve():
    """The port's float64 curve over the recipe, once per module, on one
    torch thread: the same bits every run, and no oversubscription of the
    test workers' shared cores."""
    gin.clear_config()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = NeuralWaveshaping(
            generator=torch.Generator().manual_seed(trajectory.RECIPE["init_seed"])).double()
        optimizer = Optimizer(model.parameters(), TrainConfig())
        batch = {k: torch.from_numpy(v) for k, v in trajectory.trajectory_batch().items()}
        return [float(train_step(model, optimizer, batch, phase_offset=torch.from_numpy(o),
                                 noise=torch.from_numpy(n))["loss"])
                for o, n in trajectory.trajectory_draws()]
    finally:
        torch.set_num_threads(threads)


def test_port_loss_trajectory_matches_jax(port_curve, fixture):
    """JAX's three tiers, the bars of tiers 1 and 3 raised to JAX's own
    float64 spread, and step 1 within 1e-7 (measured gaps in the module
    docstring)."""
    ref = fixture["losses"]
    spread = [c["losses"] for f in jt.FLOAT64_FAMILIES for c in fixture["spread"][f]]
    assert len(port_curve) == len(ref) == trajectory.RECIPE["steps"] == 60 and len(spread) == 8
    g = trajectory.spread_gate(port_curve, ref, spread)
    assert g["exact"][0] <= STEP1_RTOL, g["exact"]
    assert g["tier2"], f"a step's loss is {g['row_max']:.3g} from JAX's (bar 0.5)"
    assert g["tier1"], (f"steps 1-5 {['%.3g' % v for v in g['exact']]}, bars "
                        f"{['%.3g' % v for v in g['exact_bars']]}")
    assert g["tier3"], f"plateau medians {g['plateau']:.3g} apart (bar {g['plateau_bar']:.3g})"


def test_committed_fixture_matches_live_jax(fixture):
    """The fixture's recipe is the port's, each spread family holds four
    finite 60-step curves, and JAX's first steps, run live, are the
    fixture's to 1e-6 (a stale fixture fails)."""
    assert fixture["recipe"] == trajectory.RECIPE
    assert set(fixture["spread"]) == set(jt.SPREAD)
    for family, runs in jt.SPREAD.items():
        got = fixture["spread"][family]
        assert [(c["dtype"], c["perturb"], c["seed"], c["ln_roll"]) for c in got] == runs
        assert all(len(c["losses"]) == 60 and np.all(np.isfinite(c["losses"])) for c in got)
    live = jt.jax_losses(steps=LIVE_STEPS)
    np.testing.assert_allclose(live, fixture["losses"][:LIVE_STEPS], rtol=LIVE_RTOL)


def test_trajectory_learns(port_curve, fixture):
    """The port's curve and JAX's learn the batch: the plateau (steps
    41-60) lies below the first loss."""
    for losses in (port_curve, fixture["losses"]):
        assert np.median(losses[40:60]) < losses[0], losses


def test_spread_gate_raises_bars_to_the_spread_only():
    """``spread_gate`` on scripted curves: a gap within JAX's bars passes
    whatever the spread; one above the bars passes only within the spread's
    own gap at that step (or plateau); tier 2 ignores the spread."""
    ref = np.full(60, 2.0)
    near = ref.copy()
    near[2] *= 1 + 1e-3
    assert all(trajectory.spread_gate(near, ref, [ref])[t] for t in ("tier1", "tier2", "tier3"))
    off = ref.copy()
    off[2] *= 1 + 5e-3
    off[40:] *= 1.04
    wide = ref.copy()
    wide[2] *= 1 + 6e-3
    wide[40:] *= 0.95
    narrow = ref.copy()
    narrow[3] *= 1 + 6e-3
    narrow[40:] *= 1.03
    g = trajectory.spread_gate(off, ref, [narrow])
    assert not g["tier1"] and not g["tier3"] and g["exact_bars"][2] == 2e-3
    g = trajectory.spread_gate(off, ref, [narrow, wide])
    assert g["tier1"] and g["tier3"] and g["plateau_bar"] == pytest.approx(0.05)
    far = ref.copy()
    far[10] *= 1.6
    assert not trajectory.spread_gate(far, ref, [far])["tier2"]
    with pytest.raises(ValueError):
        trajectory.spread_gate(off, ref, [])


def test_float64_layer_norms_part_at_float32_rounding():
    """Where the float64 curves first part: JAX's LayerNorm computes its
    statistics in float32 whatever the input's dtype, and the port's after
    it, so on the same float64 input the two part by float32 rounding of
    different reduction orders (8.1e-8 nRMS when written, 45 % of the
    elements bit-equal): never bit for bit, never by more. The fixture's
    ``ln_order`` family's LayerNorm is JAX's bit for bit unrolled, and parts
    from it by the same rounding rolled."""
    x = np.random.default_rng(0).standard_normal((2, 16, 128)) * 3 + 1
    p = {"scale": np.ones(128), "bias": np.zeros(128)}
    with jax.enable_x64(True):
        jp, jx = {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)
        ref = np.asarray(jax.jit(j_layer_norm_apply)(jp, jx))
        rolled = {r: np.asarray(jax.jit(jt._rolled_layer_norm(r))(jp, jx)) for r in (0, 3)}
    out = layer_norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x)).numpy()
    assert out.dtype == ref.dtype == np.float64

    def nrms(a):
        return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref**2)))

    assert 0.0 < nrms(out) < 1e-6, nrms(out)
    assert np.array_equal(rolled[0], ref)
    assert 0.0 < nrms(rolled[3]) < 1e-6, nrms(rolled[3])
