"""The loss-trajectory recipe and its gates, shared by the CPU test against
JAX (``tests/test_torch_trajectory.py``) and the card's run
(``chip_smoke.py``); numpy and the port only.

The recipe: the port's seeded init (``NeuralWaveshaping(generator=
torch.Generator().manual_seed(init_seed))``, full shipped width), one batch
of ``batch`` harmonic tones of ``frames`` control frames made with numpy
from ``data_seed`` (each tone's f0 is the f0 the model is given, and its
loudness the control's second channel, so the loss has something to
learn), and for every step the phase offsets and noise drawn from
``draw_seed``. ``tests/jax_trajectory.py`` runs JAX over it and writes the
curves that these gates read.

:func:`gate` is JAX's three-tier trajectory gate (``tests/test_training.py``
``_assert_same_trajectory``). On this recipe Adam's first, sign-like updates
amplify a float32-sized difference by ~1e2-1e4 a step, so that JAX parts
from itself by more than the gate's bars when its init is perturbed at
float32 rounding: :func:`spread_gate` holds a curve to each tier's bar or to
JAX's own spread at that tier, whichever is larger.
"""
import numpy as np

RECIPE = {"init_seed": 0, "data_seed": 21, "draw_seed": 5, "batch": 2, "frames": 16,
          "hop": 128, "sample_rate": 16000, "harmonics": 101, "steps": 60}
# JAX's gate (tests/test_training.py _assert_same_trajectory), on this
# recipe's 60 steps: steps 1-5 at 2e-3, every step at 50 %, the medians of
# steps 41-60 at 2.5 %
BARS = {"exact_horizon": 5, "exact_tol": 2e-3, "row_tol": 0.5, "plateau": (41, 60),
        "plateau_tol": 0.025}


def trajectory_batch(recipe=RECIPE):
    """-> {"f0" (B, Tc) Hz, "control" (B, Tc, 2), "audio" (B, Tc * hop)}
    as float64: tones gliding between two draws in 110-440 Hz with up to 20
    harmonics at 1/k, amplitude contours, and their z-scored (f0, loudness
    in dB) controls, as ``chip_smoke.py``'s ``write_tone_dataset`` makes
    its tones."""
    rng = np.random.default_rng(recipe["data_seed"])
    b, tc, hop, sr = recipe["batch"], recipe["frames"], recipe["hop"], recipe["sample_rate"]
    f0, amp, audio = np.zeros((b, tc)), np.zeros((b, tc)), np.zeros((b, tc * hop))
    for i in range(b):
        lo, hi = np.sort(rng.uniform(110.0, 440.0, 2))
        f0[i] = np.geomspace(lo, hi, tc)
        amp[i] = 0.1 + 0.3 * rng.uniform() * (1 + np.sin(np.linspace(0, rng.uniform(2, 9), tc))) / 2
        f0_a, amp_a = (np.interp(np.arange(tc * hop) / hop, np.arange(tc), v)
                       for v in (f0[i], amp[i]))
        phase = 2 * np.pi * np.cumsum(f0_a) / sr
        n_h = int(min(20, (sr / 2) // hi))
        audio[i] = amp_a * sum(np.sin(k * phase) / k for k in range(1, n_h + 1))
    loud = 20 * np.log10(amp)
    control = np.stack([(f0 - f0.mean()) / max(f0.std(), 1.0),
                        (loud - loud.mean()) / max(loud.std(), 1.0)], axis=-1)
    return {"f0": f0, "control": control, "audio": audio}


def trajectory_draws(recipe=RECIPE):
    """-> [(phase offsets (H,), noise (Tc * hop - 1,))] float64, one pair a step."""
    rng = np.random.default_rng(recipe["draw_seed"])
    n = recipe["frames"] * recipe["hop"] - 1
    return [(rng.uniform(-np.pi, np.pi, recipe["harmonics"]), rng.uniform(0, 1, n))
            for _ in range(recipe["steps"])]


def init_params(recipe=RECIPE, perturb=0.0, seed=0):
    """The port's seeded float32 init as a tree of float64 numpy arrays in
    JAX's layout (``params()``); ``perturb`` > 0 scales every weight by
    ``1 + perturb * u``, u uniform in [-1, 1) drawn from ``seed``."""
    import torch

    from ..models import NeuralWaveshaping

    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(recipe["init_seed"]))
    rng = np.random.default_rng(seed)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v) for v in t]
        v = t.detach().numpy().astype(np.float64)
        return v * (1.0 + perturb * rng.uniform(-1.0, 1.0, v.shape)) if perturb else v

    return tree(model.params())


def gaps(losses, ref):
    """Each step's ``|v - ref| / max(|ref|, 1)``, as JAX's gate measures it."""
    v, r = np.asarray(losses, np.float64), np.asarray(ref, np.float64)
    if v.shape != r.shape:
        raise ValueError(f"{v.shape} steps against {r.shape}")
    return np.abs(v - r) / np.maximum(np.abs(r), 1.0)


def plateau_gap(losses, ref, plateau=BARS["plateau"]):
    """The relative gap of the medians over the plateau's steps (1-based)."""
    lo, hi = plateau
    med, ref_med = np.median(np.asarray(losses)[lo - 1:hi]), np.median(np.asarray(ref)[lo - 1:hi])
    return float(abs(med - ref_med) / abs(ref_med))


def gate(losses, ref, bars=BARS):
    """JAX's three-tier gate on per-step losses (step s = index + 1) ->
    {"exact": the gaps of steps 1..exact_horizon, "row_max": the largest
    gap of any step, "plateau": the plateau medians' relative gap, and
    "tier1", "tier2", "tier3": whether each tier holds at JAX's bars}."""
    g, h = gaps(losses, ref), bars["exact_horizon"]
    out = {"exact": g[:h].tolist(), "row_max": float(g.max()),
           "plateau": plateau_gap(losses, ref, bars["plateau"])}
    out["tier1"] = bool(np.all(g[:h] <= bars["exact_tol"]))
    out["tier2"] = out["row_max"] <= bars["row_tol"]
    out["tier3"] = out["plateau"] <= bars["plateau_tol"]
    return out


def spread_gate(losses, ref, spread, bars=BARS):
    """JAX's gate, each tier's bar raised to JAX's own spread where that is
    larger: ``spread`` holds JAX's curves over the same recipe with the init
    perturbed (or at another precision), each measured against ``ref`` as
    ``losses`` is. Tier 1: step s <= exact_horizon within max(exact_tol,
    the largest spread gap at s); tier 2: every step within row_tol, JAX's
    divergence guard, unchanged; tier 3: the plateau within max(plateau_tol,
    the largest spread plateau gap) -> :func:`gate`'s keys, with "tier1" and
    "tier3" at these bars, plus "exact_bars" and "plateau_bar"."""
    if not spread:
        raise ValueError("no spread curves")
    out, h = gate(losses, ref, bars), bars["exact_horizon"]
    own = np.max([gaps(c, ref)[:h] for c in spread], axis=0)
    exact_bars = np.maximum(bars["exact_tol"], own)
    plateau_bar = max(bars["plateau_tol"], max(plateau_gap(c, ref, bars["plateau"]) for c in spread))
    out.update(exact_bars=exact_bars.tolist(), plateau_bar=plateau_bar,
               tier1=bool(np.all(np.asarray(out["exact"]) <= exact_bars)),
               tier3=out["plateau"] <= plateau_bar)
    return out
