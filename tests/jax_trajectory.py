"""JAX's loss curves over the port's loss-trajectory recipe.

    python3 tests/jax_trajectory.py     # rewrites tests/data/jax_loss_trajectory.json

The recipe and the gates are the port's
(``neural_waveshaping_synthesis_tpu_torch/utils/trajectory.py``, no JAX);
this helper holds what needs JAX. :func:`jax_losses` runs JAX's
``value_and_grad`` of ``NeuralWaveshaping.apply`` +
``multi_resolution_stft_loss`` followed by ``make_optimizer``, in float64
(or float32), over the recipe's batch and draws from the port's seeded init
carried to JAX through ``params()``: the loop of
``tests/test_torch_training.py`` ``test_two_training_steps_match_jax``,
extended.

The fixture holds JAX's float64 curve (``losses``) and JAX's own spread
(``spread``), three families of four curves each:

* ``ln_order``: float64 with each LayerNorm's float32 statistics summed in
  another order (the channels rolled by 1, 2, 3 and 5 places): the one way
  the port's float64 step differs from JAX's (both compute LayerNorm
  statistics in float32, in their own orders);
* ``init``: float64 from the init perturbed at float32 rounding (every
  weight times ``1 + 2**-24 u``, four seeds);
* ``float32``: JAX in float32, unperturbed and from three inits at ``2**-23``.

``tests/test_torch_trajectory.py`` holds the port's float64 curve against
``losses`` with the two float64 families as JAX's spread; ``chip_smoke.py``
holds the card's float32 curve against ``losses`` with all three.
"""
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch.utils.trajectory import (  # noqa: E402
    RECIPE,
    init_params,
    trajectory_batch,
    trajectory_draws,
)

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_loss_trajectory.json"
# (dtype, perturb, seed, ln_roll) of each spread curve, by family
SPREAD = {"ln_order": [("float64", 0.0, 0, r) for r in (1, 2, 3, 5)],
          "init": [("float64", 2.0**-24, s, 0) for s in (1, 2, 3, 4)],
          "float32": [("float32", 0.0, 0, 0)] + [("float32", 2.0**-23, s, 0) for s in (1, 2, 3)]}
FLOAT64_FAMILIES = ("ln_order", "init")


def jax_losses(recipe=RECIPE, perturb=0.0, seed=0, dtype="float64", steps=None, ln_roll=0):
    """JAX's loss before each of the recipe's steps (or its first
    ``steps``), from :func:`init_params` (``perturb``, ``seed``), in
    ``dtype``; ``ln_roll`` > 0 sums each LayerNorm's float32 statistics
    over its channels rolled by that many places (:func:`_rolled_layer_norm`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from neural_waveshaping_synthesis_tpu.models import NeuralWaveshaping
    from neural_waveshaping_synthesis_tpu.models import modules as jax_modules
    from neural_waveshaping_synthesis_tpu.training import TrainConfig, make_optimizer
    from neural_waveshaping_synthesis_tpu.training.loss import multi_resolution_stft_loss

    if ln_roll:
        jax_modules.layer_norm_apply = _rolled_layer_norm(ln_roll)

    dt = np.dtype(dtype)
    batch = {k: v.astype(dt) for k, v in trajectory_batch(recipe).items()}
    draws = trajectory_draws(recipe)[:steps]
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x.astype(dt)),
                                        init_params(recipe, perturb, seed))
        opt = make_optimizer(TrainConfig())
        state = opt.init(params)

        @jax.jit
        def step(p, st, o, n):
            def loss_fn(q):
                recon = NeuralWaveshaping().apply(q, batch["f0"], batch["control"],
                                                  phase_offset=o, noise=n)
                return multi_resolution_stft_loss(recon, batch["audio"])

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, st = opt.update(grads, st, p)
            return optax.apply_updates(p, updates), st, loss

        losses = []
        for o, n in draws:
            params, state, loss = step(params, state, o.astype(dt), n.astype(dt))
            losses.append(float(loss))
    return losses


def _rolled_layer_norm(roll):
    """JAX's ``layer_norm_apply`` (``models/modules.py``) with its float32
    mean and variance summed over the channels rolled by ``roll`` places:
    the same function, rounded in another order, as the port's LayerNorm
    rounds its float32 statistics in torch's order. Set in a spawned
    process only: the JAX package is not edited."""
    import jax
    import jax.numpy as jnp

    def layer_norm_apply(p, x, eps=1e-5):
        xf = x.astype(jnp.float32)
        xr = jnp.roll(xf, roll, axis=-1)
        mean = jnp.mean(xr, axis=-1, keepdims=True)
        var = jnp.var(xr, axis=-1, keepdims=True)
        normed = (xf - mean) * jax.lax.rsqrt(var + eps)
        return (normed * p["scale"] + p["bias"]).astype(x.dtype)

    return layer_norm_apply


def _curve(args):
    dtype, perturb, seed, ln_roll = args
    return jax_losses(perturb=perturb, seed=seed, dtype=dtype, ln_roll=ln_roll)


if __name__ == "__main__":
    jobs = [("float64", 0.0, 0, 0)] + [job for runs in SPREAD.values() for job in runs]
    with ProcessPoolExecutor(4, mp_context=get_context("spawn")) as pool:
        curves = dict(zip(jobs, pool.map(_curve, jobs)))
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    FIXTURE.write_text(json.dumps({
        "what": "JAX's loss before each of the recipe's steps (tests/jax_trajectory.py): "
                "float64, and its spread (dtype, perturb, seed, ln_roll)",
        "recipe": RECIPE, "losses": curves[jobs[0]],
        "spread": {family: [{"dtype": d, "perturb": p, "seed": s, "ln_roll": r,
                             "losses": curves[(d, p, s, r)]} for d, p, s, r in runs]
                   for family, runs in SPREAD.items()}},
        indent=1) + "\n")
    print(f"wrote {FIXTURE}")
