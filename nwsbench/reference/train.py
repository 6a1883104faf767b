"""The plain reference of the recipe's first training steps: the NEWT
forward and multi-resolution STFT loss of ``newt.py``, autograd's
gradients, clipping by the global norm and Adam, in float32 from the
benchmark's weights.

Each step's batch and draws are worked out again from the seed by the
recipe the port's trainer documents: epoch e's order is
``np.random.default_rng((seed, 2, e)).permutation(n)`` in batches of
``batch`` rows; step s's phase offsets (uniform in [-pi, pi)) and then its
noise (uniform in [0, 1)) come from a CPU ``torch.Generator`` seeded with
``np.random.SeedSequence((seed, 0, s)).generate_state(1, np.uint64)``; f0 is
the z-scored control's channel 0 denormalised in float32 on the host.

``loss_at`` gives a later step's loss at parameters handed to it: the
program's own, for the steps that replay its captured step, which the
reference can follow only from the program's state.
"""
import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

from nwsbench import weights
from nwsbench.reference import newt

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def step_generator(*entropy: int) -> torch.Generator:
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(seed))


def step_draws(seed: int, step: int, n_harmonics: int, n_noise: int):
    """Step ``step``'s (H,) phase offsets and (n_noise,) noise, on the CPU."""
    gen = step_generator(seed, 0, step)
    phase = torch.rand(n_harmonics, generator=gen) * (2 * math.pi) - math.pi
    return phase, torch.rand(n_noise, generator=gen)


def step_rows(seed: int, step: int, n: int, batch: int) -> np.ndarray:
    epoch, i = divmod(step, n // batch)
    return np.random.default_rng((seed, 2, epoch)).permutation(n)[i * batch:(i + 1) * batch]


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products, or TF32 ones for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def step_loss(params: Dict, m: Dict, audio: np.ndarray, control: np.ndarray,
              data_mean: np.ndarray, data_std: np.ndarray, mix: Dict, seed: int, step: int,
              device, rows_kept: Optional[int] = None, feed: Optional[int] = None
              ) -> torch.Tensor:
    """The loss of step ``step`` (from 0) at the parameters ``params`` (a
    tree of the weights' structure), on that step's batch and draws.
    ``rows_kept`` and ``feed`` plant faults for the calibration: the loss
    over only the batch's first rows; the batch and draws of step ``feed``."""
    feed = step if feed is None else feed
    rows = step_rows(seed, feed, len(audio), mix["batch"])[:rows_kept]
    ctrl = control[rows]
    f0 = (ctrl * data_std.T + data_mean.T)[:, :, 0]
    phase, noise = step_draws(seed, feed, m["n_harmonics"], m["control_hop"] * ctrl.shape[1] - 1)
    recon = newt.forward(params, m, torch.from_numpy(np.ascontiguousarray(f0)).to(device),
                         torch.from_numpy(np.ascontiguousarray(ctrl)).to(device),
                         phase.to(device), noise.to(device))
    return newt.stft_loss(recon, torch.from_numpy(audio[rows]).to(device))


def first_steps(tree: Dict, m: Dict, audio: np.ndarray, control: np.ndarray,
                data_mean: np.ndarray, data_std: np.ndarray, mix: Dict, seed: int,
                steps: int, device, tf32: bool = False, rows_kept: Optional[int] = None,
                stale_slot: bool = False) -> Dict:
    """-> {"losses": [each step's loss], "grad1": {leaf: norm of step 1's
    clipped gradient}, "change3": {leaf: norm of the parameters' change
    after ``steps`` steps}, "states": [the leaves before each step]}.
    ``rows_kept`` and ``stale_slot`` plant faults for the calibration: each
    step's loss over only its first rows; every step after the second on
    the second's batch and draws (a chunk of steps 2, 3, ... whose slot
    does not advance)."""
    init = {k: v.detach().clone() for k, v in weights.flatten(tree).items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    names = list(leaves)
    it = iter(names)
    params = weights.map_tree(lambda _: leaves[next(it)], tree)
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in init.items()}
    losses, grad1, states = [], {}, []
    with matmul_precision(tf32):
        for s in range(steps):
            states.append({k: v.detach().clone() for k, v in leaves.items()})
            loss = step_loss(params, m, audio, control, data_mean, data_std, mix, seed, s, device,
                             rows_kept=rows_kept, feed=min(s, 1) if stale_slot else s)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = 1.0 if float(norm) < mix["gradient_clip"] else mix["gradient_clip"] / norm
                grads = [g * scale for g in grads]
                if s == 0:
                    grad1 = {k: float(torch.linalg.vector_norm(g.double()))
                             for k, g in zip(names, grads)}
                t = s + 1
                b1, b2 = ADAM_BETAS
                for k, g in zip(names, grads):
                    m1, m2 = moments[k]
                    m1.mul_(b1).add_(g, alpha=1 - b1)
                    m2.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = m2.sqrt() / math.sqrt(1 - b2 ** t) + ADAM_EPS
                    leaves[k].addcdiv_(m1, denom, value=-mix["learning_rate"] / (1 - b1 ** t))
            losses.append(float(loss.detach()))
    change = {k: float(torch.linalg.vector_norm((leaves[k].detach() - init[k]).double()))
              for k in names}
    return {"losses": losses, "grad1": grad1, "change3": change, "states": states}


def loss_at(tree: Dict, leaves: Dict[str, torch.Tensor], m: Dict, audio: np.ndarray,
            control: np.ndarray, data_mean: np.ndarray, data_std: np.ndarray, mix: Dict,
            seed: int, step: int, device, tf32: bool = False, **fault) -> float:
    """The loss of step ``step`` (from 0) at the flat ``leaves`` (named as
    ``weights.flatten(tree)`` names them), without gradients."""
    it = iter(weights.flatten(tree))
    params = weights.map_tree(lambda _: leaves[next(it)], tree)
    with torch.no_grad(), matmul_precision(tf32):
        return float(step_loss(params, m, audio, control, data_mean, data_std, mix, seed, step,
                               device, **fault))


def undo_adam_step(leaf: torch.Tensor, exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                   t: int, lr: float) -> torch.Tensor:
    """The parameter before Adam's step ``t`` (from 1), worked out in float64
    from the parameter after it and the moments that step left (Adam's
    update is lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps))."""
    b1, b2 = ADAM_BETAS
    update = (lr / (1 - b1 ** t)) * exp_avg.double() / (
        exp_avg_sq.double().sqrt() / math.sqrt(1 - b2 ** t) + ADAM_EPS)
    return (leaf.double() + update).to(leaf.dtype)
