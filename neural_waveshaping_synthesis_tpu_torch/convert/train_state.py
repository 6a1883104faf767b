"""Carry a JAX training state into the port's Trainer.

The JAX package's train state (``init_train_state`` of its
``training/trainer.py``) holds the parameter tree, the optax state of
``make_optimizer``, ``(EmptyState(), (ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count)))``, and the step. :func:`train_state_from_jax`
turns it into what the port's ``Trainer.load_train_state`` takes.

Adam's moments ``mu``/``nu`` are trees in the parameters' JAX layout, so
they take the same layout map as the parameters: the GRU's matrices are
stored transposed in the port (``models/modules.py``, ``GRU``). The map
is the model's own ``load_params`` (:func:`parameters_from_tree`), not a
second list of transposes.
"""
import copy
from typing import Dict, List, Tuple

import torch

from .checkpoint import params_from_jax


def parameters_from_tree(model: torch.nn.Module, tree) -> List[torch.Tensor]:
    """A tree in the JAX parameter layout (a gradient, an Adam moment) ->
    one tensor per trainable parameter of ``model``, in the order and
    layout of ``model.parameters()``: the tree is loaded into a copy of the
    model with its ``load_params`` and read back."""
    scratch = copy.deepcopy(model).cpu()
    scratch.load_params(params_from_jax(tree))
    return [p.detach().clone() for p in scratch.parameters() if p.requires_grad]


def _find(tree, attr: str):
    """The first node of an optax state tree that has ``attr``."""
    if hasattr(tree, attr):
        return tree
    if isinstance(tree, (tuple, list)):
        for node in tree:
            found = _find(node, attr)
            if found is not None:
                return found
    return None


def train_state_from_jax(state: Dict, model: torch.nn.Module, cfg) -> Tuple[Dict, Dict, int]:
    """A JAX train state (numpy arrays or JAX arrays) -> (params,
    optimizer_state, step) for ``Trainer.load_train_state``.

    ``params`` is the parameter tree as CPU tensors; ``optimizer_state`` is
    the port's ``Optimizer.state_dict()`` for ``model``'s parameters under
    ``cfg`` (a ``TrainConfig``, the one JAX ``make_optimizer`` was given):
    Adam's ``exp_avg``/``exp_avg_sq`` from ``mu``/``nu``, its ``step`` from
    the Adam ``count``, and StepLR's ``last_epoch`` and learning rate from
    the train state's step."""
    from ..training.trainer import Optimizer  # the trainer imports this package

    adam_state = _find(state["opt_state"], "mu")
    if adam_state is None:
        raise ValueError("the optimizer state has no Adam moments (mu, nu)")
    step = int(state["step"])
    count = int(adam_state.count)
    scratch = copy.deepcopy(model).cpu()
    optimizer = Optimizer(scratch.parameters(), cfg)
    moments = zip(optimizer.params, parameters_from_tree(model, adam_state.mu),
                  parameters_from_tree(model, adam_state.nu))
    for p, mu, nu in moments:
        optimizer.adam.state[p] = {"step": torch.tensor(float(count)),
                                   "exp_avg": mu, "exp_avg_sq": nu}
    # StepLR's own recursion: the rate times gamma at each multiple of the
    # interval, in float64
    lr = cfg.learning_rate
    for _ in range(step // cfg.lr_decay_interval):
        lr *= cfg.lr_decay
    for group in optimizer.adam.param_groups:
        group["lr"] = lr
    optimizer.schedule.last_epoch = step
    optimizer.schedule._step_count = step + 1
    optimizer.schedule._last_lr = [lr for _ in optimizer.adam.param_groups]
    return params_from_jax(state["params"]), optimizer.state_dict(), step
