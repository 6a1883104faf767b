"""Weights into the port (reference checkpoints and JAX parameter trees)
and out of it (reference-format checkpoints); a JAX stream's carried
state and a JAX training state into the port."""
from .checkpoint import (
    convert_state_dict,
    load_checkpoint,
    load_lightning_checkpoint,
    params_from_jax,
    params_to_reference_state_dict,
    save_reference_checkpoint,
)
from .stream_state import stream_state_from_jax
from .train_state import parameters_from_tree, train_state_from_jax

__all__ = [
    "convert_state_dict",
    "load_checkpoint",
    "load_lightning_checkpoint",
    "parameters_from_tree",
    "params_from_jax",
    "params_to_reference_state_dict",
    "save_reference_checkpoint",
    "stream_state_from_jax",
    "train_state_from_jax",
]
