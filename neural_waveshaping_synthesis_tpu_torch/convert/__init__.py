"""Weights into the port (reference checkpoints and JAX parameter trees)
and out of it (reference-format checkpoints)."""
from .checkpoint import (
    convert_state_dict,
    load_checkpoint,
    load_lightning_checkpoint,
    params_from_jax,
    params_to_reference_state_dict,
    save_reference_checkpoint,
)

__all__ = [
    "convert_state_dict",
    "load_checkpoint",
    "load_lightning_checkpoint",
    "params_from_jax",
    "params_to_reference_state_dict",
    "save_reference_checkpoint",
]
