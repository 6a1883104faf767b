"""Weights into the port: reference checkpoints and JAX parameter trees."""
from .checkpoint import (
    convert_state_dict,
    load_checkpoint,
    load_lightning_checkpoint,
    params_from_jax,
)

__all__ = [
    "convert_state_dict",
    "load_checkpoint",
    "load_lightning_checkpoint",
    "params_from_jax",
]
