"""Small utilities (counterpart of the JAX ``utils/utils.py``)."""
import random

import numpy as np
import torch


def seed_all(seed: int) -> torch.Generator:
    """Seed Python's ``random``, numpy's global generator and torch's
    default generators (the CPU's and every card's), and return a fresh
    CPU ``torch.Generator`` seeded with ``seed``: the port threads its
    randomness through generators, as JAX threads its keys."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
