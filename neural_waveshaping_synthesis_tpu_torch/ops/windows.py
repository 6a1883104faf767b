"""Window functions (counterpart of the JAX ``ops/windows.py``)."""
import math
from typing import Optional

import torch


def hann_window(
    n: int, periodic: bool = True, device: Optional[torch.device] = None
) -> torch.Tensor:
    """float32 Hann window. ``periodic=True`` is ``torch.hann_window``'s default."""
    if n == 1:
        return torch.ones((1,), device=device)
    denom = n if periodic else n - 1
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / denom)
