"""Carry a stream's state into the port: the streaming counterpart of
:func:`convert.checkpoint.params_from_jax`, so that a test can start the
port and the JAX package from the same carries."""
from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..streaming.synth import StreamState

_FLOAT32 = ("gru_h", "phase_offset", "prev_f0", "prev_film", "noise_prev", "noise_ola",
            "reverb_tail")


def stream_state_from_jax(state, device="cuda") -> StreamState:
    """A JAX ``StreamState`` (its NamedTuple, or a mapping of its field
    names to numpy arrays) -> the port's :class:`StreamState` on ``device``
    (the card unless ``device="cpu"``; raises without a card).

    The re/im float pairs of the reverb delay line become complex64, the
    phase carry becomes float64 (the port carries it so), and the JAX
    ``key`` is dropped: the port draws its noise from a new generator on
    ``device`` seeded with 0, as ``StreamingSynth.init_state`` makes (swap
    in another with ``state._replace(generator=g)``)."""
    fields = state if isinstance(state, Mapping) else state._asdict()
    dev = resolve_device(device)

    def tensor(name, dtype=np.float32):
        return torch.from_numpy(np.array(fields[name], dtype=dtype)).to(dev)

    fdl = np.asarray(fields["reverb_fdl"], dtype=np.float32)
    return StreamState(
        **{name: tensor(name) for name in _FLOAT32},
        osc_phase=tensor("osc_phase", np.float64),
        reverb_fdl=torch.from_numpy(fdl[..., 0] + 1j * fdl[..., 1]).to(dev, torch.complex64),
        generator=torch.Generator(device=dev).manual_seed(0),
    )
