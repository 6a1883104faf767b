"""The trainer's host time that launches a step (indices, gather, dispatch),
ms per step, in the ``train`` cells."""
from nwsbench.readers import host_dispatch_ms


def read(rec):
    return host_dispatch_ms(rec, "train")
