"""The device's idle share over the traced slice, in the ``train`` cells."""
from nwsbench.readers import idle_share


def read(rec):
    return idle_share(rec, "train")
