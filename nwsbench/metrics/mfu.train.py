"""The whole step's share of the card's float32 peak, in the ``train`` cells."""
from nwsbench.readers import mfu


def read(rec):
    return mfu(rec, "train")
