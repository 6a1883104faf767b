"""The whole step's share of the card's float32 peak, in the ``stream`` cells."""
from nwsbench.readers import mfu


def read(rec):
    return mfu(rec, "stream")
