"""The shaper block's kernels' share of their data-sheet roofline, in the ``train`` cells."""
from nwsbench.readers import shaper_roofline


def read(rec):
    return shaper_roofline(rec, "train")
