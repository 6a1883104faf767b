"""The host's time to enqueue one call into the layer, ms, in the ``stream`` cells."""
from nwsbench.readers import host_enqueue_ms


def read(rec):
    return host_enqueue_ms(rec, "stream")
