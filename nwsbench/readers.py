"""The arithmetic of the per-layer metrics, shared by the readers in
``metrics/``: each reader is one file named by its metric, which calls one
of these with its traffic kind. A reader that finds nothing to read
returns None, and the run leaves the metric out."""
from typing import Dict, Optional

from nwsbench import counts


def _ours(rec: Dict, kind: str) -> bool:
    return rec["layer"]["kind"] == kind


def host_dispatch_ms(rec: Dict, kind: str) -> Optional[float]:
    """The trainer's host stages that launch a step (its ``StageTimer``
    under ``NWS_TPU_HOST_PROFILE``: ``indices``, ``gather_dispatch``,
    ``step_dispatch``), in ms per step of the window."""
    stages = rec["layer"].get("host_stages_s") or {}
    names = ("indices", "gather_dispatch", "step_dispatch")
    if not _ours(rec, kind) or not all(n in stages for n in names):
        return None
    return 1e3 * sum(stages[n] for n in names) / rec["layer"]["units"]


def host_enqueue_ms(rec: Dict, kind: str) -> Optional[float]:
    """The harness's host clock around each call into the layer (a batch's
    forward, a stream's step), before any copy to the host: the mean in ms."""
    spans = rec["layer"].get("host_enqueue_s") or []
    if not _ours(rec, kind) or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)


def mfu(rec: Dict, kind: str) -> Optional[float]:
    """The model FLOPs of the window's work (``counts``) over the window's
    wall time at the float32 data-sheet peak, in %."""
    layer = rec["layer"]
    if not _ours(rec, kind) or layer["window_s"] <= 0:
        return None
    return 100.0 * layer["flop"] / (layer["window_s"] * counts.PEAK_F32_FLOP_PER_S)


def shaper_roofline(rec: Dict, kind: str) -> Optional[float]:
    """The shaper block's least time at the data sheet's peaks, for every
    launch of the kernels the configuration names in the traced slice, over
    those kernels' device time, in %. A kernel's ``helpers`` (the kernels
    its launch runs after it to finish the same work, such as kernel 2's
    cross-block sums) add their device time and no bound."""
    trace = rec.get("trace")
    if not _ours(rec, kind) or not trace:
        return None
    m = rec["config"]["model"]
    b, frames = rec["layer"]["block_shape"]
    least = spent = 0.0
    for block in rec["config"]["block"][kind]:
        n = trace["kernel_launches"].get(block["kernel"], 0)
        least += n * counts.block_bound_s(block["count"], b, frames, m["control_hop"],
                                          m["n_waveshapers"],
                                          rec["config"].get("fast_newt_table") or 4096)
        names = [block["kernel"], *block.get("helpers", [])]
        spent += sum(trace["kernel_s"].get(k, 0.0) for k in names)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


def idle_share(rec: Dict, kind: str) -> Optional[float]:
    """1 - the union of the device's kernel and copy intervals over the
    traced slice's wall time, in %."""
    trace = rec.get("trace")
    if not _ours(rec, kind) or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
