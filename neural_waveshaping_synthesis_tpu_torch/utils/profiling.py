"""Profiling and debugging hooks (counterpart of the JAX
``utils/profiling.py``): a ``torch.profiler`` trace, NaN detection, named
host stages, the per-iteration timer of an eager loop, the device's busy
time from the profiler, and the kernels' launch counters that a
measurement of the card must see move."""
import contextlib
import math
import os
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..device import resolve_device
from ..kernels import launch_counts


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the scope written to ``log_dir`` (a
    ``*.pt.trace.json`` Chrome trace: TensorBoard's profiler plugin, Perfetto
    or chrome://tracing read it); a no-op when ``log_dir`` is falsy. With a
    card the trace holds its kernels and copies, and the scope ends with a
    synchronisation so that they are in it; otherwise the CPU's operators."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()
    print(f"[profiling] trace written to {log_dir}")


# Factories whose output is uninitialised memory, which may hold NaN bits.
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
                  "new_empty_strided"}


class _RaiseOnNaN(TorchDispatchMode):
    """Checks the floating-point outputs of every operator dispatched in
    the scope and raises ``FloatingPointError`` on the first NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                        and t.layout == torch.strided and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise on the first NaN computed inside the scope, as JAX's
    ``jax_debug_nans`` does; ``enable=False`` turns the checks off inside it.

    Every operator dispatched in the scope, the backward's included, has its
    floating-point outputs checked and raises ``FloatingPointError`` on the
    first NaN. The backward also runs under
    ``torch.autograd.set_detect_anomaly``, which prints the forward traceback
    of the operation whose backward made the NaN (anomaly mode alone would
    not look at the forward at all). A CUDA kernel launched through
    ``ctypes`` is no operator: its NaN is caught at the first operator that
    reads it. Each check reads a flag back from the card, so the scope
    synchronises after every operator: a debugging tool, never a timed
    path."""
    if not enable:
        with torch.autograd.set_detect_anomaly(False):
            yield
        return
    with torch.autograd.set_detect_anomaly(True), _RaiseOnNaN():
        yield


class StageTimer:
    """Named wall-clock stage timing (the reference's time.time() style,
    structured). The host's clock only: a stage that queues work on the card
    ends before the work does, and the wait shows in the stage that reads
    the result back."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s" for k, v in self.stages.items())


def differential_loop_ms(
    body: Callable,
    n_short: int = 20,
    n_long: int = 120,
    repeats: int = 3,
    carry=None,
    device="cuda",
) -> float:
    """Per-iteration time of ``carry = body(carry)`` in an eager loop, by
    difference: (t_long - t_short) / (n_long - n_short) in ms, each loop's
    time the best of ``repeats`` (the counterpart of JAX
    ``differential_scan_ms``).

    ``body`` runs once untimed, then ``repeats`` loops of ``n_long`` and
    ``repeats`` of ``n_short`` iterations: ``1 + repeats * (n_short +
    n_long)`` calls in all. On the card each loop is timed
    between two CUDA events and synchronised once, at its end; on the CPU by
    the host's clock. The loop's fixed costs (the first launch's latency, the
    drain after the last) cancel in the difference.

    What it measures on the card: the per-iteration time of a queued loop,
    the larger of the host's time to launch one iteration's work and the
    card's time to run it. Where the host sets the pace (a host-bound step)
    that is the host's launch time; it is not device-only time (for that,
    :func:`device_busy` over the profiler's trace). JAX's two traps do not
    arise here: an eager loop hoists nothing out of the body and eliminates
    no dead code, so ``body`` needs no dependence on the carry; a carry that
    evolves (a stream's state, a train state) is threaded through all the
    same."""
    if n_long <= n_short:
        raise ValueError(f"n_long ({n_long}) must exceed n_short ({n_short})")
    cuda = resolve_device(device).type == "cuda"
    carry = body(carry)
    if cuda:
        torch.cuda.synchronize()

    def best_ms(n: int) -> float:
        nonlocal carry
        best = math.inf
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    carry = body(carry)
                stop.record()
                stop.synchronize()
                ms = start.elapsed_time(stop)
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    carry = body(carry)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms)
        return best

    return (best_ms(n_long) - best_ms(n_short)) / (n_long - n_short)


def busy_ms(events) -> float:
    """The union of the profiler events' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # us -> ms


def device_busy(fn: Callable, runs: int = 5) -> Optional[Dict[str, float]]:
    """The card's time in ``fn``: ``runs`` calls traced by ``torch.profiler``
    after the caller's warm-up, then per call the device's busy time (the
    union of its kernel and copy intervals), the traced wall time (ending in
    a synchronisation; the profiler's overhead included), the idle share
    and the device events. One call traced before, and thrown away, takes
    the tracer's start-up out of the figures. None without a card, or when
    the trace shows no device event."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    busy = busy_ms(events)
    return {"busy_ms": busy / runs, "wall_ms": wall / runs, "idle_share": 1.0 - busy / wall,
            "events": len(events) / runs}


def require_launches(before: Dict[str, int], kernels: Sequence[str], device) -> Dict[str, int]:
    """Print the kernel launch counters (:func:`kernels.launch_counts`) that
    moved since ``before`` -> those moves. On the card, exit non-zero
    (``SystemExit``) unless a counter whose name starts with one of
    ``kernels`` moved: a timing of a plain version must not pass for the
    kernel's. On the CPU the kernels' plain versions run and nothing is
    required."""
    moved = {k: v - before.get(k, 0) for k, v in launch_counts().items() if v != before.get(k, 0)}
    print("[launches] " + (", ".join(f"{k} +{v}" for k, v in moved.items()) or "none"), flush=True)
    if torch.device(device).type == "cuda" and not any(
            k.startswith(tuple(kernels)) for k in moved):
        raise SystemExit(f"no launch of {list(kernels)} on the card: the figures above would "
                         "time a plain version, not the kernel")
    return moved
