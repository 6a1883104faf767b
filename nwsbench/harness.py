"""What every run shares: the cell and its configuration read by name, the
card's description, the model built from the configuration with the
benchmark's weights, the profiler over a steady slice of the window and
the summary read from it, and the check that no JAX module was loaded.

Nothing here imports the port at module level: ``run.py`` first sets the
checkout's cache directories, then imports the port.
"""
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the top-level module names a run may not hold: JAX, its libraries and the
# JAX package this port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "neural_waveshaping_synthesis_tpu")


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Tuple[Dict, Dict]:
    """(cell, configuration) of the cell ``name`` (``cells/<name>.json`` and
    the ``configs/<config>.json`` it names)."""
    path = HERE / "cells" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no cell {name!r}: {path} is missing")
    cell = read_json(path)
    config = read_json(HERE / "configs" / f"{cell['config']}.json")
    return cell, config


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().replace("\n", "; ") or f"not read ({out.stderr.strip()})"


def log(msg: str) -> None:
    print(f"[nwsbench] {msg}", file=sys.stderr, flush=True)


def seed_of(*entropy: int) -> int:
    """A 63-bit seed for a torch generator from integers."""
    import numpy as np

    return int(np.random.SeedSequence([int(e) for e in entropy]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def build_model(config: Dict, tree: Dict, device, fused):
    """The port's ``NeuralWaveshaping`` of the configuration's gin bindings,
    with the benchmark's weights ``tree`` loaded and NEWT's ``fused`` set;
    raises where the built model's sizes are not the configuration's."""
    from neural_waveshaping_synthesis_tpu_torch import minigin
    from neural_waveshaping_synthesis_tpu_torch.models.neural_waveshaping import NeuralWaveshaping

    minigin.clear_config()
    minigin.parse_config("\n".join(config["gin_bindings"]))
    model = NeuralWaveshaping()
    minigin.clear_config()
    m = config["model"]
    built = {"n_harmonics": model.osc.n_harmonics, "n_waveshapers": model.newt.n_waveshapers,
             "control_hop": model.control_hop, "sample_rate": model.sample_rate,
             "noise_ir_length": model.noise_synth.ir_length}
    wrong = {k: (v, m[k]) for k, v in built.items() if v != m[k]}
    n = sum(p.numel() for p in model.parameters())
    if wrong or n != config["parameters"]:
        raise SystemExit(f"the built model is not configuration {config['name']}: {wrong}, "
                         f"{n} parameters against {config['parameters']}")
    model.load_params(tree)
    model.newt.fused = fused
    return model.to(device)


class Tracer:
    """``torch.profiler`` over a slice of the window: ``start`` and ``stop``
    (each after a synchronisation), or nothing when not enabled. The trace
    stays in memory; :meth:`summary` reduces it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self, kernels: Sequence[str]) -> Optional[Dict]:
        """-> {"busy_s", "window_s", "device_s" (name -> seconds),
        "launches" (name -> count), "kernel_s" and "kernel_launches" (each of
        ``kernels``, matched as a substring of the device event's name),
        "top_ops", "idle_gaps"}; None when nothing was traced."""
        if self.prof is None or self.t1 is None:
            return None
        events = self.prof.events()
        device_type = torch.autograd.DeviceType.CUDA
        # a record_function span also leaves an annotation on the device's
        # timeline, which is no device work
        work = [e for e in events if e.device_type == device_type
                and not (getattr(e, "is_user_annotation", False)
                         or e.name.startswith("nwsbench."))]
        dev = [(e.time_range.start, e.time_range.end, e.name) for e in work]
        cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type != device_type]
        by_name: Dict[str, float] = {}
        launches: Dict[str, int] = {}
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
            launches[name] = launches.get(name, 0) + 1
        merged: List[List[float]] = []
        for s, e, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) / 1e6
        origin = min([s for s, _, _ in cpu] + [s for s, _ in merged] or [0.0])
        end = origin + (self.t1 - self.t0) * 1e6
        gaps = [(merged[0][0] - origin, origin)] if merged else []
        gaps += [(b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])]
        if merged:
            gaps.append((end - merged[-1][1], merged[-1][1]))
        gaps = sorted(gaps, reverse=True)[:10]
        kernel_s = {k: sum(v for n, v in by_name.items() if k in n) for k in kernels}
        kernel_n = {k: sum(v for n, v in launches.items() if k in n) for k in kernels}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": self.t1 - self.t0, "device_s": by_name,
                "launches": launches, "kernel_s": kernel_s, "kernel_launches": kernel_n,
                "top_ops": [[n, v] for n, v in top],
                "idle_gaps": [[_host_activity(cpu, at), g / 1e6] for g, at in gaps if g > 0]}


def _host_activity(cpu: List[Tuple[float, float, str]], at: float) -> str:
    """What the host was doing at ``at``: the benchmark's innermost span
    (``nwsbench.*``) there and the innermost other operation, "a > b"."""
    spans = [(s, e, n) for s, e, n in cpu if s <= at < e]
    ours = [x for x in spans if x[2].startswith("nwsbench.")]
    other = [x for x in spans if not x[2].startswith("nwsbench.")]
    name = max(ours)[2] if ours else "outside the benchmark's spans"
    if other:
        name += " > " + max(other)[2]
    return name


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` span of the benchmark's own, ``nwsbench.<name>``."""
    with torch.profiler.record_function(f"nwsbench.{name}"):
        yield


def percentile(values: Sequence[float], q: float) -> float:
    """numpy's default (linear) percentile."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def nrms(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row ||a - ref|| / ||ref|| over the last axis, in float64."""
    a, ref = a.double(), ref.double()
    return torch.linalg.vector_norm(a - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Per leaf, |prog norm - ref norm| over max(ref norm, the median leaf's
    ref norm); ``keep`` names the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def train_checks(losses, grad1, change3, ref, replay) -> Tuple[Dict[str, float], str]:
    """The numbers a training cell compares -> (numbers, what the worst leaves
    read): the first step's loss; the median leaf's gap of the first
    gradient's norm and of the parameters' change after the steps, over the
    leaves whose reference gradient is at least 1e-3 of the median leaf's
    (the others move under Adam by round-off alone); and the gaps of steps
    2 and 3's losses against ``replay`` ({step from 0: the reference's loss
    of that step at the side's own parameters before it})."""
    med = median(ref["grad1"].values())
    moving = [k for k, v in ref["grad1"].items() if v >= 1e-3 * med]
    grad = leaf_gaps(grad1, ref["grad1"])
    change = leaf_gaps(change3, ref["change3"], keep=moving)
    later = [abs(a - b) / abs(b) for a, b in zip(losses[1:], ref["losses"][1:])]
    replayed = {f"step{s + 1}_loss_gap": abs(losses[s] - r) / abs(r) for s, r in replay.items()}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    note = (f"not compared: worst leaves' gaps, gradient {worst_g} {grad[worst_g]!r}, change "
            f"{worst_c} {change[worst_c]!r}; later steps' losses against the reference's own "
            f"steps {later!r}; {len(ref['grad1']) - len(moving)} leaves out of the change")
    return {"loss1_gap": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": median(grad.values()), "change_gap": median(change.values()),
            **replayed}, note


def judge(rec: Dict, cell: Dict) -> Tuple[bool, Dict]:
    """-> (correct, {number: {"value", "limit"}}): every number compared
    finite and at most its limit, and no answer failed."""
    checks = {name: {"value": value, "limit": cell["checks"][name]}
              for name, value in rec["checks"].items()}
    correct = all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values()) and rec["failed"] == 0
    return correct, checks


class Context:
    """What a traffic module is handed: the cell, its configuration, the
    seed and window, the device, the tracer, and the run's hooks."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, cell: Dict,
                 config: Dict, device, start: float):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.start = start
        self.cell, self.config, self.device = cell, config, torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.tracer = Tracer(self.trace and self.cuda)
        self.notes = []
        self.window_t0 = self.window_t1 = None
        self.peak = 0

    def mark(self, what: str) -> None:
        log(f"{time.time() - self.start:8.2f} s  {what}")

    def note(self, what: str) -> None:
        self.notes.append(what)
        log(what)

    def window_start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.window_t0 = time.time()
        self.mark("window opens")

    def window_end(self) -> None:
        self.window_t1 = time.time()
        self.mark("window closed")

    def memory_peak(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.peak = torch.cuda.max_memory_allocated()

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def launch_counts(self):
        from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts

        return launch_counts()

    def launches_moved(self, before):
        now = self.launch_counts()
        moved = {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
        log("launches in the window: "
                    + (", ".join(f"{k} +{v}" for k, v in moved.items()) or "none"))
        return moved
