#!/usr/bin/env python3
"""One run of one cell of the port's benchmark:

    python3 nwsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``cells/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic kind, whose module
(``traffic/<kind>.py``) makes the inputs from the seed, runs set-up, then
the window of ``--seconds``, then the comparison with the plain reference
that decides ``correct``. ``--trace 0`` reports the cell's end-to-end
metrics of ``BENCHMARK.json``; ``--trace 1`` profiles a steady slice of
the window and reports its per-layer metrics, each read by
``metrics/<metric>.py`` from the run's record. The last line of standard
output is the result, a JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

A run needs a CUDA card and at least the cell's cards; without them it
exits non-zero and prints no result. It also fails when a kernel the
configuration names did not launch in the window, or when a module of JAX
or of the JAX package was loaded. Every cache of the port's kernels and of
CUDA lives in directories inside the checkout.
"""
import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """The wall-clock time at which this process started (the kernel's
    record), or now where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


START = _process_start()
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "nwsbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from nwsbench import harness  # noqa: E402


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench, workload: str):
    """(end-to-end metrics, per-layer metrics) of ``BENCHMARK.json`` that
    this cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", []) or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        raise SystemExit(f"BENCHMARK.json has no workload {args.workload!r}")
    cell, config = harness.load_cell(args.workload)
    harness.log(f"{time.time() - START:8.2f} s  imports done")
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"[nwsbench] no result: the cell needs {entry['chips']} CUDA card(s), this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    harness.log(f"device {kind} x{torch.cuda.device_count()} (the cell uses "
                f"{entry['chips']}); {harness.power_limit()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    ctx = harness.Context(args.workload, args.seed, args.seconds, bool(args.trace), cell, config,
                          "cuda", START)
    ctx.mark(f"cell {args.workload}, seed {args.seed}, {args.seconds} s, trace {args.trace}")
    traffic = load_module(harness.HERE / "traffic" / f"{cell['traffic']}.py",
                         f"nwsbench_traffic_{cell['traffic']}")
    rec = traffic.run(ctx)
    setup_s = ctx.window_t0 - START
    required = config["launch_counters"][cell["traffic"]]
    missing = [c for c in required if rec["layer"]["launches_moved"].get(c, 0) <= 0]
    if missing:
        print(f"[nwsbench] no result: {missing} did not launch in the window: the run would "
              "time a plain version, not the kernel", file=sys.stderr)
        return 4
    e2e, layer = cell_metrics(bench, args.workload)
    metrics = {}
    if args.trace:
        blocks = config["block"][cell["traffic"]]
        rec["trace"] = ctx.tracer.summary([k for b in blocks
                                           for k in [b["kernel"], *b.get("helpers", [])]])
        rec["config"], rec["cell"] = config, cell
        for spec in layer:
            reader = load_module(harness.HERE / "metrics" / f"{spec['name']}.py",
                                 "nwsbench_metric_" + spec["name"].replace(".", "_"))
            value = reader.read(rec)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        values = dict(rec["e2e"], setup_s=setup_s)
        for spec in e2e:
            metrics[spec["name"]] = {"value": values[spec["name"]], "unit": spec["unit"]}
    correct, checks = harness.judge(rec, cell)
    device = {"platform": "gpu", "kind": kind, "count": entry["chips"],
              "memory_peak_bytes": ctx.peak}
    if args.trace and rec.get("trace"):
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device}
    if args.trace and rec.get("trace"):
        result["breakdown"] = {"device_ops": rec["trace"]["top_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    bad = harness.forbidden_modules()
    if bad:
        print(f"[nwsbench] no result: the run loaded {bad}", file=sys.stderr)
        return 5
    for name, c in checks.items():
        print(f"[nwsbench] check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
