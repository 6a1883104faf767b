#!/usr/bin/env python3
"""Latency by buffer size with the PyTorch/CUDA port (the counterpart of
``scripts/time_buffer_sizes.py``, itself the reference's: buffers of
256-32768 samples, control frames = buffer // 128, 10 warm-ups, 100 timed
iterations, CSV rows [model, device, buffer_size, seconds]).

    python3 scripts/torch_time_buffer_sizes.py [--streaming] [--buffers 256,1024]
        [--pipeline-depth 4,16] [--output-csv buffer_times.csv] [--device cpu]

Two modes:

* default: stateless batch-1 forwards per buffer (the reference's: no state
  carried), each timed to its output's copy to the host; on the card kernel
  1 (``NEWT.fused = "cr"``) or, with ``--use-fast-newt``, kernel 4;
* ``--streaming``: the carried-state ``StreamingSynth.step`` (GRU, phase,
  noise overlap-add and partitioned reverb carried), each step timed to its
  copy to the host; on the card the stream kernel 3. Beside the serial
  latency it prints the queued-loop step (``utils.profiling
  .differential_loop_ms`` over loops of 6 and 1 times ``--iterations``
  steps, 600 and 100 by default as JAX's scans, best of 3: the host's
  launch time where the host sets the pace), the card's busy time
  per step (``torch.profiler``'s union of kernel and copy intervals over 20
  steps), and the pipelined cadence at each ``--pipeline-depth``
  (``PipelinedStreamer``: the spacing of buffers reaching the host, the
  pinned copy and the event wait included, and the first buffer's latency).

The inputs are JAX's draws, one ``default_rng(0)`` across the buffer sizes
in order: f0 = 220 + 220 U Hz, control ~ N(0, 1). The CSV has JAX's
columns; with ``--streaming`` the summary CSV beside it has JAX's too, its
``device_step_ms`` the profiler's busy time per step (NaN on the CPU, which
has no device trace: not measured), ``host_rtt_*`` the serial latency
above it, plus ``queued_loop_step_ms``. The launch counters of the timed
kernel must move on the card or the script exits non-zero. Runs on the card
unless ``--device cpu`` is given.
"""
import argparse
import csv
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.streaming import (  # noqa: E402
    PipelinedStreamer,
    StreamingSynth,
)
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    device_busy,
    differential_loop_ms,
    require_launches,
)
from torch_time_forward_pass import (  # noqa: E402  (same folder)
    FORWARD_KERNELS,
    LOOKUP_KERNEL,
    build_model,
)

BUFFER_SIZES = [256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
STREAM_KERNEL = ("film_shaper_stream.launches",)


def buffer_inputs(rng: np.random.Generator, frames: int):
    """JAX's per-buffer draws: f0 (1, K) Hz and control (1, K, 2), float32."""
    f0 = (220.0 + 220.0 * rng.random((1, frames))).astype(np.float32)
    control = rng.standard_normal((1, frames, 2)).astype(np.float32)
    return f0, control


def write_csv(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/models/newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[])
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--use-fast-newt", action="store_true")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--pipeline-depth", default="4,16",
                    help="comma list of in-flight-buffer depths for the pipelined cadence "
                         "(--streaming only; '0' disables it)")
    ap.add_argument("--output-csv", default="buffer_times.csv")
    ap.add_argument("--buffers", default=",".join(map(str, BUFFER_SIZES)))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/models/newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.streaming and args.use_fast_newt:
        raise SystemExit("--use-fast-newt is not supported with --streaming (the streaming "
                         "step evaluates the shaper bank in the stream kernel)")
    device = resolve_device(args.device)
    model = build_model(args.gin_file, args.gin_binding, args.checkpoint, device)
    hop = model.control_hop
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    mode = "streaming" if args.streaming else "stateless"
    model_name = f"newt_torch_{mode}" + ("_fast" if args.use_fast_newt else "")
    with torch.inference_mode():
        table = model.newt.bake_lookup_table() if args.use_fast_newt else None
    depths = [int(d) for d in str(args.pipeline_depth).split(",") if int(d) > 0]
    before = launch_counts()

    rows, summary_rows = [], []
    rng = np.random.default_rng(0)
    for buffer_size in [int(b) for b in args.buffers.split(",")]:
        frames = buffer_size // hop
        if frames < 1:
            continue
        f0_np, control_np = buffer_inputs(rng, frames)
        f0, control = torch.from_numpy(f0_np).to(device), torch.from_numpy(control_np).to(device)
        if args.streaming:
            synth = StreamingSynth(model, frames)
            spec = synth.ir_partition_spectra()
            generator = torch.Generator(device=device).manual_seed(0)
            state = synth.init_state(1, generator, device=device)

            def step(s):
                return synth.step(s, f0, control, spec)

            for _ in range(args.warmup + 1):  # one untimed call always runs
                audio, state = step(state)
            audio.cpu()
            times = []
            for _ in range(args.iterations):
                t0 = time.perf_counter()
                audio, state = step(state)
                audio.cpu().numpy()
                times.append(time.perf_counter() - t0)
            n = args.iterations
            loop_ms = differential_loop_ms(lambda s: step(s)[1], n, 6 * n, 3, carry=state,
                                           device=device)
            carried = [state]

            def traced_step():
                carried[0] = step(carried[0])[1]

            busy = device_busy(traced_step, runs=20)
            dev_ms = busy["busy_ms"] if busy else float("nan")
            print(f"               queued-loop step: {loop_ms:7.3f} ms ({6 * n}-{n} loop by "
                  f"difference, best of 3; the host's launch time where it sets the pace)")
            print(f"               device busy per step: {dev_ms:7.3f} ms (torch.profiler, "
                  f"union of kernel and copy intervals over 20 steps)")
            pipe_rows = []
            for depth in depths:
                streamer = PipelinedStreamer(
                    synth, 1, torch.Generator(device=device).manual_seed(0), depth=depth,
                    device=device)
                t0 = time.perf_counter()
                for _ in range(depth + 1):
                    streamer.push(f0, control)  # the last one returns buffer 0
                first_lat_ms = (time.perf_counter() - t0) * 1000
                for _ in range(args.warmup):
                    streamer.push(f0, control)
                pops = []
                for _ in range(max(args.iterations, 200)):
                    streamer.push(f0, control)
                    pops.append(time.perf_counter())
                cad = np.diff(np.asarray(pops)) * 1000
                pipe_rows.append((depth, np.percentile(cad, 50), np.percentile(cad, 95),
                                  first_lat_ms))
                print(f"               pipelined cadence (depth {depth}): "
                      f"p50 {pipe_rows[-1][1]:7.3f} ms  p95 {pipe_rows[-1][2]:7.3f} ms  "
                      f"first-buffer latency {first_lat_ms:7.3f} ms")
        else:
            @torch.inference_mode()
            def fwd(i: int) -> torch.Tensor:
                return model(f0, control, generator=torch.Generator().manual_seed(i),
                             lookup_table=table)

            for i in range(args.warmup + 1):
                out = fwd(i)
            out.cpu()
            times = []
            for i in range(args.iterations):
                t0 = time.perf_counter()
                fwd(i).cpu().numpy()
                times.append(time.perf_counter() - t0)

        times = np.asarray(times)
        budget = buffer_size / model.sample_rate
        p50, p95 = np.percentile(times, 50) * 1000, np.percentile(times, 95) * 1000
        print(f"buffer {buffer_size:6d}: p50 {p50:7.3f} ms  p95 {p95:7.3f} ms  "
              f"budget {budget * 1000:7.3f} ms  {'OK' if p50 < budget * 1000 else 'OVER'}",
              flush=True)
        rows += [{"model": model_name, "device": device_name, "buffer_size": buffer_size,
                  "seconds": t} for t in times]
        if args.streaming:
            for depth, pipe_p50, pipe_p95, first_lat_ms in (
                    pipe_rows or [(0, float("nan"), float("nan"), float("nan"))]):
                summary_rows.append({
                    "model": model_name, "device": device_name, "buffer_size": buffer_size,
                    "p50_ms": p50, "p95_ms": p95, "device_step_ms": dev_ms,
                    "host_rtt_p50_ms": max(p50 - dev_ms, 0.0) if busy else float("nan"),
                    "host_rtt_p95_ms": max(p95 - dev_ms, 0.0) if busy else float("nan"),
                    "pipeline_depth": depth,
                    "pipelined_cadence_p50_ms": pipe_p50,
                    "pipelined_cadence_p95_ms": pipe_p95,
                    "first_buffer_latency_ms": first_lat_ms,
                    "budget_ms": budget * 1000,
                    "queued_loop_step_ms": loop_ms,
                })

    write_csv(args.output_csv, rows)
    print(f"wrote {args.output_csv}")
    if summary_rows:
        base, ext = os.path.splitext(args.output_csv)
        summary_csv = f"{base}_summary{ext or '.csv'}"
        write_csv(summary_csv, summary_rows)
        print(f"wrote {summary_csv} (p50/p95 with the device-busy/host split)")
    kernels = STREAM_KERNEL if args.streaming else (
        LOOKUP_KERNEL if args.use_fast_newt else FORWARD_KERNELS)
    require_launches(before, kernels, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
