"""Traffic ``stream``: N concurrent live streams of K-frame buffers through
the port's ``PipelinedStreamer`` (``StreamingSynth.step`` behind a pipeline
of ``depth`` buffers), a closed loop, as ``scripts/torch_serving_capacity.py``
drives it.

Stream s follows its own contour, drawn from (seed, 4); each push takes the
next K frames of every stream's contour, made on the host. The streams'
phase offsets come from a card generator seeded from (seed, 5) and each
buffer's noise from one seeded from (seed, 6), drawn in the ``step`` the
harness hands the streamer, so all of it can be drawn again. Set-up pushes
the mix's warm-up buffers. The cadence is the host clock between
successive ``push`` returns over the window. After the window the pipeline
is flushed, and a sample of streams, drawn from the seed, is compared with
the reference over every buffer they were pushed.
"""
import time
from typing import Dict

import numpy as np
import torch

from nwsbench import contours, counts, harness, weights
from nwsbench.reference import stream as ref_stream


def run(ctx) -> Dict:
    from neural_waveshaping_synthesis_tpu_torch.streaming import PipelinedStreamer, StreamingSynth

    mix, m, dev, seed = ctx.cell["traffic_params"], ctx.config["model"], ctx.device, ctx.seed
    n, k, hop = mix["streams"], mix["buffer_frames"], m["control_hop"]
    frame_rate = m["sample_rate"] / hop
    tree = weights.draw(m, harness.seed_of(seed, 7), dev)
    model = harness.build_model(ctx.config, tree, dev, mix["fused"]).eval()
    synth = StreamingSynth(model, k)
    ctx.mark("set-up: weights drawn, model built")
    params = contours.draw_params(seed, (4,), n, mix)
    offsets = contours.stream_offsets(seed, n, m["n_harmonics"], dev)
    noise_gen = contours.stream_noise(seed, dev)
    enqueue_s = []
    timing = [False]

    def step(state, f0, control, ir_spectra):
        t0 = time.perf_counter()
        with harness.span("stream.step"):
            noise = torch.rand((n, k * hop), generator=noise_gen, device=dev)
            out = synth.step(state, f0, control, ir_spectra, noise=noise)
        if timing[0]:
            enqueue_s.append(time.perf_counter() - t0)
        return out

    streamer = PipelinedStreamer(synth, n, torch.Generator(device=dev).manual_seed(0),
                                 depth=mix["depth"], device=dev, step=step)
    streamer.state = synth.init_state(n, streamer.state.generator, phase_offset=offsets,
                                      device=dev)
    rows = np.sort(np.random.default_rng([seed, 3]).choice(n, mix["compare_streams"],
                                                           replace=False))
    kept = []
    pushed = [0]

    def push():
        with harness.span("stream.controls"):
            f0, ctrl = contours.controls(params, np.arange(pushed[0] * k, (pushed[0] + 1) * k),
                                         frame_rate, mix)
        with harness.span("stream.push"):
            audio = streamer.push(f0, ctrl)
        pushed[0] += 1
        if audio is not None:
            kept.append(audio[rows].copy())

    ctx.mark("set-up: warm-up pushes")
    for _ in range(mix["warmup_pushes"]):
        push()
        ctx.mark(f"set-up: warm-up push {pushed[0]} done")
    before = ctx.launch_counts()
    ctx.window_start()
    ctx.tracer.start()
    timing[0] = True
    t0 = time.perf_counter()
    returns = [t0]
    while True:
        push()
        returns.append(time.perf_counter())
        elapsed = returns[-1] - t0
        if ctx.tracer.active and elapsed >= mix["trace_seconds"]:
            ctx.tracer.stop()
        if elapsed >= ctx.seconds:
            break
    window_s = returns[-1] - t0
    timing[0] = False
    ctx.tracer.stop()
    ctx.window_end()
    window_pushes = len(returns) - 1
    for audio in streamer.flush():
        kept.append(audio[rows].copy())
    moved = ctx.launches_moved(before)
    ctx.memory_peak()
    total = pushed[0]
    del streamer, synth, model
    ctx.free()
    got = torch.from_numpy(np.concatenate(kept, axis=-1)).to(dev)  # (S, total*K*hop)
    buf = ref_stream.buffer_nrms(got, ref_stream.sampled(tree, m, mix, seed, n, rows, total, dev),
                                 total)
    cad_ms = np.diff(np.asarray(returns)) * 1e3
    flop = counts.stream_buffer_flop(m, n, k)
    ctx.note(f"N = {n} streams, {window_pushes} pushes in the window, {total} in all; compared "
             f"streams {rows.tolist()} over every buffer")
    worst = float(buf.max())
    limit = ctx.cell["checks"]["buffer_nrms"]
    return {
        "attempted": window_pushes * n,
        "failed": int((~(buf <= limit)).sum()),
        "e2e": {"stream_cadence_p95_ms": harness.percentile(cad_ms, 95)},
        "checks": {"buffer_nrms": worst},
        "layer": {"kind": "stream", "window_s": window_s, "units": window_pushes,
                  "flop": window_pushes * flop, "host_enqueue_s": enqueue_s,
                  "block_shape": (n, k), "launches_moved": moved, "streams": n,
                  "cadence_ms": cad_ms.tolist()},
    }
