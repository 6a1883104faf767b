"""Traffic ``render``: offline resynthesis, a closed loop of back-to-back
batches through the path of ``scripts/torch_resynthesise_dataset.py``:
each batch's f0 and control drawn on the host, copied to the card, the
port's ``NeuralWaveshaping.forward`` under ``torch.inference_mode()`` (with
the FastNEWT table the configuration asks for, baked in set-up), and the
audio copied back to the host, into one pinned buffer the client keeps; the
client draws the next batch while the card renders this one.

Batch i's contours come from (seed, 1, i) and its phase offsets and noise
from a card generator seeded from (seed, 2, i), so any batch can be drawn
again. Set-up renders the mix's warm-up batches through the same path. A
sample of the window's batches, drawn from the seed, is kept and compared
with the reference once the window has closed.
"""
import time
from typing import Dict

import numpy as np
import torch

from nwsbench import contours, counts, harness, weights
from nwsbench.reference import newt as ref
from nwsbench.reference.train import matmul_precision


def batch_inputs(seed: int, i: int, mix: Dict, m: Dict, device):
    """Batch i: f0 (B, Tc) and control (B, Tc, 2) on the host, and its (H,)
    phase offsets and (Tc*hop - 1,) noise on ``device``."""
    params = contours.draw_params(seed, (1, i), mix["batch"], mix)
    f0, ctrl = contours.controls(params, np.arange(mix["frames"]),
                                 m["sample_rate"] / m["control_hop"], mix)
    gen = torch.Generator(device=device).manual_seed(harness.seed_of(seed, 2, i))
    phase = torch.rand(m["n_harmonics"], generator=gen, device=device) * (2 * np.pi) - np.pi
    noise = torch.rand(mix["frames"] * m["control_hop"] - 1, generator=gen, device=device)
    return f0, ctrl, phase, noise


def reference_audio(tree: Dict, m: Dict, mix: Dict, seed: int, i: int, device,
                    table_size, tf32: bool) -> torch.Tensor:
    """The reference's (B, Ta) audio of batch i, in blocks of rows."""
    f0, ctrl, phase, noise = batch_inputs(seed, i, mix, m, device)
    out = []
    with torch.no_grad(), matmul_precision(tf32):
        table = ref.bake_table(tree["newt"]["shaping_fn"], table_size) if table_size else None
        for r in range(0, len(f0), mix["reference_rows"]):
            rows = slice(r, r + mix["reference_rows"])
            out.append(ref.forward(tree, m, torch.from_numpy(f0[rows]).to(device),
                                   torch.from_numpy(ctrl[rows]).to(device), phase, noise, table))
    return torch.cat(out)


def run(ctx) -> Dict:
    mix, m, dev, seed = ctx.cell["traffic_params"], ctx.config["model"], ctx.device, ctx.seed
    tree = weights.draw(m, harness.seed_of(seed, 7), dev)
    model = harness.build_model(ctx.config, tree, dev, mix["fused"]).eval()
    table_size = ctx.config.get("fast_newt_table")
    ctx.mark("set-up: weights drawn, model built")
    with torch.inference_mode():
        table = model.newt.bake_lookup_table(table_size) if table_size else None
    rng = np.random.default_rng([seed, 3])
    every = mix["sample_every"]
    offset = int(rng.integers(every))
    kept: Dict[int, np.ndarray] = {}
    enqueue_s = []

    # the client keeps one pinned host buffer for the audio and draws batch
    # i + 1 while the card renders batch i: the host's part of a batch is
    # then the copy alone, and no fresh host memory is faulted in per batch
    host = torch.empty((mix["batch"], mix["frames"] * m["control_hop"]),
                       pin_memory=ctx.cuda)

    def inputs(i: int):
        with harness.span("render.inputs"):
            return batch_inputs(seed, i, mix, m, dev)

    def render(i: int, drawn, timed: bool):
        """Batch i from its drawn inputs -> batch i + 1's inputs; its audio
        is in ``host``."""
        f0, ctrl, phase, noise = drawn
        with harness.span("render.to_device"):
            f0_d = torch.from_numpy(f0).to(dev)
            ctrl_d = torch.from_numpy(ctrl).to(dev)
        with torch.inference_mode(), harness.span("render.forward"):
            t0 = time.perf_counter()
            audio = model(f0_d, ctrl_d, phase_offset=phase, noise=noise, lookup_table=table)
            if timed:
                enqueue_s.append(time.perf_counter() - t0)
        drawn = inputs(i + 1)
        with harness.span("render.to_host"):
            host.copy_(audio)
        return drawn

    ctx.mark("set-up: warm-up batches")
    first = mix["warmup_batches"]
    drawn = inputs(0)
    for i in range(first):
        drawn = render(i, drawn, False)
        ctx.mark(f"set-up: warm-up batch {i} done")
    before = ctx.launch_counts()
    ctx.window_start()
    ctx.tracer.start()
    t0 = time.perf_counter()
    i = first
    while True:
        drawn = render(i, drawn, True)
        if (i - first) % every == offset and len(kept) < mix["max_kept"]:
            kept[i] = host.numpy().copy()
        i += 1
        elapsed = time.perf_counter() - t0
        if ctx.tracer.active and elapsed >= mix["trace_seconds"]:
            ctx.tracer.stop()
        if elapsed >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    if not kept:  # a window shorter than the sample's offset: its last batch
        kept[i - 1] = host.numpy().copy()
    ctx.tracer.stop()
    ctx.window_end()
    batches = i - first
    moved = ctx.launches_moved(before)
    ctx.memory_peak()
    del model, table
    ctx.free()
    gaps = []
    for j, audio in kept.items():
        want = reference_audio(tree, m, mix, seed, j, dev, table_size, False)
        gaps.append(harness.nrms(torch.from_numpy(audio).to(dev), want).cpu().numpy())
    gaps = np.concatenate(gaps) if gaps else np.asarray([np.inf])
    limit = ctx.cell["checks"]["audio_nrms"]
    seconds_audio = batches * mix["batch"] * mix["frames"] * m["control_hop"] / m["sample_rate"]
    flop = counts.forward_flop(m, mix["batch"], mix["frames"], lookup=bool(table_size))
    ctx.note(f"compared {len(gaps)} clips of batches {sorted(kept)}")
    return {
        "attempted": batches * mix["batch"],
        "failed": int(np.sum(~(gaps <= limit))),
        "e2e": {"render_x_realtime": seconds_audio / window_s},
        "checks": {"audio_nrms": float(np.max(gaps))},
        "layer": {"kind": "render", "window_s": window_s, "units": batches,
                  "flop": batches * flop, "host_enqueue_s": enqueue_s,
                  "block_shape": (mix["batch"], mix["frames"]), "launches_moved": moved},
    }
