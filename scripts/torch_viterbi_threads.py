#!/usr/bin/env python3
"""The Viterbi decode on the CPU in several processes at once, by torch's
intra-op thread count: how the decode's small per-frame ops fare when
processes share the cores (as the tier-1 run's parallel workers do).

    python3 scripts/torch_viterbi_threads.py [--processes 6] [--threads 8,1] [--frames 513]

Each process decodes a random (frames, 360) posteriorgram once after a
short warm-up and reports its seconds; one JSON object per thread count
with every process's time.
"""
import argparse
import json
import multiprocessing
import sys
import time
from pathlib import Path


def decode_seconds(threads: int, frames: int) -> float:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from neural_waveshaping_synthesis_tpu_torch.models import crepe

    torch.set_num_threads(threads)
    probs = torch.rand(frames, 360, generator=torch.Generator().manual_seed(0))
    crepe.viterbi_decode(probs[:10])
    t0 = time.perf_counter()
    crepe.viterbi_decode(probs)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=6)
    ap.add_argument("--threads", default="8,1")
    ap.add_argument("--frames", type=int, default=513)
    args = ap.parse_args(argv)
    ctx = multiprocessing.get_context("spawn")
    for threads in (int(t) for t in args.threads.split(",")):
        with ctx.Pool(args.processes) as pool:
            seconds = pool.starmap(decode_seconds, [(threads, args.frames)] * args.processes)
        print(json.dumps({"processes": args.processes, "threads": threads, "frames": args.frames,
                          "cpu_count": multiprocessing.cpu_count(), "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
