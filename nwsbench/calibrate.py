#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, apart from
the program's own runs: the control (the plain reference put in the
program's place and computed with TF32 products, the precision below the
configuration's float32) and, for a training cell, planted faults (each
step's loss over half of its batch, the mean over the rest; a chunk's slot
that does not advance, so step 3 runs on step 2's batch and draws), each
against the float32 reference at the cell's own size, on the card:

    python3 nwsbench/calibrate.py --workload <cell> --seeds 1,2,3 [--pushes 400]

One JSON line per seed with the cell's numbers. ``--pushes`` is a stream
cell's count of buffers (warm-up and window). The benchmark's runs do not
run this; the sound runs' readings come from ``run.py`` itself.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nwsbench import harness, weights  # noqa: E402
from nwsbench.reference import stream as ref_stream  # noqa: E402
from nwsbench.reference import train as ref_train  # noqa: E402
from nwsbench.traffic import render, train  # noqa: E402


def calibrate_train(cell, m, seed, dev):
    mix = cell["traffic_params"]
    data = train.make_split(seed, 0, mix["train_clips"], mix, m, dev)
    val = train.make_split(seed, 1, mix["val_clips"], mix, m, dev)
    ctrl, _, mean, std = train.zscore(data, val)
    tree = weights.draw(m, harness.seed_of(seed, 7), dev)

    def steps(**kw):
        return ref_train.first_steps(tree, m, data["audio"], ctrl, mean, std, mix, seed, 3,
                                     dev, **kw)

    def numbers(side):
        # the replayed steps' losses against the float32 reference at the
        # side's own parameters before each, as a run compares the program's
        replay = {s: ref_train.loss_at(tree, side["states"][s], m, data["audio"], ctrl, mean,
                                       std, mix, seed, s, dev) for s in (1, 2)}
        return harness.train_checks(side["losses"], side["grad1"], side["change3"], ref,
                                    replay)[0]

    ref = steps()
    return {"control": numbers(steps(tf32=True)),
            "half_batch": numbers(steps(rows_kept=mix["batch"] // 2)),
            "stale_slot": numbers(steps(stale_slot=True))}


def calibrate_render(cell, config, seed, dev):
    mix, m = cell["traffic_params"], config["model"]
    tree = weights.draw(m, harness.seed_of(seed, 7), dev)
    offset = int(np.random.default_rng([seed, 3]).integers(mix["sample_every"]))
    worst = 0.0
    for q in range(mix["max_kept"]):
        j = mix["warmup_batches"] + offset + q * mix["sample_every"]
        args = (tree, m, mix, seed, j, dev, config.get("fast_newt_table"))
        gap = harness.nrms(render.reference_audio(*args, tf32=True),
                           render.reference_audio(*args, tf32=False))
        worst = max(worst, float(gap.max()))
    return {"control": {"audio_nrms": worst}}


def calibrate_stream(cell, m, seed, dev, pushes):
    mix = cell["traffic_params"]
    n = mix["streams"]
    tree = weights.draw(m, harness.seed_of(seed, 7), dev)
    rows = np.sort(np.random.default_rng([seed, 3]).choice(n, mix["compare_streams"],
                                                           replace=False))
    want, ctl = (ref_stream.sampled(tree, m, mix, seed, n, rows, pushes, dev, tf32=tf32)
                 for tf32 in (False, True))
    return {"control": {"buffer_nrms": float(ref_stream.buffer_nrms(ctl, want, pushes).max())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pushes", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card; TF32, the control's precision, exists only there",
              file=sys.stderr)
        return 1
    cell, config = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell["traffic"] == "train":
            out = calibrate_train(cell, config["model"], seed, dev)
        elif cell["traffic"] == "render":
            out = calibrate_render(cell, config, seed, dev)
        else:
            out = calibrate_stream(cell, config["model"], seed, dev, args.pushes)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
