#!/usr/bin/env python3
"""Resynthesise a dataset split with the PyTorch/CUDA port: every clip's
controls through a trained checkpoint, written as ``<name>.target.wav`` /
``<name>.output.wav`` pairs (the counterpart of
``scripts/resynthesise_dataset.py``).

    python3 scripts/torch_resynthesise_dataset.py --dataset-path data/shards \\
        --checkpoint checkpoints --output-path resynth [--split test] \\
        [--step 20000] [--use-fast-newt] [--device cpu]

``--checkpoint`` is a reference-format ``.ckpt`` or a checkpoint directory
that ``scripts/torch_train.py`` wrote; from a directory the best-on-val
save is loaded (``training.select_eval_checkpoint``), or the save of
``--step``. The model is built from the gin files (default
``gin/models/newt.gin``) and ``-b`` bindings. Prints each clip's
multi-resolution STFT distance to its target, and their mean.

Every clip is rendered with the same phase offsets and noise, drawn once
from ``--seed``, so a clip's output does not depend on the batch it rides
in or on ``--batch-size``; the last batch is not padded. Runs on the card
unless ``--device cpu`` is given (without a card the default raises).
"""
import argparse
import os
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataset  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.ops.oscillator import draw_phase_offset  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import (  # noqa: E402
    multi_resolution_stft_loss,
    select_eval_checkpoint,
)
from neural_waveshaping_synthesis_tpu_torch.training.logging import write_wav  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/models/newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra binding applied after the files")
    ap.add_argument("--dataset-path", required=True, help="dataset root (the shard layout)")
    ap.add_argument("--instrument", default="", help="URMP instrument folder under the root")
    ap.add_argument("--split", default="test")
    ap.add_argument("--checkpoint", required=True,
                    help="a reference-format .ckpt, or a checkpoint directory of the trainer")
    ap.add_argument("--step", type=int, default=None,
                    help="the save of this step (directories; default: the best-on-val save)")
    ap.add_argument("--output-path", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--use-fast-newt", action="store_true",
                    help="render through the baked 4096-point FastNEWT table")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/models/newt.gin"]
    return args


def run(argv=None) -> Dict:
    """Resynthesise -> {"checkpoint", "names", "outputs" (float32 arrays),
    "distances" (per clip), "phase_offset" and "noise" (the draws every
    clip shares, float32 arrays), "batch_s" (each batch's render, wall
    time), "render_s" (their sum)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    for path in args.gin_file:
        gin.parse_config_file(path)
    for binding in args.gin_binding:
        gin.parse_config(binding)
    gin.validate_config()

    path = args.checkpoint
    if os.path.isdir(path):
        path = select_eval_checkpoint(path, args.step)
        print(f"[resynthesise] {path} (best-on-val unless --step is given)", flush=True)
    params, _, _, _ = load_checkpoint(path)
    model = NeuralWaveshaping()
    model.load_params(params)
    model = model.to(device).eval()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    root = os.path.join(args.dataset_path, args.instrument) if args.instrument else args.dataset_path
    dataset = GeneralDataset(root, args.split, load_to_memory=False)
    n = len(dataset)
    if not n:
        raise ValueError(f"the {args.split} split of {root} has no clip")
    os.makedirs(args.output_path, exist_ok=True)
    sr, hop = int(model.sample_rate), model.control_hop
    generator = torch.Generator().manual_seed(args.seed)
    offset = draw_phase_offset(model.osc.n_harmonics, generator, device)
    noise = None
    names, outputs, distances, batch_s = [], [], [], []
    with torch.inference_mode():
        table = model.newt.bake_lookup_table() if args.use_fast_newt else None
        for start in range(0, n, args.batch_size):
            idx = np.arange(start, min(start + args.batch_size, n))
            batch = dataset.batch(idx)
            f0 = torch.from_numpy(np.ascontiguousarray(batch["f0"])).to(device)
            control = torch.from_numpy(np.ascontiguousarray(batch["control"])).to(device)
            target = torch.from_numpy(batch["audio"]).to(device)
            if noise is None:
                noise = torch.rand(f0.shape[1] * hop - 1, generator=generator).to(device)
            t0 = time.perf_counter()
            recon = model(f0, control, phase_offset=offset, noise=noise, lookup_table=table)
            audio = recon.cpu().numpy()
            batch_s.append(time.perf_counter() - t0)
            for row, i in enumerate(idx):
                distances.append(float(multi_resolution_stft_loss(recon[row:row + 1],
                                                                  target[row:row + 1])))
                name = dataset.names[i]
                write_wav(os.path.join(args.output_path, f"{name}.target.wav"), batch["audio"][row], sr)
                write_wav(os.path.join(args.output_path, f"{name}.output.wav"), audio[row], sr)
                names.append(name)
                outputs.append(audio[row])
            print(f"[resynthesise] {idx[-1] + 1}/{n}", flush=True)
    print(f"[resynthesise] mean multi-res STFT distance: {float(np.mean(distances)):.4f} "
          f"over {n} clips", flush=True)
    return {"checkpoint": path, "names": names, "outputs": outputs, "distances": distances,
            "phase_offset": offset.cpu().numpy(), "noise": noise.cpu().numpy(),
            "batch_s": batch_s, "render_s": sum(batch_s)}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
