#!/usr/bin/env python3
"""Train a NEWT model with the PyTorch/CUDA port, configured by the repo's
gin files (the counterpart of ``scripts/train.py``).

    python3 scripts/torch_train.py --gin-file gin/train/train_newt.gin \\
        --dataset-path data/shards [-b "NEWT.fused = 'full_lane'"] \\
        [-b "TrainConfig.max_steps = 2000"] [--device cpu]

The gin files and ``-b`` bindings are parsed in order, checked
(``validate_config``: a binding no configurable takes is reported), and
printed; then the model (``get_model``, bound to ``@NeuralWaveshaping`` by
``gin/train/train_newt.gin``), the ``TrainConfig`` and the data module are
built from them and ``Trainer.fit`` runs. Metrics go to stdout and to
``<log-dir>/metrics.csv`` with the validation audio beside it; checkpoints
(``last.ckpt``, ``best.ckpt``) to ``TrainConfig.checkpoint_dir``.

``NEWT.fused`` picks the NEWT kernels on the card: ``'full_lane_cr'`` (the
recipe) and ``'cr'`` the control-rate pair, ``'full_lane'``, ``'fl'`` and
``True`` the audio-rate pair, ``False`` the plain chain. Runs on the card
unless ``--device cpu`` is given (without a card the default raises).
``--device`` names the device; the JAX CLI's ``--device`` counted TPUs.
Not ported: resume (``--restore-checkpoint``) and wandb
(``--with-wandb``), which raise.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule, URMPDataModule  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import (  # noqa: E402
    ConsoleLogger,
    CSVLogger,
    TrainConfig,
    Trainer,
)


@gin.configurable
def get_model(model=NeuralWaveshaping, generator=None):
    return model(generator=generator)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/train/train_newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra binding applied after the files, e.g. "
                         "\"NEWT.fused = 'full_lane'\" or 'TrainConfig.max_steps = 2000'")
    ap.add_argument("--dataset-path", required=True, help="dataset root (the shard layout)")
    ap.add_argument("--urmp", action="store_true",
                    help="dataset-path is a URMP root with one folder per instrument")
    ap.add_argument("--instrument", default="vn")
    ap.add_argument("--checkpoint-dir", default=None, help="overrides TrainConfig.checkpoint_dir")
    ap.add_argument("--log-dir", default="logs", help="metrics.csv and audio snapshots")
    ap.add_argument("--from-torch-checkpoint", default="",
                    help="start from a reference-format .ckpt (fine-tune), with a fresh optimizer")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--restore-checkpoint", action="store_true", help="not ported: raises")
    ap.add_argument("--with-wandb", action="store_true", help="not ported: raises")
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/train/train_newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.restore_checkpoint:
        raise NotImplementedError("resume is not ported yet (ROADMAP.md queue 1, Training runtime)")
    if args.with_wandb:
        raise NotImplementedError("wandb logging is not ported (ROADMAP.md queue 1, Training runtime)")
    for path in args.gin_file:
        gin.parse_config_file(path)
    for binding in args.gin_binding:
        gin.parse_config(binding)
    gin.validate_config()
    print(gin.operative_config_str(), flush=True)

    cfg = TrainConfig(**({"checkpoint_dir": args.checkpoint_dir} if args.checkpoint_dir else {}))
    model = get_model(generator=torch.Generator().manual_seed(cfg.seed))
    if args.urmp:
        data = URMPDataModule(args.dataset_path, args.instrument)
    else:
        data = GeneralDataModule(args.dataset_path)
    initial = load_checkpoint(args.from_torch_checkpoint)[0] if args.from_torch_checkpoint else None
    trainer = Trainer(model, cfg, device=args.device,
                      loggers=[ConsoleLogger(), CSVLogger(args.log_dir)])
    print(f"[train] {args.device}: max_steps={cfg.max_steps} batch={data.batch_size} "
          f"NEWT.fused={model.newt.fused!r}", flush=True)
    trainer.fit(data, initial_params=initial)
    print(f"[train] finished at step {trainer.step}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
