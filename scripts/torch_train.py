#!/usr/bin/env python3
"""Train a NEWT model with the PyTorch/CUDA port, configured by the repo's
gin files (the counterpart of ``scripts/train.py``).

    python3 scripts/torch_train.py --gin-file gin/train/train_newt.gin \\
        --dataset-path data/shards [-b "NEWT.fused = 'full_lane'"] \\
        [-b "TrainConfig.max_steps = 2000"] [--device cpu] \\
        [--no-load-data-to-memory] [--restore-checkpoint] [--with-wandb]

The gin files and ``-b`` bindings are parsed in order, checked
(``validate_config``: a binding no configurable takes is reported), and
printed; then the model (``get_model``, bound to ``@NeuralWaveshaping`` by
``gin/train/train_newt.gin``), the ``TrainConfig`` and the data module are
built from them and ``Trainer.fit`` runs. Metrics go to stdout and to
``<log-dir>/metrics.csv`` with the validation audio beside it; checkpoints
(``last.ckpt``, ``best.ckpt`` and the ``TrainConfig.keep_n_checkpoints``
best-on-val ``step=<n>.ckpt``) to ``TrainConfig.checkpoint_dir``.

``NEWT.fused`` picks the NEWT kernels on the card: ``'full_lane_cr'`` (the
recipe) and ``'cr'`` the control-rate pair, ``'full_lane'``, ``'fl'`` and
``True`` the audio-rate pair, ``False`` the plain chain. Runs on the card
unless ``--device cpu`` is given (without a card the default raises).
``--device`` names the device; the JAX CLI's ``--device`` counted TPUs.

``--restore-checkpoint`` resumes from the newest save in the checkpoint
directory (``last.ckpt`` or a retained ``step=<n>.ckpt``), with its
optimizer state, and continues to ``TrainConfig.max_steps``; with no save
there it starts fresh. ``--no-load-data-to-memory`` reads each batch's
shards from disk as it is needed (corpora larger than host memory).
``--with-wandb`` also logs to Weights & Biases (it needs
``wandb`` installed). Evaluate a run with
``scripts/torch_resynthesise_dataset.py --checkpoint <checkpoint_dir>``.

Data-parallel over several cards, one process per card:

    torchrun --nproc_per_node 8 scripts/torch_train.py --dataset-path ...

Under ``torchrun`` (``WORLD_SIZE`` in the environment, at any world size)
each process joins the process group, NCCL on ``cuda:$LOCAL_RANK`` (gloo
with ``--device cpu``), and trains its rows of each global batch
(``GeneralDataModule.batch_size`` stays the global batch); rank 0 alone
prints the config and the metrics and writes logs and checkpoints. Without
``torchrun`` one process trains on one card, and raises when it sees more
(``TrainConfig.data_parallel``).
"""
import argparse
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.convert import load_checkpoint  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule, URMPDataModule  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.parallel import create_mesh  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import (  # noqa: E402
    ConsoleLogger,
    CSVLogger,
    TrainConfig,
    Trainer,
    WandbLogger,
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
    ap.add_argument("--load-data-to-memory", action=argparse.BooleanOptionalAction, default=True,
                    help="stack each split in host memory (default); with "
                         "--no-load-data-to-memory each batch reads its shards from disk")
    ap.add_argument("--restore-checkpoint", action="store_true",
                    help="resume from the newest checkpoint in TrainConfig.checkpoint_dir")
    ap.add_argument("--with-wandb", action="store_true", help="also log to Weights & Biases")
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/train/train_newt.gin"]
    return args


def join_process_group(device: str) -> str:
    """Under torchrun: join its process group (NCCL for the card, gloo for
    the CPU) -> this rank's device."""
    if device == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl", init_method="env://")
        return f"cuda:{local_rank}"
    dist.init_process_group("gloo", init_method="env://")
    return device


def main(argv=None) -> int:
    args = parse_args(argv)
    under_torchrun = "WORLD_SIZE" in os.environ
    device = join_process_group(args.device) if under_torchrun else args.device
    try:
        return train(args, device)
    finally:
        if under_torchrun:
            dist.destroy_process_group()


def train(args: argparse.Namespace, device: str) -> int:
    for path in args.gin_file:
        gin.parse_config_file(path)
    for binding in args.gin_binding:
        gin.parse_config(binding)
    gin.validate_config()
    mesh = create_mesh()
    rank0 = mesh.rank == 0
    if rank0:
        print(gin.operative_config_str(), flush=True)

    cfg = TrainConfig(**({"checkpoint_dir": args.checkpoint_dir} if args.checkpoint_dir else {}))
    model = get_model(generator=torch.Generator().manual_seed(cfg.seed))
    if args.urmp:
        data = URMPDataModule(args.dataset_path, args.instrument,
                              load_to_memory=args.load_data_to_memory)
    else:
        data = GeneralDataModule(args.dataset_path, load_to_memory=args.load_data_to_memory)
    initial = load_checkpoint(args.from_torch_checkpoint)[0] if args.from_torch_checkpoint else None
    loggers = []
    if rank0:
        loggers = [ConsoleLogger(), CSVLogger(args.log_dir)]
        if args.with_wandb:
            loggers.append(WandbLogger())
    trainer = Trainer(model, cfg, device=device, loggers=loggers, mesh=mesh)
    if rank0:
        print(f"[train] data-parallel over {mesh.world_size} device(s); {device}: "
              f"max_steps={cfg.max_steps} batch={data.batch_size} "
              f"NEWT.fused={model.newt.fused!r} load_to_memory={data.load_to_memory}", flush=True)
    trainer.fit(data, restore=args.restore_checkpoint, initial_params=initial)
    if rank0:
        print(f"[train] finished at step {trainer.step}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
