#!/usr/bin/env python3
"""Build a dataset from a directory of wav files with the PyTorch/CUDA
port (the counterpart of ``scripts/create_dataset.py``).

    python3 scripts/torch_create_dataset.py \\
        --gin-file gin/data/urmp_4second_crepe.gin \\
        --data-directory wavs --output-directory data/shards \\
        --f0-extractor yin|pyin|crepe [--crepe-weights full.pth] [--device cpu]

Writes ``<out>/{train,val,test}/{audio,control}/*.npy`` (control shards
(19, T): f0, loudness, confidence, 16 MFCCs) and ``data_mean.npy`` /
``data_std.npy``, the layout ``scripts/torch_train.py --dataset-path``
reads. The gin files and ``-b`` bindings are parsed in order and checked
(``validate_config``); ``--f0-extractor`` then overrides
``preprocess_audio.f0_extractor`` (the data gin file names CREPE, which
needs a torchcrepe ``.pth`` or the JAX package's ``.npz`` cache:
``--crepe-weights`` or ``$CREPE_WEIGHTS``). Features run on the card
unless ``--device cpu`` is given (without a card the default raises).
``--seed`` seeds the global generators, as the JAX CLI's does; the split
takes ``create_dataset.seed`` (0 unless bound).
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import create_dataset  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.utils import seed_all  # noqa: E402

DATA_GIN = "gin/data/urmp_4second_crepe.gin"


def add_common_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--gin-file", action="append", default=None,
                    help=f"gin file, repeatable (default: {DATA_GIN})")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra binding applied after the files, e.g. "
                         "'preprocess_audio.hop_length_in_seconds = 2'")
    ap.add_argument("--data-directory", required=True)
    ap.add_argument("--output-directory", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f0-extractor", default=None, choices=["crepe", "yin", "pyin"],
                    help="override the gin-configured f0 extractor")
    ap.add_argument("--crepe-weights", default=None,
                    help="a torchcrepe .pth (or the JAX package's .npz cache)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def configure(args: argparse.Namespace) -> None:
    """Parse the gin files and bindings, check them, then apply the
    extractor and weights options and seed the generators."""
    for path in args.gin_file or [DATA_GIN]:
        gin.parse_config_file(path)
    for binding in args.gin_binding:
        gin.parse_config(binding)
    gin.validate_config()
    if args.f0_extractor:
        gin.parse_config(f"preprocess_audio.f0_extractor = @extract_f0_with_{args.f0_extractor}")
    if args.crepe_weights:
        # bound directly: a path in gin syntax would break on quotes
        gin.bind_parameter("extract_f0_with_crepe.weights_path", args.crepe_weights)
    seed_all(args.seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_arguments(ap)
    args = ap.parse_args(argv)
    configure(args)
    files = [os.path.join(args.data_directory, f) for f in sorted(os.listdir(args.data_directory))
             if f.lower().endswith(".wav")]
    if not files:
        raise SystemExit(f"no wav files in {args.data_directory}")
    print(f"[create_dataset] {len(files)} files -> {args.output_directory} on {args.device}",
          flush=True)
    create_dataset(files, args.output_directory, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
