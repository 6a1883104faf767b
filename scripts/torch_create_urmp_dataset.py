#!/usr/bin/env python3
"""Build one dataset per URMP instrument with the PyTorch/CUDA port (the
counterpart of ``scripts/create_urmp_dataset.py``).

    python3 scripts/torch_create_urmp_dataset.py --data-directory URMP \\
        --output-directory data/urmp [--instruments vn,fl] \\
        [--f0-extractor yin] [--device cpu]

Finds each instrument's separated stems by file name only
(``**/AuSep*_<ins>_*.wav``: the reference also filters the folder name,
which misses pieces whose folder name ends with the code) and writes
``<out>/<ins>/``, the layout ``scripts/torch_train.py --urmp`` reads. The
other options are ``scripts/torch_create_dataset.py``'s.
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch.data import URMP_INSTRUMENTS  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.data.preprocess import create_dataset  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_create_dataset import add_common_arguments, configure  # noqa: E402


def get_instrument_file_list(instrument: str, directory: str):
    return sorted(str(f) for f in Path(directory).glob(f"**/AuSep*_{instrument}_*.wav"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_arguments(ap)
    ap.add_argument("--instruments", default=",".join(URMP_INSTRUMENTS),
                    help="comma-separated instrument codes to process")
    args = ap.parse_args(argv)
    configure(args)
    for instrument in args.instruments.split(","):
        files = get_instrument_file_list(instrument, args.data_directory)
        print(f"[create_urmp_dataset] {instrument}: {len(files)} files", flush=True)
        if files:
            create_dataset(files, os.path.join(args.output_directory, instrument),
                           device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
