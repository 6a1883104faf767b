#!/usr/bin/env python3
"""Timbre transfer with the PyTorch/CUDA port: a wav in, the checkpoint's
instrument out, as a 16-kHz 16-bit wav.

    python3 scripts/torch_timbre_transfer.py --input voice.wav \\
        --checkpoint docs/results/run120k_cr/checkpoint/best.ckpt \\
        --output out.wav --octave-shift 1 [--use-fast-newt] [--streaming]

Runs on the card unless ``--device cpu`` is given (without a card the
default raises). Prints the x real time of the render, or with
``--streaming`` the stream's cadence and latency. The gin files (default
``gin/models/newt.gin``) and ``-b`` bindings are parsed in order and
checked; they reach the model and the feature extractors, so a data gin
file or ``-b "extract_f0_with_yin.threshold = 0.2"`` sets the extraction
too (the explicit f0 ceiling and loudness frame win). ``--f0-extractor
crepe`` needs a torchcrepe ``.pth`` (``--crepe-weights`` or
``$CREPE_WEIGHTS``). Not ported: time-sharded rendering.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
from scipy.io import wavfile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from neural_waveshaping_synthesis_tpu_torch import minigin as gin  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.inference import (  # noqa: E402
    ControlAdjustments,
    Synthesizer,
    stream_timbre_transfer,
    timbre_transfer,
)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Peak-normalise to 0.9 of full scale and write 16-bit PCM."""
    peak = np.abs(audio).max()
    scaled = audio / peak * 0.9 if peak > 0 else audio
    wavfile.write(path, int(sample_rate), (scaled * 32767).astype(np.int16))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/models/newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra binding applied after the files")
    ap.add_argument("--input", dest="input_path", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="reference-format .ckpt (statistics read from its directory)")
    ap.add_argument("--output", dest="output_path", required=True)
    ap.add_argument("--octave-shift", type=int, default=0)
    ap.add_argument("--loudness-scale", type=float, default=1.0)
    ap.add_argument("--loudness-floor", type=float, default=0.0)
    ap.add_argument("--loudness-conf-filter", type=float, default=0.0)
    ap.add_argument("--pitch-conf-filter", type=float, default=0.0)
    ap.add_argument("--pitch-smoothing", type=int, default=0)
    ap.add_argument("--loudness-smoothing", type=int, default=0)
    ap.add_argument("--f0-extractor", default="yin", choices=["yin", "crepe"])
    ap.add_argument("--crepe-weights", default=None,
                    help="a torchcrepe .pth (or the JAX package's .npz cache) for --f0-extractor crepe")
    ap.add_argument("--use-fast-newt", action="store_true",
                    help="render through the baked 4096-point FastNEWT table")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streaming", action="store_true",
                    help="render buffer by buffer through the pipelined streamer")
    ap.add_argument("--buffer-size", type=int, default=1024,
                    help="streaming buffer in samples (a multiple of the 128-sample hop)")
    ap.add_argument("--pipeline-depth", type=int, default=4,
                    help="buffers in flight with --streaming")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/models/newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.streaming and args.use_fast_newt:
        raise SystemExit("--streaming and --use-fast-newt are mutually exclusive")
    for path in args.gin_file:
        gin.parse_config_file(path)
    for binding in args.gin_binding:
        gin.parse_config(binding)
    gin.validate_config()
    if args.crepe_weights:
        gin.bind_parameter("extract_f0_with_crepe.weights_path", args.crepe_weights)
    synth = Synthesizer.from_checkpoint(args.checkpoint, device=args.device)
    sr, audio = wavfile.read(args.input_path)
    adjustments = ControlAdjustments(
        octave_shift=args.octave_shift,
        loudness_scale=args.loudness_scale,
        loudness_floor=args.loudness_floor,
        loudness_conf_filter=args.loudness_conf_filter,
        pitch_conf_filter=args.pitch_conf_filter,
        pitch_smoothing=args.pitch_smoothing,
        loudness_smoothing=args.loudness_smoothing,
    )
    rate = synth.model.sample_rate
    if args.streaming:
        out, stats = stream_timbre_transfer(
            synth, audio, sr, adjustments, args.f0_extractor, args.seed,
            args.buffer_size, args.pipeline_depth,
        )
        write_wav(args.output_path, out, rate)
        print(
            f"Streamed {len(out) / rate:.2f}s to {args.output_path} in "
            f"{stats['n_buffers']} x {stats['buffer_size']}-sample buffers "
            f"(depth {stats['pipeline_depth']}) on {synth.device}: cadence p50 "
            f"{stats['cadence_p50_ms']:.2f} ms / p95 {stats['cadence_p95_ms']:.2f} ms vs "
            f"{stats['buffer_budget_ms']:.1f} ms budget, first-buffer latency "
            f"{stats['first_buffer_latency_ms']:.1f} ms, {stats['x_realtime']:.0f}x real time"
        )
        return 0
    out, speed = timbre_transfer(
        synth, audio, sr, adjustments, args.f0_extractor, args.use_fast_newt, args.seed
    )
    write_wav(args.output_path, out, rate)
    print(f"Synthesized {len(out) / rate:.2f}s to {args.output_path} on {synth.device} "
          f"({speed:.0f}x faster than real time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
