#!/usr/bin/env python3
"""Where the training step's milliseconds go, per subgraph, with the
PyTorch/CUDA port (the counterpart of ``scripts/profile_train_step.py``).

    python3 scripts/torch_profile_train_step.py [--batch-size 8] [--n-frames 500]
        [--probe full_train_step --probe newt_fwd_bwd_fused_cr] [--bf16] [-b ...] [--device cpu]

Each probe is timed by ``utils.profiling.differential_loop_ms``: an eager
loop of the probe at ``--n-long`` and ``--n-short`` iterations, each timed
between CUDA events with one synchronisation, best of ``--repeats``, and the
per-iteration time the difference over the difference in lengths. On the
card that is the queued loop's pace: the host's launch time where the host
sets it (most probes here; PERF.md section 5), not device-only time. An
eager loop hoists nothing and drops no dead code, so JAX's carry tricks are
not needed; ``full_train_step`` threads the real train state (the
parameters and Adam's moments move every iteration).

The probes are JAX's, by name. ``full_train_step`` is one
``Trainer.train_step`` on a fixed batch (its copy to the card and the CPU
generator's draws included); the component probes run the subgraph alone,
forward or forward + backward (autograd of the sum of the output into
every parameter and the input the JAX probe differentiates), so their sum
need not be the step. ``newt_fwd`` / ``newt_fwd_bwd`` run NEWT with the
model's own ``NEWT.fused`` (the recipe's ``"full_lane_cr"``);
``newt_*_fused`` with ``True``, ``newt_*_fused_fl`` with ``"full_lane"``
(on the card kernels 5 and 6) and ``newt_*_fused_cr`` with ``"full_lane_cr"``
(kernels 1 and 2). Each probe that should launch a kernel on the card must
move its launch counter or the script exits non-zero. Not ported: JAX's
``--loss-variant`` (its einsum or convolution formulation of the polyphase
spectrogram on the TPU); the port's loss has one formulation (cuFFT), timed
by ``loss_fwd`` and ``loss_fwd_bwd``.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neural_waveshaping_synthesis_tpu_torch.device import resolve_device  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.kernels import launch_counts  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.models import NeuralWaveshaping  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.ops import linear_upsample  # noqa: E402
from neural_waveshaping_synthesis_tpu_torch.training import (  # noqa: E402
    TrainConfig,
    Trainer,
    multi_resolution_stft_loss,
)
from neural_waveshaping_synthesis_tpu_torch.utils.profiling import (  # noqa: E402
    differential_loop_ms,
    require_launches,
)
from torch_time_forward_pass import FORWARD_KERNELS  # noqa: E402  (same folder)
from torch_time_train_step import BACKWARD_KERNELS, parse_gin  # noqa: E402

CR, CR_BWD = ("film_shaper_cr.launches",), ("film_shaper_cr.bwd_launches",)
FL, FL_BWD = ("film_shaper_fl.launches",), ("film_shaper_fl.bwd_launches",)


def probe_inputs(b: int, tc: int, hop: int, n_waveshapers: int, emb_width: int):
    """JAX's draws, ``default_rng(0)``: audio, f0, control, the target audio,
    an exciter and an embedding, float32 numpy arrays."""
    rng = np.random.default_rng(0)
    ta = tc * hop
    audio = rng.standard_normal((b, ta)) * 0.1
    f0 = 220.0 * 2.0 ** rng.uniform(0, 2, (b, tc))
    control = rng.standard_normal((b, tc, 2))
    audio_tgt = rng.standard_normal((b, ta)) * 0.1
    exciter = rng.standard_normal((b, ta, n_waveshapers)) * 0.3
    embedding = rng.standard_normal((b, tc, emb_width))
    return [np.ascontiguousarray(a, np.float32)
            for a in (audio, f0, control, audio_tgt, exciter, embedding)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gin-file", action="append", default=None,
                    help="gin file, repeatable (default: gin/train/train_newt.gin)")
    ap.add_argument("--gin-binding", "-b", action="append", default=[],
                    help="extra bindings for A/Bs, e.g. 'NEWT.remat_shaper = True'")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--n-frames", type=int, default=500)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 synthesis hot path")
    ap.add_argument("--n-short", type=int, default=20, help="short loop length")
    ap.add_argument("--n-long", type=int, default=120, help="long loop length")
    ap.add_argument("--repeats", type=int, default=3, help="timed loops per length (best kept)")
    ap.add_argument("--probe", action="append", default=[],
                    help="run only these probes (repeatable); default all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.gin_file = args.gin_file or ["gin/train/train_newt.gin"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    parse_gin(args.gin_file, args.gin_binding, args.bf16)
    model = NeuralWaveshaping(generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainConfig(), device=device)  # TF32 off on the card
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[profile_train_step] device={name} batch={args.batch_size} frames={args.n_frames} "
          f"bf16={args.bf16} loop {args.n_short}/{args.n_long} x best-of-{args.repeats}",
          flush=True)

    b, tc, hop = args.batch_size, args.n_frames, int(model.control_hop)
    ta = tc * hop
    cd = model.block_dtype(torch.float32)
    arrays = probe_inputs(b, tc, hop, model.newt.n_waveshapers, model.embedding.proj.w.shape[-1])
    audio, f0, control, audio_tgt, exciter, embedding = (
        torch.from_numpy(a).to(device) for a in arrays)
    exciter, embedding = exciter.to(cd), embedding.to(cd)
    batch = {"audio": arrays[0], "f0": arrays[1], "control": arrays[2]}
    f0_up = f0.repeat_interleave(hop, dim=1)
    gen = torch.Generator().manual_seed(1)
    offset = torch.rand(model.osc.n_harmonics, generator=gen).to(device)
    newt = model.newt

    def fwd_bwd(f, *inputs, module=None):
        """One forward and one backward of sum(f(*inputs)) into ``inputs``
        and ``module``'s parameters."""
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        params = list(module.parameters()) if module is not None else []
        return torch.autograd.grad(f(*leaves).float().sum(), leaves + params, allow_unused=True)

    def exciter_of(f):
        bank = model.osc(f, phase_offset=offset)
        return model.harmonic_mixer(bank.to(cd))

    def newt_probe(fused, backward):
        if backward:
            return lambda c: fwd_bwd(lambda x: newt(x, embedding, fused=fused), exciter,
                                     module=newt)
        return lambda c: newt(exciter, embedding, fused=fused)

    grads = [torch.randn(p.shape, generator=gen).to(device) for p in trainer.optimizer.params]

    def adam(c):
        for p, g in zip(trainer.optimizer.params, grads):
            p.grad = g
        return trainer.optimizer.step()

    probes = {
        "full_train_step": (lambda c: trainer.train_step(batch)["loss"], FORWARD_KERNELS,
                            BACKWARD_KERNELS),
        "model_fwd": (lambda c: model(f0, control, phase_offset=offset), FORWARD_KERNELS),
        "model_fwd_bwd": (lambda c: fwd_bwd(lambda: model(f0, control, phase_offset=offset),
                                            module=model), BACKWARD_KERNELS),
        "loss_fwd": (lambda c: multi_resolution_stft_loss(audio, audio_tgt),),
        "loss_fwd_bwd": (lambda c: fwd_bwd(lambda x: multi_resolution_stft_loss(x, audio_tgt),
                                           audio),),
        "control_gru_fwd": (lambda c: model.get_embedding(control)[0],),
        "control_gru_fwd_bwd": (lambda c: fwd_bwd(lambda x: model.get_embedding(x)[0],
                                                  control),),
        "exciter_fwd": (lambda c: exciter_of(f0_up),),
        "exciter_fwd_bwd": (lambda c: fwd_bwd(lambda: exciter_of(f0_up),
                                              module=model.harmonic_mixer),),
        "osc_bank_fwd": (lambda c: model.osc(f0_up, phase_offset=offset),),
        "f0_upsample": (lambda c: linear_upsample(f0[..., None], ta),),
        "newt_fwd": (newt_probe(None, False), FORWARD_KERNELS),
        "newt_fwd_bwd": (newt_probe(None, True), BACKWARD_KERNELS),
        "newt_fwd_fused": (newt_probe(True, False), FL),
        "newt_fwd_bwd_fused": (newt_probe(True, True), FL_BWD),
        "newt_fwd_fused_fl": (newt_probe("full_lane", False), FL),
        "newt_fwd_bwd_fused_fl": (newt_probe("full_lane", True), FL_BWD),
        "newt_fwd_fused_cr": (newt_probe("full_lane_cr", False), CR),
        "newt_fwd_bwd_fused_cr": (newt_probe("full_lane_cr", True), CR_BWD),
        "noise_branch_fwd": (lambda c: model.noise_synth(model.h_generator(embedding.float()),
                                                         generator=gen),),
        "reverb_fwd": (lambda c: model.reverb(audio),),
        "adam_update": (adam,),
    }
    selected = args.probe or list(probes)
    unknown = [s for s in selected if s not in probes]
    if unknown:
        raise SystemExit(f"unknown probes {unknown}; available: {list(probes)}")

    width = max(len(s) for s in selected)
    results = {}
    for probe in selected:
        body, *kernels = probes[probe]
        before = launch_counts()
        grad_mode = torch.enable_grad() if "bwd" in probe or probe in (
            "full_train_step", "adam_update") else torch.no_grad()
        with grad_mode:
            ms = differential_loop_ms(body, args.n_short, args.n_long, args.repeats,
                                      device=device)
        results[probe] = ms
        print(f"  {probe:<{width}}  {ms:8.3f} ms", flush=True)
        for group in kernels:
            require_launches(before, group, device)
    total = results.get("full_train_step")
    if total:
        print(f"[profile_train_step] full step {total:.1f} ms ({1000.0 / total:.2f} steps/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
