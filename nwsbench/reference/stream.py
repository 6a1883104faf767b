"""The plain reference of NEWT streamed buffer by buffer: the whole stream
computed at once with the streaming semantics the port documents (JAX's
``streaming/synth.py``), not step by step, so none of the port's carried
state is read:

* within each buffer f0 and the FiLM parameters ramp linearly from the
  previous control frame to each new one over a hop (``start + (end -
  start) * (o + 1) / hop``), from 0 Hz and a zero FiLM frame at the start;
* the GRU runs over the whole control sequence from a zero state; the
  oscillator's phase is one float64 sum from 0, wrapped before the harmonic
  expansion; each stream has its own (H,) phase offsets;
* the noise: the excitation preceded by ``n_fft - hop`` zeros, framed at
  the hop, each frame filtered by its control frame's windowed FIR, then
  overlap-added and divided by the overlap count n_fft / hop;
* the reverb is the linear convolution with [0, ir], truncated to the
  stream's length.

``sampled`` works out again, from the seed, every input a stream run drew
for a sample of its streams and renders them; ``buffer_nrms`` compares a
side's buffers with that.
"""
from typing import Dict

import numpy as np
import torch

from nwsbench import contours
from nwsbench.reference import newt
from nwsbench.reference.train import matmul_precision


def ramp(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, C) frames -> (B, T*hop, C): segment m ramps from frame m-1
    (zeros for m = 0) to frame m."""
    start = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], dim=1)
    t = ((torch.arange(hop, dtype=torch.float64, device=frames.device) + 1) / hop).float()
    out = start[:, :, None] + (frames - start)[:, :, None] * t[None, None, :, None]
    return out.reshape(frames.shape[0], -1, frames.shape[-1])


def stream(p: Dict, m: Dict, f0: torch.Tensor, control: torch.Tensor,
           phase_offset: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """B whole streams: f0 (B, T) Hz, control (B, T, 2), (B, H) offsets and
    the (B, T*hop) noise -> (B, T*hop) audio."""
    hop, sr = m["control_hop"], m["sample_rate"]
    n_fft = m["noise_ir_length"]
    emb = newt.embed(p, control)
    f0_aud = ramp(f0[..., None], hop)[..., 0]
    phase = newt.TAU * torch.cumsum(f0_aud.double(), dim=-1) / sr
    bank = newt.harmonic_bank(phase, f0_aud, phase_offset, m["n_harmonics"], sr)
    exciter = newt.dense(p["harmonic_mixer"], bank)
    del bank
    film_a = ramp(newt.mlp(p["newt"]["mlp"], emb), hop)
    shaped = newt.newt_block(p["newt"], exciter, film_a)
    del exciter, film_a
    frames_n = f0.shape[1]
    sig = torch.cat([noise.new_zeros(noise.shape[0], n_fft - hop), noise], dim=-1)
    spec = torch.fft.rfft(sig.unfold(-1, n_fft, hop)[:, :frames_n], dim=-1)
    h_z = newt.fir_responses(newt.mlp(p["h_generator"], emb))
    ola = newt.overlap_add(torch.fft.irfft(spec * h_z, n=n_fft), hop)
    dry = shaped + ola[:, : frames_n * hop] / (n_fft // hop)
    ir = torch.cat([p["reverb"]["ir"].new_zeros(1), p["reverb"]["ir"]])
    n = dry.shape[-1] + ir.shape[-1] - 1
    wet = torch.fft.irfft(torch.fft.rfft(dry, n=n) * torch.fft.rfft(ir, n=n), n=n)
    return dry + wet[:, : dry.shape[-1]]


def sampled(tree: Dict, m: Dict, mix: Dict, seed: int, n: int, rows: np.ndarray, pushes: int,
            device, tf32: bool = False) -> torch.Tensor:
    """The reference of streams ``rows`` of the n streams a run pushes, over
    their first ``pushes`` buffers -> (S, pushes*K*hop): the contours from
    (seed, 4), the phase offsets and each buffer's noise drawn again as the
    run draws them (``contours.stream_offsets``, ``contours.stream_noise``),
    each stream rendered whole; with TF32 products where ``tf32``."""
    k, hop = mix["buffer_frames"], m["control_hop"]
    rows_d = torch.from_numpy(rows).to(device)
    offsets = contours.stream_offsets(seed, n, m["n_harmonics"], device)[rows_d]
    gen = contours.stream_noise(seed, device)
    noise = torch.cat([torch.rand((n, k * hop), generator=gen, device=device)[rows_d]
                       for _ in range(pushes)], dim=-1)
    params = contours.draw_params(seed, (4,), n, mix)
    f0, ctrl = contours.controls({key: v[rows] for key, v in params.items()},
                                 np.arange(pushes * k), m["sample_rate"] / hop, mix)
    out = []
    with torch.no_grad(), matmul_precision(tf32):
        for s in range(len(rows)):
            one = slice(s, s + 1)
            out.append(stream(tree, m, torch.from_numpy(f0[one]).to(device),
                              torch.from_numpy(ctrl[one]).to(device), offsets[one], noise[one]))
    return torch.cat(out)


def buffer_nrms(got: torch.Tensor, want: torch.Tensor, pushes: int) -> torch.Tensor:
    """(S, pushes): each buffer's RMS error over its stream's RMS, so one
    wrong buffer shows."""
    scale = torch.sqrt(torch.mean(want.double() ** 2, dim=-1, keepdim=True))
    err = (got - want).double().reshape(len(want), pushes, -1)
    return torch.sqrt(torch.mean(err ** 2, dim=-1)) / scale
