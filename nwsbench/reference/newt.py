"""The plain reference of NEWT (Hayes, Saitis & Fazekas, ISMIR 2021): the
synthesizer's forward pass, the FastNEWT table and lookup, and the
multi-resolution STFT loss, in plain PyTorch operations and float32.

It imports nothing of the port and takes nothing the port made: its
parameters are a tree of tensors the benchmark drew (``nwsbench.weights``,
the JAX layout: dense ``w`` (in, out); GRU ``w_ih`` (in, 3H) with gates
(r, z, n); shaper ``w`` (C, W_in, W_out)). Departures from the published
description, each the reference's own quirk or the port's documented
arithmetic:

* the shapers' and the oscillators' sine is the polynomial sine of the JAX
  package and the port (a frozen copy below, with its custom gradient):
  the paper's ``sin`` within 1.2e-9 on [-pi, pi];
* the oscillator's phase is summed in float64 and wrapped to [0, tau)
  before the harmonics expand it, as the port does;
* the noise excitation is uniform [0, 1), one vector shared by the batch;
  the reverb's convolution is circular at max(T, len(ir)) with a pinned
  leading zero (the reference implementation's quirks, which its
  checkpoints bake in);
* the FastNEWT index is ``S * (x - min) / (max - min)``, S and not S - 1,
  over [-3, 3] (the reference's quirk).

The GRU runs as an explicit loop of its gate equations, not cuDNN's.
"""
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

TAU = 2.0 * math.pi
TABLE_MIN, TABLE_MAX = -3.0, 3.0
LOSS_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

# -- the polynomial sine (frozen copy of the JAX package's ops/fastmath.py) --
_SIN = (0.9999999944601012, -0.16666664569899559, 0.008333310293322599,
        -0.0001984015186074305, 2.7529394880216866e-06, -2.4676487473365142e-08,
        1.344997356671708e-10)
_COS = (1.0000000001125011, -0.49999999861565086, 0.041666663506715884,
        -0.0013888863097880472, 2.4800554530106417e-05, -2.7534810390540134e-07,
        2.060362708310104e-09, -9.7225364605847e-12)


def _poly(x: torch.Tensor, coeffs, odd: bool) -> torch.Tensor:
    r = x - TAU * torch.round(x * (1.0 / TAU))
    s = r * r
    p = torch.full_like(s, coeffs[-1])
    for c in coeffs[-2::-1]:
        p = p * s + c
    return r * p if odd else p


class _Sin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _poly(x, _SIN, True)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _Cos.apply(x) * g


class _Cos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _poly(x, _COS, False)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return -_Sin.apply(x) * g


def psin(x: torch.Tensor) -> torch.Tensor:
    """The polynomial sine; its gradient is the polynomial cosine."""
    return _Sin.apply(x)


# -- layers ---------------------------------------------------------------------
def dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Dense layers with LayerNorm (population variance, eps 1e-5) and
    LeakyReLU(0.01) between them."""
    layers = p["layers"]
    for i, layer in enumerate(layers):
        x = dense(layer["dense"], x)
        if i < len(layers) - 1:
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5) * layer["norm"]["scale"] + layer["norm"]["bias"]
            x = torch.where(x >= 0, x, 0.01 * x)
    return x


def gru(p: Dict, x: torch.Tensor, h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, in) -> (B, T, H): the GRU's gate equations, step by step, from
    ``h`` (zeros when None); gates (r, z, n)."""
    hidden = p["w_hh"].shape[0]
    xs = x @ p["w_ih"] + p["b_ih"]
    if h is None:
        h = x.new_zeros(x.shape[0], hidden)
    out: List[torch.Tensor] = []
    for t in range(x.shape[1]):
        gh = h @ p["w_hh"] + p["b_hh"]
        xr, xz, xn = xs[:, t].split(hidden, dim=-1)
        hr, hz, hn = gh.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out.append(h)
    return torch.stack(out, dim=1)


def embed(p: Dict, control: torch.Tensor, h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Tc, >=2) normalised control -> (B, Tc, E): the GRU and its projection."""
    return dense(p["embedding"]["proj"], gru(p["embedding"]["gru"], control[..., :2], h))


def upsample(x: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, C) -> (B, T*hop, C), linear with align_corners=False, in the
    JAX package's arithmetic (a frozen copy): output sample m*hop + o sits at
    m + (2o+1-hop)/(2 hop); its weight is one float32 division of exact
    integers and the lerp ``left*(1-w) + right*w``, the ends clamped. The
    port's kernels interpolate the FiLM bit for bit so, and the reference
    follows, since the shapers' large input scales amplify a last-bit
    difference of the interpolation."""
    b, t, c = x.shape
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    nxt = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    o = torch.arange(hop, device=x.device)
    num = (2 * o + 1).to(x.dtype)
    lo = (2 * o + 1 < hop)[None, None, :, None]
    denom = torch.full((), 2.0 * hop, dtype=x.dtype, device=x.device)
    w = torch.where(lo[0, 0, :, 0], (num + hop) / denom, (num - hop) / denom)[None, None, :, None]
    left = torch.where(lo, prev[:, :, None], x[:, :, None])
    right = torch.where(lo, x[:, :, None], nxt[:, :, None])
    head = lo & (torch.arange(t, device=x.device)[None, :, None, None] == 0)
    out = torch.where(head, left, left * (1.0 - w) + right * w)
    return out.reshape(b, t * hop, c)


def shaper(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (..., C): each channel's width-W sine MLP, 1 -> W -> ... -> 1."""
    h = (x * p["input_scale"])[..., None]
    for layer in p["layers"]:
        h = psin(torch.einsum("...cw,cwv->...cv", h, layer["w"]) + layer["b"])
    return h[..., 0]


def bake_table(p: Dict, size: int = 4096) -> torch.Tensor:
    """The FastNEWT table: each shaper sampled on ``size`` points over
    [-3, 3] -> (size, C)."""
    channels = p["input_scale"].shape[0]
    grid = torch.linspace(TABLE_MIN, TABLE_MAX, size, device=p["input_scale"].device)
    return shaper(p, grid[:, None].expand(size, channels))


def lookup(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation into the (S, C) table, the reference's index."""
    s, c = table.shape
    # the span as a tensor: a division by a host scalar is a multiplication by
    # its reciprocal on the card, one rounding away from the IEEE quotient
    idx = s * (x - TABLE_MIN) / torch.full((), TABLE_MAX - TABLE_MIN, device=x.device)
    lower = torch.clamp(torch.floor(idx), 0, s - 1)
    upper = torch.clamp(lower + 1, max=s - 1)
    cols = torch.arange(c, device=x.device)
    lo = table[lower.long(), cols]
    hi = table[upper.long(), cols]
    return (hi - lo) * (idx - lower) + lo


def harmonic_bank(phase: torch.Tensor, f0: torch.Tensor, offset: torch.Tensor,
                  n_harmonics: int, sample_rate: float) -> torch.Tensor:
    """(B, T) float64 integrated phase, (B, T) Hz -> (B, T, H) antialiased
    sinusoids; ``offset`` (H,) or (B, H)."""
    k = torch.arange(1, n_harmonics + 1, dtype=f0.dtype, device=f0.device)
    wrapped = torch.remainder(phase, TAU).to(f0.dtype)
    offset = offset[None, None] if offset.dim() == 1 else offset[:, None]
    mask = (f0[..., None] * k < sample_rate / 2).to(f0.dtype)
    return psin(wrapped[..., None] * k + offset) * mask


def newt_block(p: Dict, exciter: torch.Tensor, film_a: torch.Tensor,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FiLM -> shaper bank (or the table) -> FiLM -> mix, the FiLM at audio
    rate: (B, Ta, C), (B, Ta, 4C) -> (B, Ta)."""
    gi, bi, gn, bn = film_a.split(exciter.shape[-1], dim=-1)
    x = exciter * gi + bi
    x = shaper(p["shaping_fn"], x) if table is None else lookup(table, x)
    return dense(p["mixer"], x * gn + bn)[..., 0]


def fir_responses(h_re: torch.Tensor) -> torch.Tensor:
    """(..., bins) magnitudes -> the complex response of each frame's
    windowed linear-phase FIR (irfft, centred by a roll, periodic Hann)."""
    n = 2 * (h_re.shape[-1] - 1)
    h = torch.roll(torch.fft.irfft(h_re, n=n), n // 2, dims=-1)
    return torch.fft.rfft(h * torch.hann_window(n, periodic=True, device=h.device), n=n)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, N, L) frames at hop-spaced offsets -> (B, (N-1)*hop + L)."""
    b, n, length = frames.shape
    out_len = (n - 1) * hop + length
    return F.fold(frames.transpose(1, 2), (1, out_len), (1, length), stride=(1, hop))[:, 0, 0]


def fir_noise(h_re: torch.Tensor, noise: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, Tc, bins) magnitudes and the (hop*Tc - 1,) uniform excitation ->
    (B, hop*Tc): each frame of the centred, reflect-padded STFT of the
    noise (rectangular window) filtered, then overlap-added and divided by
    the frames' overlap count."""
    b, tc, bins = h_re.shape
    n = 2 * (bins - 1)
    spec = torch.stft(noise, n, hop, window=torch.ones(n, device=noise.device), center=True,
                      pad_mode="reflect", return_complex=True).T  # (Tc, bins)
    frames = torch.fft.irfft(spec[None] * fir_responses(h_re), n=n)
    ola = overlap_add(frames, hop)
    count = overlap_add(torch.ones(1, tc, n, device=ola.device), hop)
    return (ola / count)[:, : hop * tc]


def reverb(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Dry plus the circular convolution with [0, ir] at max(T, len)."""
    ir = torch.cat([p["ir"].new_zeros(1), p["ir"]])
    n = max(x.shape[-1], ir.shape[-1])
    wet = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(ir, n=n), n=n)
    return x + wet[..., : x.shape[-1]]


def forward(p: Dict, m: Dict, f0: torch.Tensor, control: torch.Tensor,
            phase_offset: torch.Tensor, noise: torch.Tensor,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Tc) Hz and (B, Tc, >=2) normalised control -> (B, Tc*hop) audio,
    with the given (H,) or (B, H) phase offsets and noise; ``table`` takes
    the FastNEWT path."""
    hop, sr = m["control_hop"], m["sample_rate"]
    f0_up = upsample(f0[..., None], hop)[..., 0]
    emb = embed(p, control)
    phase = TAU * torch.cumsum(f0_up.double(), dim=-1) / sr
    bank = harmonic_bank(phase, f0_up, phase_offset, m["n_harmonics"], sr)
    exciter = dense(p["harmonic_mixer"], bank)
    film_a = upsample(mlp(p["newt"]["mlp"], emb), hop)
    shaped = newt_block(p["newt"], exciter, film_a, table)
    noise_audio = fir_noise(mlp(p["h_generator"], emb), noise, hop)
    return reverb(p["reverb"], shaped + noise_audio)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    spec = torch.stft(x, n_fft, hop, win_length=win,
                      window=torch.hann_window(win, periodic=True, device=x.device),
                      center=True, pad_mode="reflect", return_complex=True)
    return torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-8))


def stft_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """auraloss's MultiResolutionSTFTLoss at its defaults: per resolution
    spectral convergence plus the mean log-magnitude L1, averaged."""
    total = 0.0
    for n_fft, hop, win in LOSS_RESOLUTIONS:
        xm, ym = stft_magnitude(x, n_fft, hop, win), stft_magnitude(y, n_fft, hop, win)
        total = total + torch.linalg.vector_norm(ym - xm) / torch.linalg.vector_norm(ym) \
            + torch.mean(torch.abs(torch.log(ym) - torch.log(xm)))
    return total / len(LOSS_RESOLUTIONS)
