"""The benchmark's yardstick: the H100's data-sheet peaks, the operation and
byte counts of NEWT's shaper block and of the FastNEWT lookup, and the model
FLOPs of a forward pass, a training step and a streamed buffer, all worked
out from shapes.

This is a frozen copy, not an import: the port's ``kernels/roofline.py``
(``PEAK_*``, ``CR_FLOP_PER_ELEMENT``, ``CR_BWD_FLOP_PER_ELEMENT``,
``shaper_bytes``, ``bound``) and ``scripts/torch_roofline_shaper.py``
(``datasheet_bound_ms``) may change with the kernels, the yardstick may not.
The block's count is kernel 1's count of the block's work (the FiLM lerp,
FiLM, the 1 -> 8 -> 8 -> 8 -> 1 sine MLP, FiLM), whatever implements it.
"""
import math
from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, at the 700 W limit: float32 outside the tensor
# cores (TF32 is off in the port) and HBM3.
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

# f32 operations per (sample, channel) of the shaper block, an FMA as two:
# FiLM lerp 4*(2 mul + add) + division + (1-w) = 14; FiLM-in FMA + scale = 3;
# MLP 1->8->8->8->1 multiply-adds (8 + 64 + 64 + 8) * 2 = 288; 25 sines of
# (mul, rint, fma, mul, 6 fma, mul) = 18 each = 450; FiLM-out FMA = 2.
CR_FLOP_PER_ELEMENT = 14 + 3 + 288 + 450 + 2
# ... and of its backward: forward recompute (lerp 14, FiLM-in + scale 3, MLP
# 288, 25 sine-and-cosine pairs sharing one range reduction = 31 each), then
# the chain rule (FiLM-out 2; layer 4 weight/bias grads 16 + 1, dp3 16; layers
# 3 and 2 each weight grads 128, input grads 128, bias 8, times the cosine 8;
# layer 1 bias 8, weight 16, input 16; input scale 2, dx 1, d_exciter 1; FiLM
# cotangents 2; lerp transpose 16).
CR_BWD_FLOP_PER_ELEMENT = (
    (14 + 3 + 288 + 25 * 31)
    + (2 + 16 + 1 + 16 + 2 * (128 + 128 + 8 + 8) + 8 + 16 + 16 + 2 + 1 + 1 + 2 + 16)
)
PSIN_FLOP = 18  # one polynomial sine, as the block's count has it
SHAPER_PLANES = 170  # packed weight rows per channel: 1 + 8 + 8 + 64 + 8 + 64 + 8 + 8 + 1
# the FastNEWT lookup per element: index (sub, mul, div), floor, clamp, two
# gathers' difference, fraction, multiply-add
LOOKUP_FLOP_PER_ELEMENT = 8


def bound(flop: float, nbytes: float) -> Tuple[float, str]:
    """-> (least seconds on an H100 SXM for this work, "operations" or
    "bytes"): the larger of ``flop`` float32 operations over the peak rate and
    ``nbytes`` over the memory rate."""
    t_ops, t_bytes = flop / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def shaper_bytes(exc: int, film: int, planes: int, backward: bool = False) -> int:
    """The bytes a shaper kernel must move, from the byte sizes of its
    exciter, its FiLM and its weight planes: exciter in and out (and dy in),
    the FiLM in (and d_film out), the planes in (and d_planes out)."""
    return 3 * exc + 2 * film + 2 * planes if backward else 2 * exc + film + planes


def block_bound_s(count: str, b: int, frames: int, hop: int, channels: int,
                  table_size: int = 4096) -> float:
    """The least seconds of one launch of the block at (b rows, ``frames``
    control frames of ``hop`` samples, ``channels`` shapers) in float32:

    * ``cr_fwd`` / ``cr_bwd``: the block with its FiLM at control rate,
      forward or backward (kernels 1 and 2; ``datasheet_bound_ms`` of
      ``scripts/torch_roofline_shaper.py``);
    * ``cr_stream``: one streamed buffer, the forward's count with the
      carried FiLM frame read beside the buffer's frames (kernel 3);
    * ``lookup``: the FastNEWT lookup, the exciter in and out and the table.
    """
    n = b * frames * hop * channels
    if count in ("cr_fwd", "cr_bwd", "cr_stream"):
        film_frames = b * (frames + 1 if count == "cr_stream" else frames)
        film = 4 * 4 * channels * film_frames
        nbytes = shaper_bytes(4 * n, film, 4 * SHAPER_PLANES * channels,
                              backward=count == "cr_bwd")
        per = CR_BWD_FLOP_PER_ELEMENT if count == "cr_bwd" else CR_FLOP_PER_ELEMENT
        return bound(n * per, nbytes)[0]
    if count == "lookup":
        return bound(n * LOOKUP_FLOP_PER_ELEMENT, 8 * n + 4 * table_size * channels)[0]
    raise ValueError(f"no count named {count!r}")


def datasheet_bound_ms(kernel: int, b: int, tc: int, hop: int, channels: int = 64) -> float:
    """Kernel 1 or 2's least time at (B, Tc * hop, channels) in float32 on the
    data sheet's rates, in ms (the copy of the roofline CLI's function for the
    control-rate kernels)."""
    return 1e3 * block_bound_s("cr_fwd" if kernel == 1 else "cr_bwd", b, tc, hop, channels)


# -- model FLOPs --------------------------------------------------------------
# Counted from shapes: a multiply-add as two; an elementwise operation as
# one; a real FFT of n points as 2.5 n log2 n; a training step's matrix
# products three times their forward (forward, the input's and the weight's
# gradients), its elementwise and FFT work twice.


def _dense(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out + n_out


def _mlp(n_in: int, hidden: int, n_out: int, depth: int) -> Tuple[int, int]:
    """(matrix products, elementwise) per row of a depth-``depth`` MLP with
    LayerNorm and leaky ReLU between its layers."""
    mm = sum(_dense(n_in if i == 0 else hidden, hidden if i < depth - 1 else n_out)
             for i in range(depth))
    return mm, (depth - 1) * 9 * hidden


def _rfft(n: int) -> float:
    return 2.5 * n * math.log2(n)


def _parts(m: Dict, frames: int) -> Dict[str, float]:
    """One clip's forward work by kind: "mm" (matrix products), "elem"
    (elementwise), "fft", "block" (the shaper block, forward)."""
    hop, h, c = m["control_hop"], m["n_harmonics"], m["n_waveshapers"]
    gru, emb = m["gru_hidden_size"], m["control_embedding_size"]
    samples = frames * hop
    n_fir = m["noise_ir_length"]
    film_mm, film_el = _mlp(emb, emb, 4 * c, m["film_mlp_depth"])
    noise_mm, noise_el = _mlp(emb, m["noise_mlp_hidden_size"], n_fir // 2 + 1,
                              m["noise_mlp_depth"])
    per_frame_mm = (2 * 3 * gru * (m["control_size"] + gru) + _dense(gru, emb)
                    + film_mm + noise_mm)
    per_frame_el = 16 * gru + film_el + noise_el + 6 * (n_fir // 2 + 1) + 2 * n_fir
    per_frame_fft = 4 * _rfft(n_fir)  # the FIR's irfft and rfft, the noise's rfft, its irfft
    per_sample_mm = _dense(h, c) + _dense(c, m["out_channels"])
    per_sample_el = h * (4 + PSIN_FLOP) + 5  # f0 lerp, phase, harmonics, mask, sum
    n_conv = max(samples, m["sample_rate"] * m["reverb_seconds"])
    reverb_fft = 3 * _rfft(n_conv) + 6 * (n_conv // 2 + 1)
    return {"mm": frames * per_frame_mm + samples * per_sample_mm,
            "elem": frames * per_frame_el + samples * per_sample_el + samples,
            "fft": frames * per_frame_fft + reverb_fft,
            "block": samples * c * CR_FLOP_PER_ELEMENT,
            "block_bwd": samples * c * CR_BWD_FLOP_PER_ELEMENT}


def n_params(m: Dict) -> int:
    """The model's parameter count from its sizes."""
    h, c, w, d = m["n_harmonics"], m["n_waveshapers"], m["shaping_fn_size"], m["shaping_fn_depth"]
    gru, emb = m["gru_hidden_size"], m["control_embedding_size"]

    def mlp(n_in, hidden, n_out, depth):
        return sum((n_in if i == 0 else hidden) * (hidden if i < depth - 1 else n_out)
                   + (hidden if i < depth - 1 else n_out) for i in range(depth)) \
            + (depth - 1) * 2 * hidden

    shaper = c + c * w + c * w + (d - 2) * (c * w * w + c * w) + c * w + c
    return (3 * gru * (m["control_size"] + gru) + 6 * gru + gru * emb + emb
            + h * c + c + mlp(emb, emb, 4 * c, m["film_mlp_depth"]) + shaper
            + c * m["out_channels"] + m["out_channels"]
            + mlp(emb, m["noise_mlp_hidden_size"], m["noise_ir_length"] // 2 + 1,
                  m["noise_mlp_depth"])
            + m["sample_rate"] * m["reverb_seconds"] - 1)


def forward_flop(m: Dict, rows: int, frames: int, lookup: bool = False) -> float:
    """Model FLOPs of a forward pass of ``rows`` clips of ``frames`` control
    frames. With a FastNEWT ``lookup`` the shaper MLP's 288 multiply-add
    operations and 25 sines per element give way to the lookup's count."""
    p = _parts(m, frames)
    block = p["block"]
    if lookup:
        samples = frames * m["control_hop"]
        block = samples * m["n_waveshapers"] * (CR_FLOP_PER_ELEMENT - 288 - 450
                                                + LOOKUP_FLOP_PER_ELEMENT)
    return rows * (p["mm"] + p["elem"] + p["fft"] + block)


def loss_flop(m: Dict, rows: int, samples: int,
              resolutions=((1024, 120), (2048, 240), (512, 50))) -> float:
    """The multi-resolution STFT loss of ``rows`` clips, forward: two
    spectrograms per resolution and the elementwise terms."""
    total = 0.0
    for n_fft, hop in resolutions:
        n_frames = samples // hop + 1
        bins = n_fft // 2 + 1
        total += 2 * n_frames * (_rfft(n_fft) + n_fft + 6 * bins) + 8 * n_frames * bins
    return rows * total


def train_step_flop(m: Dict, rows: int, frames: int) -> float:
    """Model FLOPs of one training step on ``rows`` clips: forward and
    backward of the model and the loss, the clip and Adam."""
    p = _parts(m, frames)
    samples = frames * m["control_hop"]
    # the harmonic bank takes no gradient: its mixer's products are two, not three
    bank_mm = samples * 2 * m["n_harmonics"] * m["n_waveshapers"]
    model = (3 * p["mm"] - bank_mm + 2 * p["elem"] + 2 * p["fft"] + p["block"]
             + p["block_bwd"])
    return rows * model + 2 * loss_flop(m, rows, samples) + 16 * n_params(m)


def stream_buffer_flop(m: Dict, streams: int, frames: int) -> float:
    """Model FLOPs of one streamed buffer of ``frames`` control frames for
    ``streams`` streams: the forward's work per frame and per sample, with
    the reverb as one block of a uniform-partitioned convolution."""
    hop = m["control_hop"]
    block = frames * hop
    p = _parts(m, frames)
    n_part = -(-(m["sample_rate"] * m["reverb_seconds"]) // block)
    n_conv = max(block, m["sample_rate"] * m["reverb_seconds"])
    offline_reverb = 3 * _rfft(n_conv) + 6 * (n_conv // 2 + 1)
    partitioned = 2 * _rfft(2 * block) + 8 * n_part * (block + 1) + block
    return streams * (p["mm"] + p["elem"] + p["fft"] - offline_reverb + partitioned
                      + p["block"])
