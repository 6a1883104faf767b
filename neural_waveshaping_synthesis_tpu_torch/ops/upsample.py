"""Control-rate -> audio-rate upsampling (counterpart of the JAX
``ops/upsample.py``): ``linear_upsample``, and the reference's optional
interpolators ``cubic_upsample`` (Catmull-Rom) and
``overlap_add_upsample`` (Hann grains), all on ``(B, T, C)`` tensors.

``align_corners=False`` semantics, as ``F.interpolate(mode="linear")``,
but with the JAX package's weight arithmetic copied exactly rather than
calling ``F.interpolate``: the CUDA kernel's in-register FiLM
interpolation (``kernels/csrc/newt_fused_cr.cu``) is held bit-exact to
this function, and the JAX function to it, so all three must compute the
weight the same way — ``(2o+1 ± hop) / (2*hop)``, one float32 division
of exact integers — and the lerp as ``left*(1-w) + right*w``.
"""
import torch

from .windows import hann_window


def _linear_upsample_integer(x: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, C) -> (B, T*hop, C) for an integer factor.

    Output sample s = m*hop + o sits at source position
    m + (2o+1-hop)/(2*hop). Offsets with 2o+1 < hop interpolate
    x[m-1] -> x[m] at weight (2o+1+hop)/(2*hop); the rest x[m] -> x[m+1]
    at (2o+1-hop)/(2*hop). The first half-hop of the clip copies x[0]
    (the head clamp); past (T-1)*hop the lerp runs between two copies of
    x[T-1] (the tail clamp)."""
    b, t, c = x.shape
    xm1 = torch.cat([x[:, :1], x[:, :-1]], dim=1)  # x[m-1], clamped
    xp1 = torch.cat([x[:, 1:], x[:, -1:]], dim=1)  # x[m+1], clamped
    o = torch.arange(hop, device=x.device)
    num = (2 * o + 1).to(x.dtype)  # 2o+1, exact
    is_lo = 2 * o + 1 < hop
    w = torch.where(is_lo, (num + hop) / (2 * hop), (num - hop) / (2 * hop))
    w4 = w[None, None, :, None]
    lo4 = is_lo[None, None, :, None]
    left = torch.where(lo4, xm1[:, :, None, :], x[:, :, None, :])
    right = torch.where(lo4, x[:, :, None, :], xp1[:, :, None, :])
    head4 = lo4 & (torch.arange(t, device=x.device)[None, :, None, None] == 0)
    out = torch.where(head4, left, left * (1.0 - w4) + right * w4)
    return out.reshape(b, t * hop, c)


def _source_positions(in_len: int, out_len: int, device) -> torch.Tensor:
    """Fractional source index of each output sample (align_corners=False)."""
    scale = in_len / out_len
    pos = (torch.arange(out_len, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    return torch.clamp(pos, 0.0, float(in_len - 1))


def linear_upsample(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear interpolation along axis 1 of (B, T, C) -> (B, out_len, C)."""
    in_len = x.shape[1]
    if out_len % in_len == 0:
        return _linear_upsample_integer(x, out_len // in_len)
    pos = _source_positions(in_len, out_len, x.device)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=in_len - 1)
    w = (pos - i0.to(torch.float32))[None, :, None]
    return x[:, i0] * (1.0 - w) + x[:, i1] * w


def segment_interp(prev: torch.Tensor, frames: torch.Tensor, hop: int) -> torch.Tensor:
    """The streaming ramp (JAX ``streaming/synth.py`` ``_segment_interp``):
    prev (B, C), frames (B, K, C) -> (B, K*hop, C). Sample o of segment m
    is ``start + (end - start) * t`` with start = frame m-1 (``prev`` for
    m = 0), end = frame m and t = (o+1)/hop, so a buffer ends exactly on
    its last frame and the next buffer ramps on from there.

    t is the correctly rounded float32 quotient (o+1)/hop on every device:
    the float64 quotient of two integers below 2^23 rounds to the float32
    one, whatever reciprocal trick a device's division by a scalar uses.
    The CUDA stream kernel (``kernels/csrc/newt_fused_stream.cu``) computes
    the same t with ``__fdiv_rn`` and the same three roundings."""
    b, k, c = frames.shape
    starts = torch.cat([prev[:, None, :], frames[:, :-1, :]], dim=1)
    t = torch.arange(1, hop + 1, dtype=torch.float64, device=frames.device) / hop
    t = t.to(frames.dtype)[None, None, :, None]
    seg = starts[:, :, None, :] + (frames - starts)[:, :, None, :] * t
    return seg.reshape(b, k * hop, c)


def cubic_upsample(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Catmull-Rom cubic interpolation along axis 1 of (B, T, C) ->
    (B, out_len, C), at the align_corners=False source positions."""
    in_len = x.shape[1]
    pos = _source_positions(in_len, out_len, x.device)
    i1 = torch.floor(pos).to(torch.int64)
    t = (pos - i1.to(torch.float32))[None, :, None]
    p0 = x[:, torch.clamp(i1 - 1, min=0)]
    p1 = x[:, i1]
    p2 = x[:, torch.clamp(i1 + 1, max=in_len - 1)]
    p3 = x[:, torch.clamp(i1 + 2, max=in_len - 1)]
    a = 2.0 * p1
    b = p2 - p0
    c = 2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3
    d = -p0 + 3.0 * p1 - 3.0 * p2 + p3
    return 0.5 * (a + b * t + c * t * t + d * t * t * t)


def overlap_add_upsample(x: torch.Tensor, window_size: int, hop_length: int) -> torch.Tensor:
    """Hann overlap-add upsampling of frame-rate (B, T, C) -> (B, T * hop,
    C): each frame value becomes a symmetric Hann grain of ``window_size``
    samples hopped by ``hop_length``; the grains are summed and the
    T * hop samples at the centre of the full buffer kept."""
    b, t, c = x.shape
    win = hann_window(window_size, periodic=False, device=x.device)
    grains = x[:, :, None, :] * win[None, None, :, None]  # (B, T, W, C)
    out_len = window_size + hop_length * (t - 1)
    idx = (torch.arange(t, device=x.device)[:, None] * hop_length
           + torch.arange(window_size, device=x.device)[None, :]).reshape(-1)
    out = x.new_zeros((b, out_len, c))
    out.index_add_(1, idx, grains.reshape(b, t * window_size, c))
    target = t * hop_length
    start = (out_len - target) // 2
    return out[:, start : start + target, :]
