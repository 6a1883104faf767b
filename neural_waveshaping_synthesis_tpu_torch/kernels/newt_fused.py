"""Control-rate FiLM -> shaper bank -> FiLM: the CUDA kernel, its plain
PyTorch version and the wrapper that chooses between them.

Counterpart of the JAX ``kernels/newt_fused.py`` ``film_shaper_fused_cr``
(the inference default, ``NEWT.fused = "cr"``). The function: the
(B, Tc, 4C) control-rate FiLM parameters are linearly upsampled to audio
rate (align_corners=False), the (B, Ta, C) exciter is modulated by
gamma_in/beta_in, each channel goes through its own 1 -> 8 -> 8 -> 8 -> 1
sine MLP, and gamma_out/beta_out modulate the result.

* :func:`film_shaper_cr_plain` is that chain in plain PyTorch. The CPU
  path and the tests use it, and ``chip_smoke.py`` holds the kernel
  against it on the card.
* :func:`film_shaper_cr_grad_plain` is the plain version of the
  backward (JAX ``_fused_bwd_cr``): autograd through the plain forward.
* :func:`film_shaper_cr` is the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/newt_fused_cr.cu`` or raises —
  there is no fallback. When a gradient is needed on CUDA it goes through
  :class:`_FilmShaperCR`, whose backward launches
  ``csrc/newt_fused_cr_bwd.cu`` (never the plain backward).
  ``film_shaper_cr.launches`` and ``film_shaper_cr.bwd_launches`` count
  the launches of the two kernels' float32 instances, ``.launches_bf16``
  and ``.bwd_launches_bf16`` those of their (bf16 exciter, bf16 FiLM)
  instances and ``.launches_bf16_f32`` and ``.bwd_launches_bf16_f32`` those
  of their (bf16 exciter, float32 FiLM) ones.

Mixed precision (the model's ``compute_dtype = "bfloat16"``): the two
control-rate kernels take a bfloat16 exciter (and cotangent) with a
bfloat16 FiLM, or with a float32 one (``NEWT.cr_film_f32``), and compute in
float32 between load and store: the output (and d_exciter) comes back in the
exciter's dtype, d_film in the FiLM's, d_planes in float32. The weights are
float32 planes always: :func:`pack_weights` of bfloat16 leaves gives exact
float32 copies. The plain versions compute the same under bfloat16 (widen,
the float32 chain, round each output once). The two audio-rate kernels take
a bfloat16 exciter, FiLM and cotangent together, in the same way. The
exciter-fused kernels take a bfloat16 mixer (w, b and xfull's w_out, with the
output and its cotangent in that dtype) with a bfloat16 or float32 FiLM, phase,
f0 and offsets float32 always. The stream kernel takes float32 only.

The audio-rate counterpart (JAX ``film_shaper_fused_fl`` and
``film_shaper_fused``, the two TPU lane layouts of one function) takes the
FiLM already upsampled, (B, Ta, 4C): :func:`film_shaper_fl_plain` and
:func:`film_shaper_fl_grad_plain` are its plain versions and
:func:`film_shaper_fl` its wrapper, which launches ``csrc/newt_fused_fl.cu``
on CUDA tensors and, for a gradient, ``csrc/newt_fused_fl_bwd.cu`` through
:class:`_FilmShaperFL`; ``film_shaper_fl.launches`` and
``film_shaper_fl.bwd_launches`` count their float32 instances,
``.launches_bf16`` and ``.bwd_launches_bf16`` their bfloat16 ones (exciter,
FiLM and cotangent in bfloat16; no mixed pair). The backward walks the samples
in 32-sample chunks, lanes as samples as in the cr backward, so a chunk may
cross a clip boundary (:func:`_chunk_blocks` is its grid).

The streaming counterpart (JAX ``film_shaper_fused_stream``) ramps the
FiLM from the carried frame of the previous buffer to each new frame over
one hop (``segment_interp``) instead of the offline upsample:
:func:`film_shaper_stream_plain` is its plain version and
:func:`film_shaper_stream` its wrapper, which launches
``csrc/newt_fused_stream.cu`` on CUDA tensors (forward only) and counts
``film_shaper_stream.launches``.

The exciter-fused counterparts (JAX ``bank_film_shaper_fused_xcr`` and
``bank_newt_fused_xfull``, reached through ``NeuralWaveshaping.fuse_exciter``
and ``fuse_out_mixer``) take the (B, Ta) wrapped phase and f0 in place of the
exciter and build the harmonic bank and the H -> C mix in the kernel:
:func:`bank_film_shaper_xcr_plain` and :func:`bank_newt_xfull_plain` (the
latter with NEWT's C -> 1 output mix, bias excluded) are their plain
versions, the ``..._grad_plain`` functions their backwards', and
:func:`bank_film_shaper_xcr` / :func:`bank_newt_xfull` the wrappers, which
launch ``csrc/newt_fused_x.cu`` on CUDA tensors and, for a gradient,
``csrc/newt_fused_x_bwd.cu`` through :class:`_BankFilmShaperX`; each counts
``.launches`` and ``.bwd_launches`` (float32), ``.launches_bf16`` and
``.bwd_launches_bf16`` (bf16 mixer, bf16 FiLM) and ``.launches_bf16_f32`` and
``.bwd_launches_bf16_f32`` (bf16 mixer, float32 FiLM). :func:`supports_xcr` is
their gate.
"""
import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..models.modules import cast_params, dense_apply, film, shaper_apply
from ..ops.oscillator import bank_from_wrapped_phase
from ..ops.upsample import linear_upsample, segment_interp
from . import _build

C = 64
W = 8
DEPTH = 4
_MAX_SAMPLES = 1 << 30  # B*Ta bound of the kernel's 32-bit sample index
_MAX_HOP = 1 << 22  # 2o+1+hop stays an exact float32 integer


def supports(shaper) -> bool:
    """True when the shaper is the shipped architecture the kernel is
    written for: 64 channels, width 8, depth 4, sine activations."""
    return (
        shaper.channels == C
        and shaper.width == W
        and shaper.depth == DEPTH
        and shaper.nonlinearity == "sine"
        and shaper.final_nonlinearity == "sine"
    )


def supports_cr(shaper, n_audio: int, n_control: int) -> bool:
    """True when the kernel takes this geometry: the shipped architecture
    and an integer hop. Any hop and any control length work on the card;
    the JAX gate's "8 | hop <= 256" and "even Tc" were limits of the TPU
    compiler, not of the function."""
    if not supports(shaper) or n_control < 1 or n_audio % n_control:
        return False
    return 1 <= n_audio // n_control <= _MAX_HOP


def pack_weights(p: Dict) -> torch.Tensor:
    """Shaper parameters (JAX layout) -> one contiguous (170, C) float32
    tensor of weight planes, channel fastest, rows in the JAX
    ``pack_weights`` order: input_scale (1), w1 (8), b1 (8), w2 (64, row
    u*8+v), b2 (8), w3 (64), b3 (8), w4 (8), b4 (1)."""
    l1, l2, l3, l4 = p["layers"]
    planes = [
        p["input_scale"][None, :],
        l1["w"][:, 0, :].T,
        l1["b"].T,
        l2["w"].permute(1, 2, 0).reshape(W * W, C),
        l2["b"].T,
        l3["w"].permute(1, 2, 0).reshape(W * W, C),
        l3["b"].T,
        l4["w"][:, :, 0].T,
        l4["b"].T,
    ]
    return torch.cat(planes, dim=0).to(torch.float32).contiguous()


def unpack_weight_grads(planes: torch.Tensor) -> Dict:
    """(170, C) planes in the :func:`pack_weights` layout -> the shaper
    tree (JAX layout); the inverse of :func:`pack_weights` and the port of
    the JAX ``unpack_weight_grads``. Views, so autograd flows through."""
    dscale, dw1, db1, dw2, db2, dw3, db3, dw4, db4 = torch.split(
        planes, [1, W, W, W * W, W, W * W, W, W, 1], dim=0
    )
    return {
        "input_scale": dscale[0],
        "layers": [
            {"w": dw1.T[:, None, :], "b": db1.T},
            {"w": dw2.reshape(W, W, C).permute(2, 0, 1), "b": db2.T},
            {"w": dw3.reshape(W, W, C).permute(2, 0, 1), "b": db3.T},
            {"w": dw4.T[:, :, None], "b": db4.T},
        ],
    }


def film_shaper_chain(exciter: torch.Tensor, film_a: torch.Tensor, p: Dict) -> torch.Tensor:
    """FiLM -> shaper -> FiLM with the film already at audio rate:
    (B, Ta, C) exciter, (B, Ta, 4C) film -> (B, Ta, C)."""
    c = exciter.shape[-1]
    gi, bi, gn, bn = film_a.split(c, dim=-1)
    return film(shaper_apply(p, film(exciter, gi, bi)), gn, bn)


def film_shaper_cr_plain(
    exciter: torch.Tensor, film_c: torch.Tensor, shaper_params: Dict, hop: int
) -> torch.Tensor:
    """The plain PyTorch version: ``linear_upsample`` of the (B, Tc, 4C)
    film to Ta = Tc*hop samples, then :func:`film_shaper_chain`.

    It computes what every instance of the kernel computes: the exciter,
    the film and the shaper parameters widened to at least float32 (under
    float32 they are the tensors given), the chain in that type, the output
    rounded once to the exciter's dtype (bfloat16 with a bfloat16 or
    float32 film). Autograd through it
    gives d_exciter in the exciter's dtype and d_film in the film's."""
    ta = exciter.shape[1]
    if ta != film_c.shape[1] * hop:
        raise ValueError(f"exciter length {ta} != Tc {film_c.shape[1]} * hop {hop}")
    acc = torch.promote_types(exciter.dtype, torch.float32)
    out = film_shaper_chain(
        exciter.to(acc), linear_upsample(film_c.to(acc), ta), cast_params(shaper_params, acc)
    )
    return out.to(exciter.dtype)


def film_shaper_cr_grad_plain(
    exciter: torch.Tensor,
    film_c: torch.Tensor,
    shaper_params: Dict,
    hop: int,
    dy: torch.Tensor,
):
    """The plain version of the backward: ``torch.autograd.grad`` through
    :func:`film_shaper_cr_plain` with cotangent ``dy`` -> (d_exciter
    (B, Ta, C), d_film_c (B, Tc, 4C), d_planes (170, C) in the
    :func:`pack_weights` layout), each in its input's dtype (the planes
    float32)."""
    with torch.enable_grad():
        exc = exciter.detach().requires_grad_()
        film_c = film_c.detach().requires_grad_()
        planes = pack_weights(shaper_params).detach().requires_grad_()
        out = film_shaper_cr_plain(exc, film_c, unpack_weight_grads(planes), hop)
        return torch.autograd.grad(out, (exc, film_c, planes), dy)


def _lib(name: str, symbol: str, n_ptrs: int, n_ints: int = 4, n_floats: int = 0) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _check_tensors(bf16_ok=(), **tensors: torch.Tensor) -> None:
    """Every tensor float32 (those named in ``bf16_ok`` float32 or bfloat16),
    contiguous and on the first one's device."""
    first, dev = next((name, t.device) for name, t in tensors.items())
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {first} on {dev}")
        if t.dtype != torch.float32 and not (name in bf16_ok and t.dtype == torch.bfloat16):
            also = " or bfloat16" if name in bf16_ok else ""
            raise TypeError(f"{name} must be float32{also}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# (exciter dtype, film dtype) -> the C symbols' suffix of kernels 1 and 2's instance;
# kernels 7 and 8 take the same pairs with the mixer in the exciter's place
_CR_INSTANCES = {
    (torch.float32, torch.float32): "",
    (torch.bfloat16, torch.bfloat16): "_bf16",
    (torch.bfloat16, torch.float32): "_bf16_f32",
}


def _check(exciter: torch.Tensor, film_c: torch.Tensor, weights: torch.Tensor, hop: int) -> str:
    """Checks what kernels 1 and 2 take; -> the suffix of the instance."""
    _check_tensors(("exciter", "film_c"), exciter=exciter, film_c=film_c, shaper_weights=weights)
    instance = _CR_INSTANCES.get((exciter.dtype, film_c.dtype))
    if instance is None:
        raise TypeError(
            f"a {film_c.dtype} film_c needs a bfloat16 exciter, got {exciter.dtype}"
        )
    if exciter.dim() != 3 or exciter.shape[2] != C:
        raise ValueError(f"exciter must be (B, Ta, {C}), got {tuple(exciter.shape)}")
    b, ta, _ = exciter.shape
    if film_c.dim() != 3 or film_c.shape[0] != b or film_c.shape[2] != 4 * C:
        raise ValueError(f"film_c must be ({b}, Tc, {4 * C}), got {tuple(film_c.shape)}")
    tc = film_c.shape[1]
    if not 1 <= hop <= _MAX_HOP or tc < 1 or ta != tc * hop:
        raise ValueError(f"need Ta = Tc * hop with 1 <= hop <= {_MAX_HOP}: Ta={ta}, Tc={tc}, hop={hop}")
    if b * ta > _MAX_SAMPLES:
        raise ValueError(f"B*Ta = {b * ta} exceeds the kernel's {_MAX_SAMPLES} samples")
    if tuple(weights.shape) != (170, C):
        raise ValueError(f"packed weights must be (170, {C}), got {tuple(weights.shape)}")
    return instance


def _launch_forward(exciter, film_c, weights, hop) -> torch.Tensor:
    instance = _check(exciter, film_c, weights, hop)
    symbol = "newt_fused_cr_forward" + instance
    out = torch.empty_like(exciter)
    b, ta, _ = exciter.shape
    with torch.cuda.device(exciter.device):
        lib = _lib("newt_fused_cr", symbol, 4)
        stream = torch.cuda.current_stream(exciter.device).cuda_stream
        err = getattr(lib, symbol)(
            exciter.data_ptr(), film_c.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b * ta, ta, film_c.shape[1], hop, stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    _count(film_shaper_cr, "launches" + instance)
    return out


def _count(wrapper, counter: str) -> None:
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


_RESIDENT_BLOCKS: Dict[Tuple[str, int], int] = {}  # (query, device index) -> blocks resident at once


def _resident_blocks(lib: ctypes.CDLL, query: str, device: torch.device) -> int:
    """A kernel's blocks resident on ``device`` at once, asked of the
    library's ``query`` once per device (the backward's query also allows
    its kernel the shared memory there), then kept."""
    key = (query, device.index)
    if key not in _RESIDENT_BLOCKS:
        fn = getattr(lib, query)
        fn.argtypes, fn.restype = [], ctypes.c_int
        blocks = fn()
        if blocks <= 0:
            raise RuntimeError(f"{query} failed: CUDA error {-blocks}")
        _RESIDENT_BLOCKS[key] = blocks
    return _RESIDENT_BLOCKS[key]


def _segment_blocks(n_segments: int, resident: int) -> int:
    """The persistent grid of the backwards that walk control segments (the
    cr backward and the exciter-fused one): one block per segment (B*Tc of
    them; a block holds one segment at a time and strides by the grid), at
    most ``resident``, the blocks the card holds at once."""
    return min(n_segments, resident)


def _launch_backward(exciter, film_c, weights, dy, hop):
    """-> (d_exciter, d_film_c, d_planes) from ``csrc/newt_fused_cr_bwd.cu``.
    Scratch (per-segment FiLM partials, per-block weight partials) is
    allocated here, for :func:`_segment_blocks` blocks."""
    instance = _check(exciter, film_c, weights, hop)
    symbol = "newt_fused_cr_backward" + instance
    if dy.shape != exciter.shape or dy.dtype != exciter.dtype or dy.device != exciter.device:
        raise ValueError(f"dy must be {exciter.dtype} {tuple(exciter.shape)} on {exciter.device}")
    b, ta, _ = exciter.shape
    tc = film_c.shape[1]
    d_exc = torch.empty_like(exciter)
    d_film = torch.empty_like(film_c)
    d_planes = torch.empty_like(weights)
    with torch.cuda.device(exciter.device):
        lib = _lib("newt_fused_cr_bwd", symbol, 9)
        blocks = _segment_blocks(
            b * tc, _resident_blocks(lib, "newt_fused_cr_backward_resident_blocks", exciter.device))
        film_part = torch.empty((b * tc, 3, 4 * C), dtype=torch.float32, device=exciter.device)
        w_part = torch.empty((blocks, 170, C), dtype=torch.float32, device=exciter.device)
        stream = torch.cuda.current_stream(exciter.device).cuda_stream
        err = getattr(lib, symbol)(
            exciter.data_ptr(), film_c.data_ptr(), weights.data_ptr(), dy.data_ptr(),
            d_exc.data_ptr(), d_film.data_ptr(), d_planes.data_ptr(),
            film_part.data_ptr(), w_part.data_ptr(),
            b, ta, tc, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    _count(film_shaper_cr, "bwd_launches" + instance)
    return d_exc, d_film, d_planes


class _FilmShaperCR(torch.autograd.Function):
    """The kernel pair as one differentiable function of (exciter, film_c,
    packed planes). Forward saves only its inputs, as JAX's
    ``_fused_fwd_cr``; backward recomputes the forward in the kernel."""

    @staticmethod
    def forward(ctx, exciter, film_c, packed, hop):
        ctx.hop = hop
        ctx.save_for_backward(exciter, film_c, packed)
        return _launch_forward(exciter, film_c, packed, hop)

    @staticmethod
    def backward(ctx, dy):
        exciter, film_c, packed = ctx.saved_tensors
        d_exc, d_film, d_planes = _launch_backward(
            exciter, film_c, packed, dy.contiguous(), ctx.hop
        )
        return d_exc, d_film, d_planes, None


def _shaper_leaves(shaper_params: Dict):
    yield shaper_params["input_scale"]
    for layer in shaper_params["layers"]:
        yield from layer.values()


def _packed_for(shaper_params: Dict, packed: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernels' (170, C) planes: ``packed`` when given, packed here
    otherwise. Raises when ``packed`` was made without autograd while a
    shaper leaf needs a gradient: the shapers would silently get none."""
    weights = pack_weights(shaper_params) if packed is None else packed
    if (
        torch.is_grad_enabled()
        and not weights.requires_grad
        and any(t.requires_grad for t in _shaper_leaves(shaper_params))
    ):
        raise ValueError(
            "packed shaper planes were made without autograd but the shaper "
            "parameters need a gradient; pack them with grad enabled"
        )
    return weights


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def film_shaper_cr(
    exciter: torch.Tensor,
    film_c: torch.Tensor,
    shaper_params: Dict,
    hop: int,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, Ta, 64) exciter + (B, Tc, 256) control-rate film -> (B, Ta, 64).

    CPU tensors take :func:`film_shaper_cr_plain` (autograd differentiates
    it). CUDA tensors launch the kernels on the current stream, after
    checking device, dtype (a float32 or bfloat16 exciter; a float32 film,
    or a bfloat16 one with a bfloat16 exciter), shapes and contiguity;
    anything the kernels do not take raises. The output takes the
    exciter's dtype. With grad enabled and an input that needs
    a gradient, the call goes through :class:`_FilmShaperCR`, whose
    backward is the CUDA backward kernel; otherwise the forward kernel
    alone runs. ``packed`` is ``pack_weights(shaper_params)`` when the
    caller keeps it; packed here otherwise. A ``packed`` made without
    autograd while a shaper leaf needs a gradient raises: the shapers
    would silently get none."""
    if exciter.device.type == "cpu":
        return film_shaper_cr_plain(exciter, film_c, shaper_params, hop)
    if exciter.device.type != "cuda":
        raise ValueError(f"unsupported device {exciter.device}")
    weights = _packed_for(shaper_params, packed)
    if _needs_grad(exciter, film_c, weights):
        return _FilmShaperCR.apply(exciter, film_c, weights, hop)
    return _launch_forward(exciter, film_c, weights, hop)


film_shaper_cr.launches = 0
film_shaper_cr.bwd_launches = 0
film_shaper_cr.launches_bf16 = film_shaper_cr.bwd_launches_bf16 = 0  # (bf16, bf16)
film_shaper_cr.launches_bf16_f32 = film_shaper_cr.bwd_launches_bf16_f32 = 0  # (bf16, f32)


# ---------------------------------------------------------------------------
# audio rate: the FiLM already upsampled (JAX film_shaper_fused_fl and
# film_shaper_fused, one function in two TPU lane layouts)
# ---------------------------------------------------------------------------
def film_shaper_fl_plain(
    exciter: torch.Tensor, film_a: torch.Tensor, shaper_params: Dict
) -> torch.Tensor:
    """The plain PyTorch version of the audio-rate kernel:
    :func:`film_shaper_chain` of the (B, Ta, C) exciter and the
    (B, Ta, 4C) audio-rate film.

    It computes what every instance of the kernel computes, as
    :func:`film_shaper_cr_plain` does: the exciter, the film and the shaper
    parameters widened to at least float32 (under float32 they are the
    tensors given), the chain in that type, the output rounded once to the
    exciter's dtype. Autograd through it gives d_exciter in the exciter's
    dtype and d_film in the film's."""
    if film_a.shape[:-1] != exciter.shape[:-1]:
        raise ValueError(
            f"film {tuple(film_a.shape)} and exciter {tuple(exciter.shape)} differ in (B, Ta)"
        )
    acc = torch.promote_types(exciter.dtype, torch.float32)
    out = film_shaper_chain(exciter.to(acc), film_a.to(acc), cast_params(shaper_params, acc))
    return out.to(exciter.dtype)


def film_shaper_fl_grad_plain(
    exciter: torch.Tensor, film_a: torch.Tensor, shaper_params: Dict, dy: torch.Tensor
):
    """The plain version of the audio-rate backward (JAX ``_fused_bwd_fl``):
    ``torch.autograd.grad`` through :func:`film_shaper_fl_plain` with
    cotangent ``dy`` -> (d_exciter (B, Ta, C), d_film (B, Ta, 4C), d_planes
    (170, C) in the :func:`pack_weights` layout), each in its input's dtype
    (the planes float32)."""
    with torch.enable_grad():
        exc = exciter.detach().requires_grad_()
        film_a = film_a.detach().requires_grad_()
        planes = pack_weights(shaper_params).detach().requires_grad_()
        out = film_shaper_fl_plain(exc, film_a, unpack_weight_grads(planes))
        return torch.autograd.grad(out, (exc, film_a, planes), dy)


# (exciter dtype, film dtype) -> the C symbols' suffix of kernels 5 and 6's instance
_FL_INSTANCES = {
    (torch.float32, torch.float32): "",
    (torch.bfloat16, torch.bfloat16): "_bf16",
}


def _check_fl(exciter: torch.Tensor, film_a: torch.Tensor, weights: torch.Tensor) -> str:
    """What the audio-rate kernels take: (B, Ta, C) exciter and (B, Ta, 4C)
    film, both float32 or both bfloat16, with 1 <= B*Ta <= 2^30 (odd B*Ta
    included: JAX's even B*Ta and padded tile were TPU layout limits) and
    the float32 (170, C) planes; -> the suffix of the instance."""
    _check_tensors(("exciter", "film"), exciter=exciter, film=film_a, shaper_weights=weights)
    instance = _FL_INSTANCES.get((exciter.dtype, film_a.dtype))
    if instance is None:
        raise TypeError(
            f"the audio-rate kernels take a film of the exciter's dtype: exciter "
            f"{exciter.dtype}, film {film_a.dtype}"
        )
    if exciter.dim() != 3 or exciter.shape[2] != C:
        raise ValueError(f"exciter must be (B, Ta, {C}), got {tuple(exciter.shape)}")
    b, ta, _ = exciter.shape
    if tuple(film_a.shape) != (b, ta, 4 * C):
        raise ValueError(f"film must be ({b}, {ta}, {4 * C}), got {tuple(film_a.shape)}")
    if not 1 <= b * ta <= _MAX_SAMPLES:
        raise ValueError(f"need 1 <= B*Ta <= {_MAX_SAMPLES}, got {b * ta}")
    if tuple(weights.shape) != (170, C):
        raise ValueError(f"packed weights must be (170, {C}), got {tuple(weights.shape)}")
    return instance


def _launch_forward_fl(exciter, film_a, weights) -> torch.Tensor:
    instance = _check_fl(exciter, film_a, weights)
    symbol = "newt_fused_fl_forward" + instance
    out = torch.empty_like(exciter)
    b, ta, _ = exciter.shape
    with torch.cuda.device(exciter.device):
        lib = _lib("newt_fused_fl", symbol, 4, n_ints=1)
        stream = torch.cuda.current_stream(exciter.device).cuda_stream
        err = getattr(lib, symbol)(
            exciter.data_ptr(), film_a.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b * ta, stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    _count(film_shaper_fl, "launches" + instance)
    return out


_CHUNK = 32  # samples per chunk of newt_fused_fl_bwd.cu: a warp's lanes


def _chunk_blocks(n_samples: int, resident: int) -> int:
    """The persistent grid of the audio-rate backward, which walks the flat
    sample index in 32-sample chunks (a block holds one chunk at a time and
    strides by the grid): one block per chunk, at most ``resident``, the
    blocks the card holds at once."""
    return min(-(-n_samples // _CHUNK), resident)


def _word_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy when its data is not 4-byte aligned
    (a view at an odd bfloat16 offset): the backward's staging copies move
    4-byte words."""
    return t if t.data_ptr() % 4 == 0 else t.clone(memory_format=torch.contiguous_format)


def _launch_backward_fl(exciter, film_a, weights, dy):
    """-> (d_exciter, d_film, d_planes) from ``csrc/newt_fused_fl_bwd.cu``,
    d_exciter and d_film in the exciter's dtype, d_planes float32. The
    per-block weight partials are allocated here, for :func:`_chunk_blocks`
    blocks."""
    instance = _check_fl(exciter, film_a, weights)
    symbol = "newt_fused_fl_backward" + instance
    if dy.shape != exciter.shape or dy.dtype != exciter.dtype or dy.device != exciter.device:
        raise ValueError(f"dy must be {exciter.dtype} {tuple(exciter.shape)} on {exciter.device}")
    exciter, film_a, dy = (_word_aligned(t) for t in (exciter, film_a, dy))
    b, ta, _ = exciter.shape
    d_exc = torch.empty_like(exciter)
    d_film = torch.empty_like(film_a)
    d_planes = torch.empty_like(weights)
    with torch.cuda.device(exciter.device):
        lib = _lib("newt_fused_fl_bwd", symbol, 8, n_ints=2)
        blocks = _chunk_blocks(
            b * ta, _resident_blocks(lib, "newt_fused_fl_backward_resident_blocks", exciter.device))
        w_part = torch.empty((blocks, 170, C), dtype=torch.float32, device=exciter.device)
        stream = torch.cuda.current_stream(exciter.device).cuda_stream
        err = getattr(lib, symbol)(
            exciter.data_ptr(), film_a.data_ptr(), weights.data_ptr(), dy.data_ptr(),
            d_exc.data_ptr(), d_film.data_ptr(), d_planes.data_ptr(), w_part.data_ptr(),
            b * ta, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    _count(film_shaper_fl, "bwd_launches" + instance)
    return d_exc, d_film, d_planes


class _FilmShaperFL(torch.autograd.Function):
    """The audio-rate kernel pair as one differentiable function of
    (exciter, film, packed planes). Forward saves only its inputs, as JAX's
    ``_fused_fwd_fl``; backward recomputes the forward in the kernel."""

    @staticmethod
    def forward(ctx, exciter, film_a, packed):
        ctx.save_for_backward(exciter, film_a, packed)
        return _launch_forward_fl(exciter, film_a, packed)

    @staticmethod
    def backward(ctx, dy):
        exciter, film_a, packed = ctx.saved_tensors
        return _launch_backward_fl(exciter, film_a, packed, dy.contiguous())


def film_shaper_fl(
    exciter: torch.Tensor,
    film_a: torch.Tensor,
    shaper_params: Dict,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, Ta, 64) exciter + (B, Ta, 256) audio-rate film -> (B, Ta, 64)
    (JAX ``film_shaper_fused_fl`` and ``film_shaper_fused``).

    CPU tensors take :func:`film_shaper_fl_plain` (autograd differentiates
    it). CUDA tensors launch ``csrc/newt_fused_fl.cu`` on the current
    stream after :func:`_check_fl` (a float32 exciter and film, or both
    bfloat16); anything the kernels do not take raises. The output takes
    the exciter's dtype. With grad enabled and an input that needs a gradient, the call
    goes through :class:`_FilmShaperFL`, whose backward is
    ``csrc/newt_fused_fl_bwd.cu``. ``packed`` as in :func:`film_shaper_cr`."""
    if exciter.device.type == "cpu":
        return film_shaper_fl_plain(exciter, film_a, shaper_params)
    if exciter.device.type != "cuda":
        raise ValueError(f"unsupported device {exciter.device}")
    weights = _packed_for(shaper_params, packed)
    if _needs_grad(exciter, film_a, weights):
        return _FilmShaperFL.apply(exciter, film_a, weights)
    return _launch_forward_fl(exciter, film_a, weights)


film_shaper_fl.launches = 0
film_shaper_fl.bwd_launches = 0
film_shaper_fl.launches_bf16 = film_shaper_fl.bwd_launches_bf16 = 0  # (bf16, bf16)


# ---------------------------------------------------------------------------
# streaming: the FiLM segment-ramped from the carried frame, forward only
# ---------------------------------------------------------------------------
def supports_stream(shaper, n_audio: int, n_control: int) -> bool:
    """The stream kernel's gate, the cr kernel's: the shipped architecture
    and an integer hop, any K >= 1 (JAX's even K was a TPU tiling limit).
    A name of its own, as in JAX, so the stream path states which kernel
    it asks about."""
    return supports_cr(shaper, n_audio, n_control)


def film_shaper_stream_plain(
    exciter: torch.Tensor,
    prev_film: torch.Tensor,
    film_c: torch.Tensor,
    shaper_params: Dict,
    hop: int,
) -> torch.Tensor:
    """The plain PyTorch version of the stream kernel: ``segment_interp``
    of the (B, 4C) carried frame and the (B, K, 4C) buffer frames to
    K*hop samples, then :func:`film_shaper_chain`."""
    ta = exciter.shape[1]
    if hop < 1 or ta != film_c.shape[1] * hop:
        raise ValueError(f"exciter length {ta} != K {film_c.shape[1]} * hop {hop}")
    return film_shaper_chain(exciter, segment_interp(prev_film, film_c, hop), shaper_params)


def _check_stream(exciter, prev_film, film_c, weights, hop):
    _check(exciter, film_c, weights, hop)
    if prev_film.device != exciter.device:
        raise ValueError(f"prev_film is on {prev_film.device}, exciter on {exciter.device}")
    if prev_film.dtype != torch.float32:
        raise TypeError(f"prev_film must be float32, got {prev_film.dtype}")
    if tuple(prev_film.shape) != (exciter.shape[0], 4 * C) or not prev_film.is_contiguous():
        raise ValueError(
            f"prev_film must be contiguous ({exciter.shape[0]}, {4 * C}), got {tuple(prev_film.shape)}"
        )


def _launch_stream(exciter, prev_film, film_c, weights, hop) -> torch.Tensor:
    _check_stream(exciter, prev_film, film_c, weights, hop)
    out = torch.empty_like(exciter)
    b, ta, _ = exciter.shape
    with torch.cuda.device(exciter.device):
        lib = _lib("newt_fused_stream", "newt_fused_stream_forward", 5, n_ints=5)
        blocks = _resident_blocks(lib, "newt_fused_stream_resident_blocks", exciter.device)
        stream = torch.cuda.current_stream(exciter.device).cuda_stream
        err = lib.newt_fused_stream_forward(
            exciter.data_ptr(), prev_film.data_ptr(), film_c.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b * ta, ta, film_c.shape[1], hop, blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"newt_fused_stream_forward did not launch: CUDA error {err}")
    film_shaper_stream.launches += 1
    return out


def film_shaper_stream(
    exciter: torch.Tensor,
    prev_film: torch.Tensor,
    film_c: torch.Tensor,
    shaper_params: Dict,
    hop: int,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, K*hop, 64) exciter + (B, 256) carried FiLM frame + (B, K, 256)
    buffer frames -> (B, K*hop, 64) (JAX ``film_shaper_fused_stream``).

    CPU tensors take :func:`film_shaper_stream_plain`. CUDA tensors launch
    ``csrc/newt_fused_stream.cu`` on the current stream after the checks of
    the cr kernel (and prev_film's); what it does not take raises. The
    kernel has no backward (a stream is never differentiated), so a CUDA
    call that would need a gradient raises too. ``film_shaper_stream
    .launches`` counts the launches."""
    if exciter.device.type == "cpu":
        return film_shaper_stream_plain(exciter, prev_film, film_c, shaper_params, hop)
    if exciter.device.type != "cuda":
        raise ValueError(f"unsupported device {exciter.device}")
    weights = pack_weights(shaper_params) if packed is None else packed
    if _needs_grad(exciter, prev_film, film_c, weights):
        raise ValueError(
            "the stream kernel is forward only: call it under torch.no_grad() "
            "or torch.inference_mode()"
        )
    return _launch_stream(exciter, prev_film, film_c, weights, hop)


film_shaper_stream.launches = 0


# ---------------------------------------------------------------------------
# exciter-fused: the harmonic bank and the H -> C mixer computed in the
# kernel from the wrapped phase and f0 (JAX bank_film_shaper_fused_xcr), and
# with NEWT's C -> 1 output mix as well (JAX bank_newt_fused_xfull)
# ---------------------------------------------------------------------------
H_MAX = 128  # the most harmonics the exciter-fused kernels take (JAX's bound)
_SAMPLES_PER_PASS = 24  # samples a block pass of newt_fused_x.cu: kGroups * kS


def supports_xcr(shaper, n_audio: int, n_control: int, n_harmonics: int) -> bool:
    """The exciter-fused kernels' gate: :func:`supports_cr` (the shipped
    shaper, any integer hop, any Tc) and 2 <= H <= :data:`H_MAX`, the
    bound the kernels' shared memory is sized for."""
    return supports_cr(shaper, n_audio, n_control) and 2 <= n_harmonics <= H_MAX


def _x_pre_plain(phase_w, f0_up, offsets, film_c, mixer_params, shaper_params, n_harmonics,
                 sample_rate, hop) -> torch.Tensor:
    """The exciter-fused chain in float32 (at least), before any rounding to
    the mixer's dtype: the bank, the mixer widened, then
    :func:`film_shaper_cr_plain` (which widens the film and the shaper)."""
    bank = bank_from_wrapped_phase(phase_w, f0_up, n_harmonics, sample_rate, offsets)
    exciter = dense_apply(cast_params(mixer_params, bank.dtype), bank)
    return film_shaper_cr_plain(exciter, film_c, shaper_params, hop)


def bank_film_shaper_xcr_plain(
    phase_w: torch.Tensor,
    f0_up: torch.Tensor,
    offsets: torch.Tensor,
    film_c: torch.Tensor,
    mixer_params: Dict,
    shaper_params: Dict,
    n_harmonics: int,
    sample_rate: float,
    hop: int,
) -> torch.Tensor:
    """The plain version of the xcr kernel: (B, Ta) wrapped phase and f0 ->
    ``bank_from_wrapped_phase`` (B, Ta, H) -> the harmonic mixer ``x @ w +
    b`` (B, Ta, C) -> :func:`film_shaper_cr_plain` with the (B, Tc, 4C)
    control-rate film -> (B, Ta, C) in the mixer's dtype.

    It computes what every instance of the kernel computes: the mixer, the
    film and the shaper widened to float32 (under float32 the tensors given),
    the chain in float32, the output rounded once to the mixer's dtype
    (bfloat16 with a bfloat16 or float32 film). Autograd through it gives
    the mixer's and the film's gradients in their own dtypes."""
    return _x_pre_plain(phase_w, f0_up, offsets, film_c, mixer_params, shaper_params,
                        n_harmonics, sample_rate, hop).to(mixer_params["w"].dtype)


def bank_newt_xfull_plain(
    phase_w: torch.Tensor,
    f0_up: torch.Tensor,
    offsets: torch.Tensor,
    film_c: torch.Tensor,
    mixer_params: Dict,
    w_out: torch.Tensor,
    shaper_params: Dict,
    n_harmonics: int,
    sample_rate: float,
    hop: int,
) -> torch.Tensor:
    """The plain version of the xfull kernel: :func:`bank_film_shaper_xcr_plain`
    then NEWT's C -> 1 output mix with the (C,) weights ``w_out``, its bias
    left out -> (B, Ta) in the mixer's dtype: under bfloat16 the (B, Ta, C)
    chain and the mix stay float32 and only the mixed output is rounded, as
    in the kernel."""
    shaped = _x_pre_plain(phase_w, f0_up, offsets, film_c, mixer_params, shaper_params,
                          n_harmonics, sample_rate, hop)
    return torch.matmul(shaped, w_out.to(shaped.dtype)).to(mixer_params["w"].dtype)


def _x_grad_plain(phase_w, f0_up, offsets, film_c, mixer_params, w_out, shaper_params,
                  n_harmonics, sample_rate, hop, dy):
    with torch.enable_grad():
        film_c = film_c.detach().requires_grad_()
        w = mixer_params["w"].detach().requires_grad_()
        b = mixer_params["b"].detach().requires_grad_()
        planes = pack_weights(shaper_params).detach().requires_grad_()
        args = (phase_w, f0_up, offsets, film_c, {"w": w, "b": b})
        shaper = unpack_weight_grads(planes)
        if w_out is None:
            out = bank_film_shaper_xcr_plain(*args, shaper, n_harmonics, sample_rate, hop)
            return torch.autograd.grad(out, (film_c, w, b, planes), dy)
        w_out = w_out.detach().requires_grad_()
        out = bank_newt_xfull_plain(*args, w_out, shaper, n_harmonics, sample_rate, hop)
        return torch.autograd.grad(out, (film_c, w, b, planes, w_out), dy)


def bank_film_shaper_xcr_grad_plain(
    phase_w, f0_up, offsets, film_c, mixer_params, shaper_params, n_harmonics, sample_rate, hop, dy
):
    """The plain version of the xcr backward (JAX ``_fused_bwd_xcr``):
    ``torch.autograd.grad`` through :func:`bank_film_shaper_xcr_plain` with
    cotangent ``dy`` (B, Ta, C) -> (d_film_c (B, Tc, 4C), d_w (H, C), d_b
    (C,), d_planes (170, C)), each in its input's dtype (the planes
    float32). Phase, f0 and offsets get none, as in JAX."""
    return _x_grad_plain(phase_w, f0_up, offsets, film_c, mixer_params, None, shaper_params,
                         n_harmonics, sample_rate, hop, dy)


def bank_newt_xfull_grad_plain(
    phase_w, f0_up, offsets, film_c, mixer_params, w_out, shaper_params, n_harmonics,
    sample_rate, hop, dy
):
    """The plain version of the xfull backward (JAX ``_fused_bwd_xfull``):
    as :func:`bank_film_shaper_xcr_grad_plain` with the (B, Ta) cotangent of
    the output mix, and d_w_out (C,) last."""
    return _x_grad_plain(phase_w, f0_up, offsets, film_c, mixer_params, w_out, shaper_params,
                         n_harmonics, sample_rate, hop, dy)


def _check_x(phase, f0, offsets, film_c, w, b, weights, w_out, n_harmonics, hop) -> str:
    """What the exciter-fused kernels take: (B, Ta) phase and f0, (B, Tc, 4C)
    film with Ta = Tc * hop, (H,) offsets, (H, C) and (C,) mixer, the (170,
    C) planes and, for xfull, the (C,) output-mix weights; 2 <= H <= 128,
    1 <= B*Ta <= 2^30. Phase, f0, offsets and planes float32; the mixer (w,
    b and w_out in one dtype) and the film float32, both bfloat16, or a
    bfloat16 mixer with a float32 film. -> the suffix of the instance."""
    tensors = dict(phase=phase, f0=f0, offsets=offsets, film_c=film_c, mixer_w=w, mixer_b=b,
                   shaper_weights=weights)
    if w_out is not None:
        tensors["w_out"] = w_out
    _check_tensors(("film_c", "mixer_w", "mixer_b", "w_out"), **tensors)
    mixer_dtypes = {t.dtype for t in (w, b, w_out) if t is not None}
    instance = _CR_INSTANCES.get((w.dtype, film_c.dtype))  # kernels 7-8: (mixer, film) dtypes
    if len(mixer_dtypes) > 1 or instance is None:
        raise TypeError(
            f"the exciter-fused kernels take a mixer (w, b, w_out) of one dtype and a film of "
            f"its dtype or float32: mixer {sorted(map(str, mixer_dtypes))}, film {film_c.dtype}"
        )
    if phase.dim() != 2 or f0.shape != phase.shape:
        raise ValueError(f"phase and f0 must be one (B, Ta), got {tuple(phase.shape)}, {tuple(f0.shape)}")
    bsz, ta = phase.shape
    if film_c.dim() != 3 or film_c.shape[0] != bsz or film_c.shape[2] != 4 * C:
        raise ValueError(f"film_c must be ({bsz}, Tc, {4 * C}), got {tuple(film_c.shape)}")
    tc = film_c.shape[1]
    if not 1 <= hop <= _MAX_HOP or tc < 1 or ta != tc * hop:
        raise ValueError(f"need Ta = Tc * hop with 1 <= hop <= {_MAX_HOP}: Ta={ta}, Tc={tc}, hop={hop}")
    if not 1 <= bsz * ta <= _MAX_SAMPLES:
        raise ValueError(f"need 1 <= B*Ta <= {_MAX_SAMPLES}, got {bsz * ta}")
    h = n_harmonics
    if not 2 <= h <= H_MAX or offsets.shape != (h,) or w.shape != (h, C) or b.shape != (C,):
        raise ValueError(
            f"need 2 <= H <= {H_MAX}, offsets ({h},), mixer w ({h}, {C}) and b ({C},): got "
            f"{tuple(offsets.shape)}, {tuple(w.shape)}, {tuple(b.shape)}"
        )
    if tuple(weights.shape) != (170, C):
        raise ValueError(f"packed weights must be (170, {C}), got {tuple(weights.shape)}")
    if w_out is not None and w_out.shape != (C,):
        raise ValueError(f"w_out must be ({C},), got {tuple(w_out.shape)}")
    return instance


def _launch_forward_x(phase, f0, offsets, film_c, w, b, weights, w_out, n_harmonics, sample_rate, hop):
    """``csrc/newt_fused_x.cu``: xcr -> (B, Ta, C) when ``w_out`` is None,
    xfull -> (B, Ta) otherwise, in the mixer's dtype."""
    instance = _check_x(phase, f0, offsets, film_c, w, b, weights, w_out, n_harmonics, hop)
    symbol = "newt_fused_x_forward" + instance
    bsz, ta = phase.shape
    xfull = w_out is not None
    out = torch.empty((bsz, ta) if xfull else (bsz, ta, C), dtype=w.dtype, device=phase.device)
    query = ("newt_fused_xfull_resident_blocks" if xfull else "newt_fused_xcr_resident_blocks") + instance
    with torch.cuda.device(phase.device):
        lib = _lib("newt_fused_x", symbol, 9, n_ints=6, n_floats=1)
        needed = -(-bsz * ta // _SAMPLES_PER_PASS)
        blocks = min(needed, _resident_blocks(lib, query, phase.device))
        stream = torch.cuda.current_stream(phase.device).cuda_stream
        err = getattr(lib, symbol)(
            phase.data_ptr(), f0.data_ptr(), offsets.data_ptr(), film_c.data_ptr(),
            w.data_ptr(), b.data_ptr(), weights.data_ptr(), w_out.data_ptr() if xfull else None,
            out.data_ptr(), bsz * ta, ta, film_c.shape[1], hop, n_harmonics, blocks,
            sample_rate / 2.0, stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    _count(bank_newt_xfull if xfull else bank_film_shaper_xcr, "launches" + instance)
    return out


def _launch_backward_x(phase, f0, offsets, film_c, w, b, weights, w_out, n_harmonics,
                       sample_rate, hop, dy):
    """``csrc/newt_fused_x_bwd.cu`` -> (d_film_c, d_w, d_b, d_planes) and,
    for xfull (``w_out`` given), d_w_out: d_film_c in the film's dtype, the
    mixer's gradients in the mixer's, d_planes float32. The kernel sums them
    in float32 in one (rows, C) table (planes, mixer w, b and w_out), rounded
    here once to the mixer's dtype. The table's block partials and the
    per-segment FiLM partials are allocated here, for :func:`_segment_blocks`
    blocks."""
    instance = _check_x(phase, f0, offsets, film_c, w, b, weights, w_out, n_harmonics, hop)
    symbol = "newt_fused_x_backward" + instance
    xfull = w_out is not None
    out_shape = phase.shape if xfull else (*phase.shape, C)
    if (dy.shape != out_shape or dy.dtype != w.dtype or dy.device != phase.device
            or not dy.is_contiguous()):
        raise ValueError(f"dy must be contiguous {w.dtype} {tuple(out_shape)} on {phase.device}")
    bsz, ta = phase.shape
    tc = film_c.shape[1]
    h = n_harmonics
    rows = 170 + h + 1 + int(xfull)  # planes, mixer w, mixer b, w_out
    d_film = torch.empty_like(film_c)
    grads = phase.new_empty((rows, C))
    query = ("newt_fused_xfull_backward_resident_blocks" if xfull
             else "newt_fused_xcr_backward_resident_blocks") + instance
    with torch.cuda.device(phase.device):
        lib = _lib("newt_fused_x_bwd", symbol, 13, n_ints=5, n_floats=1)
        blocks = _segment_blocks(bsz * tc, _resident_blocks(lib, query, phase.device))
        film_part = phase.new_empty((bsz * tc, 3, 4 * C))
        part = phase.new_empty((blocks, rows, C))
        stream = torch.cuda.current_stream(phase.device).cuda_stream
        err = getattr(lib, symbol)(
            phase.data_ptr(), f0.data_ptr(), offsets.data_ptr(), film_c.data_ptr(),
            w.data_ptr(), b.data_ptr(), weights.data_ptr(), w_out.data_ptr() if xfull else None,
            dy.data_ptr(), d_film.data_ptr(), grads.data_ptr(), film_part.data_ptr(),
            part.data_ptr(), bsz, ta, tc, h, blocks, sample_rate / 2.0, stream,
        )
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    _count(bank_newt_xfull if xfull else bank_film_shaper_xcr, "bwd_launches" + instance)
    out = (d_film, grads[170:170 + h].to(w.dtype), grads[170 + h].to(w.dtype), grads[:170])
    return (*out, grads[171 + h].to(w.dtype)) if xfull else out


class _BankFilmShaperX(torch.autograd.Function):
    """The exciter-fused kernel pair as one differentiable function of
    (film_c, mixer w, mixer b, packed planes, w_out); phase, f0 and offsets
    are data and get no gradient, as in JAX. Forward saves only its inputs;
    backward recomputes the bank, the mix and the chain in the kernel, and
    returns each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, phase, f0, offsets, film_c, w, b, packed, w_out, n_harmonics, sample_rate, hop):
        ctx.consts = (n_harmonics, sample_rate, hop)
        ctx.save_for_backward(phase, f0, offsets, film_c, w, b, packed, w_out)
        return _launch_forward_x(phase, f0, offsets, film_c, w, b, packed, w_out,
                                 n_harmonics, sample_rate, hop)

    @staticmethod
    def backward(ctx, dy):
        phase, f0, offsets, film_c, w, b, packed, w_out = ctx.saved_tensors
        grads = _launch_backward_x(phase, f0, offsets, film_c, w, b, packed, w_out,
                                   *ctx.consts, dy.contiguous())
        d_w_out = grads[4] if w_out is not None else None
        return (None, None, None, *grads[:4], d_w_out, None, None, None)


def _bank_film_shaper_x(phase_w, f0_up, offsets, film_c, mixer_params, w_out, shaper_params,
                        n_harmonics, sample_rate, hop, packed):
    """The CUDA side of both wrappers: the kernel alone without a gradient,
    :class:`_BankFilmShaperX` with one."""
    if phase_w.device.type != "cuda":
        raise ValueError(f"unsupported device {phase_w.device}")
    weights = _packed_for(shaper_params, packed)
    w, b = mixer_params["w"], mixer_params["b"]
    args = (phase_w, f0_up, offsets, film_c, w, b, weights, w_out, n_harmonics, sample_rate, hop)
    if _needs_grad(film_c, w, b, weights, *(() if w_out is None else (w_out,))):
        return _BankFilmShaperX.apply(*args)
    return _launch_forward_x(*args)


def bank_film_shaper_xcr(
    phase_w: torch.Tensor,
    f0_up: torch.Tensor,
    offsets: torch.Tensor,
    film_c: torch.Tensor,
    mixer_params: Dict,
    shaper_params: Dict,
    n_harmonics: int,
    sample_rate: float,
    hop: int,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, Ta) wrapped phase + (B, Ta) f0 + (H,) offsets + (B, Tc, 256)
    control-rate film + harmonic mixer {w (H, 64), b (64,)} -> (B, Ta, 64)
    (JAX ``bank_film_shaper_fused_xcr``): the bank, the mixer and FiLM ->
    shapers -> FiLM in one kernel; neither the (B, Ta, H) bank nor the
    (B, Ta, 64) exciter is written to device memory.

    CPU tensors take :func:`bank_film_shaper_xcr_plain`. CUDA tensors launch
    ``csrc/newt_fused_x.cu`` on the current stream after :func:`_check_x` (a
    float32 mixer and film, or a bfloat16 mixer with a bfloat16 or float32
    film); anything the kernel does not take raises. The output takes the
    mixer's dtype. With a gradient needed the call goes through
    :class:`_BankFilmShaperX`, whose backward is ``csrc/newt_fused_x_bwd.cu``.
    ``packed`` as in :func:`film_shaper_cr`. ``bank_film_shaper_xcr.launches``
    / ``.bwd_launches`` count the float32 instance's launches, the
    ``_bf16`` and ``_bf16_f32`` counters the bf16 ones'."""
    if phase_w.device.type == "cpu":
        return bank_film_shaper_xcr_plain(phase_w, f0_up, offsets, film_c, mixer_params,
                                          shaper_params, n_harmonics, sample_rate, hop)
    return _bank_film_shaper_x(phase_w, f0_up, offsets, film_c, mixer_params, None,
                               shaper_params, n_harmonics, sample_rate, hop, packed)


def bank_newt_xfull(
    phase_w: torch.Tensor,
    f0_up: torch.Tensor,
    offsets: torch.Tensor,
    film_c: torch.Tensor,
    mixer_params: Dict,
    w_out: torch.Tensor,
    shaper_params: Dict,
    n_harmonics: int,
    sample_rate: float,
    hop: int,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`bank_film_shaper_xcr` with NEWT's 64 -> 1 output mix (the
    (64,) weights ``w_out``) in the kernel -> (B, Ta) audio before the
    mixer's bias (JAX ``bank_newt_fused_xfull``; add the bias outside).
    CPU tensors take :func:`bank_newt_xfull_plain`; CUDA tensors launch the
    xfull instance of ``csrc/newt_fused_x.cu`` and, for a gradient, of
    ``csrc/newt_fused_x_bwd.cu``, in the dtypes :func:`bank_film_shaper_xcr`
    takes (``w_out`` in the mixer's). ``bank_newt_xfull.launches`` /
    ``.bwd_launches`` count them, with the same bf16 counters."""
    if phase_w.device.type == "cpu":
        return bank_newt_xfull_plain(phase_w, f0_up, offsets, film_c, mixer_params, w_out,
                                     shaper_params, n_harmonics, sample_rate, hop)
    return _bank_film_shaper_x(phase_w, f0_up, offsets, film_c, mixer_params, w_out,
                               shaper_params, n_harmonics, sample_rate, hop, packed)


for _x in (bank_film_shaper_xcr, bank_newt_xfull):
    _x.launches = _x.bwd_launches = 0
    _x.launches_bf16 = _x.bwd_launches_bf16 = 0  # (bf16 mixer, bf16 film)
    _x.launches_bf16_f32 = _x.bwd_launches_bf16_f32 = 0  # (bf16 mixer, float32 film)
del _x
