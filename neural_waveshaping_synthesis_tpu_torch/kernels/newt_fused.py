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
* :func:`film_shaper_cr` is the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/newt_fused_cr.cu`` or raises —
  there is no fallback. ``film_shaper_cr.launches`` counts launches.

Forward only: the backward (``_fused_bwd_cr`` in JAX) is not ported
yet, so the wrapper refuses inputs that would need a gradient.
"""
import ctypes
from typing import Dict, Optional

import torch

from ..models.modules import film, shaper_apply
from ..ops.upsample import linear_upsample
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
    film to Ta = Tc*hop samples, then :func:`film_shaper_chain`."""
    ta = exciter.shape[1]
    if ta != film_c.shape[1] * hop:
        raise ValueError(f"exciter length {ta} != Tc {film_c.shape[1]} * hop {hop}")
    return film_shaper_chain(exciter, linear_upsample(film_c, ta), shaper_params)


def _lib() -> ctypes.CDLL:
    lib = _build.load("newt_fused_cr")
    fn = lib.newt_fused_cr_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(exciter: torch.Tensor, film_c: torch.Tensor, weights: torch.Tensor, hop: int):
    dev = exciter.device
    for name, t in (("exciter", exciter), ("film_c", film_c), ("shaper weights", weights)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, exciter on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


def film_shaper_cr(
    exciter: torch.Tensor,
    film_c: torch.Tensor,
    shaper_params: Dict,
    hop: int,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, Ta, 64) exciter + (B, Tc, 256) control-rate film -> (B, Ta, 64).

    CPU tensors take :func:`film_shaper_cr_plain`. CUDA tensors launch
    the kernel on the current stream, after checking device, dtype
    (float32), shapes and contiguity; anything the kernel does not take
    raises. ``packed`` is ``pack_weights(shaper_params)`` when the caller
    keeps it (NEWT packs once per change of its parameters); packed here
    otherwise."""
    if exciter.device.type == "cpu":
        return film_shaper_cr_plain(exciter, film_c, shaper_params, hop)
    if exciter.device.type != "cuda":
        raise ValueError(f"unsupported device {exciter.device}")
    weights = pack_weights(shaper_params) if packed is None else packed
    leaves = [shaper_params["input_scale"]]
    leaves += [t for layer in shaper_params["layers"] for t in layer.values()]
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (exciter, film_c, weights, *leaves)
    ):
        raise NotImplementedError(
            "film_shaper_cr is forward-only: its backward kernel is not ported "
            "yet (ROADMAP.md); call it under torch.no_grad()/inference_mode()"
        )
    _check(exciter, film_c, weights, hop)
    out = torch.empty_like(exciter)
    b, ta, _ = exciter.shape
    with torch.cuda.device(exciter.device):
        lib = _lib()
        stream = torch.cuda.current_stream(exciter.device).cuda_stream
        err = lib.newt_fused_cr_forward(
            exciter.data_ptr(), film_c.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b * ta, ta, film_c.shape[1], hop, stream,
        )
    if err != 0:
        raise RuntimeError(f"newt_fused_cr_forward did not launch: CUDA error {err}")
    film_shaper_cr.launches += 1
    return out


film_shaper_cr.launches = 0
