"""The roofline's dependent chains: the CUDA kernel (kernel 9), its plain
PyTorch versions and the wrappers that choose between them.

Counterpart of the JAX ``scripts/roofline_shaper.py`` ``pallas_chain``,
the trivial Pallas kernel with which that script reads the chip's own FMA
and sine rates. Per element of ``x`` and ``x0``:

* ``fma``: ``x <- x * a + x0``, ``k`` times (``ilp=4``: four independent
  chains started at ``x``, ``x/2``, ``x/4`` and ``x/8``, summed at the end,
  the JAX script's ``fma128_ilp4``);
* ``sin``: ``x <- psin(x) + x0``, ``k`` times, ``psin`` the polynomial sine
  of ``ops/fastmath.py`` and of the shaper kernels (``newt_shaper.cuh``)
  (``ilp=4``: four chains, as for ``fma``).

* :func:`fma_chain_plain` and :func:`psin_chain_plain` are the chains in
  plain PyTorch, one operator per step (the CPU path and the tests use them;
  ``chip_smoke.py`` holds the kernel against them on the card). On the card
  an eager chain is one launch per operator, each reading and writing the
  whole array, so it is bound by device memory: no compute ceiling;
* :func:`fma_chain` and :func:`psin_chain` are the wrappers: a CPU tensor
  goes to the plain version, a CUDA tensor launches
  ``csrc/roofline_chain.cu`` or raises (there is no fallback). Forward only.
  ``fma_chain.launches`` and ``psin_chain.launches`` count the serial
  instances' launches, ``.launches_ilp4`` the four-chain ones'.

The kernel contracts ``x * a + x0`` into one FMA, so it rounds once a step
where the plain version rounds twice; the chain contracts (``|a| < 1``, the
sine's slope at most 1), so the two stay within the kernels' bar (rtol 1e-4,
atol 1e-5).

The module also holds the H100's data-sheet rates and the operation and byte
counts of the shaper kernels (1, 2, 5, 6) and of kernel 9, from which
``chip_smoke.py`` and ``scripts/torch_roofline_shaper.py`` compute the
least time the card could take (:func:`bound`).
"""
import ctypes

import torch

from ..ops.fastmath import _sin_poly
from . import _build

_ILP = (1, 4)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# f32 operations per (sample, channel) in newt_fused_cr.cu, an FMA as two:
# FiLM lerp 4*(2 mul + add) + division + (1-w) = 14; FiLM-in FMA + scale = 3;
# MLP 1->8->8->8->1 multiply-adds (8 + 64 + 64 + 8) * 2 = 288; 25 sines of
# (mul, rint, fma, mul, 6 fma, mul) = 18 each = 450; FiLM-out FMA = 2.
CR_FLOP_PER_ELEMENT = 14 + 3 + 288 + 450 + 2
# ... and in newt_fused_cr_bwd.cu. Forward recompute: lerp 14, FiLM-in +
# scale 3, MLP 288, 25 sine-and-cosine pairs sharing one range reduction
# (mul, rint, fma, mul; sine 6 fma + mul; cosine 7 fma) = 31 each = 775.
# Chain rule: d gamma_out path 2; layer 4 weight/bias grads 16 + 1, dp3 16;
# layers 3 and 2 each weight grads 128, input grads 128, bias 8, times the
# cosine 8; layer 1 bias 8, weight 16, input 16; input scale 2, dx 1,
# d_exciter 1; FiLM cotangents 2; lerp transpose 4 * (2 mul + 2 add) = 16.
CR_BWD_FLOP_PER_ELEMENT = (
    (14 + 3 + 288 + 25 * 31)
    + (2 + 16 + 1 + 16 + 2 * (128 + 128 + 8 + 8) + 8 + 16 + 16 + 2 + 1 + 1 + 2 + 16)
)
# ... and in newt_fused_fl.cu and newt_fused_fl_bwd.cu: the cr counts without
# the lerp (14) and, in the backward, without its transpose (16): the FiLM
# arrives at audio rate and its cotangents leave at audio rate.
FL_FLOP_PER_ELEMENT = CR_FLOP_PER_ELEMENT - 14
FL_BWD_FLOP_PER_ELEMENT = CR_BWD_FLOP_PER_ELEMENT - 14 - 16
PSIN_FLOP = 18  # a polynomial sine, as CR_FLOP_PER_ELEMENT counts one


def bound(flop: float, nbytes: float):
    """-> (least ms on an H100 SXM for this work, "operations" or "bytes"):
    the larger of ``flop`` float32 operations over the peak rate and
    ``nbytes`` over the memory rate."""
    t_ops, t_bytes = flop / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def shaper_bytes(exc: int, film: int, planes: int, backward: bool = False) -> int:
    """The bytes a shaper kernel (1, 2, 5, 6; 7 and 8 add the bank) must
    move, from the byte sizes of its exciter, its FiLM and its weight
    planes: exciter in and out (and dy in), the FiLM in (and d_film out),
    the planes in (and d_planes out)."""
    return 3 * exc + 2 * film + 2 * planes if backward else 2 * exc + film + planes


def chain_flop(kind: str, k: int, ilp: int = 1) -> int:
    """Float32 operations per element of kernel 9's ``kind`` ("fma" or
    "sin") instance, an FMA as two: ``ilp`` chains of ``k`` steps (a sine
    step psin and its add), the three scalings and three adds of ilp 4."""
    per_step = 2 if kind == "fma" else PSIN_FLOP + 1
    return ilp * k * per_step + 2 * (ilp - 1)


def _chains(x: torch.Tensor, ilp: int):
    if ilp not in _ILP:
        raise ValueError(f"ilp must be 1 or 4, got {ilp}")
    return [x if j == 0 else x * (1.0 / 2**j) for j in range(ilp)]


def _sum(chains):
    out = chains[0]
    for c in chains[1:]:
        out = out + c
    return out


def fma_chain_plain(x: torch.Tensor, x0: torch.Tensor, k: int, a: float,
                    ilp: int = 1) -> torch.Tensor:
    """``k`` steps of ``x <- x * a + x0`` (``ilp`` chains from ``x / 2**j``,
    summed in order) in plain PyTorch."""
    chains = _chains(x, ilp)
    for _ in range(k):
        chains = [c * a + x0 for c in chains]
    return _sum(chains)


def psin_chain_plain(x: torch.Tensor, x0: torch.Tensor, k: int, ilp: int = 1) -> torch.Tensor:
    """``k`` steps of ``x <- psin(x) + x0`` (``ilp`` chains, as
    :func:`fma_chain_plain`) in plain PyTorch, ``psin`` being
    ``ops/fastmath.py``'s polynomial sine (float32 arithmetic for float32)."""
    chains = _chains(x, ilp)
    for _ in range(k):
        chains = [_sin_poly(c) + x0 for c in chains]
    return _sum(chains)


def _check(x: torch.Tensor, x0: torch.Tensor, k: int) -> None:
    if x.dtype != torch.float32 or x0.dtype != torch.float32:
        raise TypeError(f"x and x0 must be float32, got {x.dtype}, {x0.dtype}")
    if x.shape != x0.shape:
        raise ValueError(f"x {tuple(x.shape)} and x0 {tuple(x0.shape)} differ in shape")
    if x.device.type != "cuda" or x0.device != x.device:
        raise ValueError(f"the kernel takes both tensors on one CUDA device: x on {x.device}, "
                         f"x0 on {x0.device}")
    if not (x.is_contiguous() and x0.is_contiguous()):
        raise ValueError("x and x0 must be contiguous")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")


def _symbol(name: str, argtypes):
    """The C function ``name`` of the built library, its types set once."""
    fn = getattr(_build.load("roofline_chain"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, argtypes, x: torch.Tensor, x0: torch.Tensor, *args) -> torch.Tensor:
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = _symbol(symbol, argtypes)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), x0.data_ptr(), out.data_ptr(), x.numel(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    return out


# every entry point starts (x, x0, out, n)
_HEAD = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]


def fma_chain(x: torch.Tensor, x0: torch.Tensor, k: int, a: float, ilp: int = 1) -> torch.Tensor:
    """``k`` FMA steps per element (``ilp`` 1 or 4 chains) -> float32 of
    ``x``'s shape. CPU tensors take :func:`fma_chain_plain`; CUDA tensors
    launch the kernel after checking dtype (float32), shapes, device and
    contiguity, and what it does not take raises."""
    if ilp not in _ILP:
        raise ValueError(f"ilp must be 1 or 4, got {ilp}")
    if x.device.type == "cpu":
        return fma_chain_plain(x, x0, k, a, ilp)
    _check(x, x0, k)
    out = _launch("roofline_fma_chain",
                  _HEAD + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
                  x, x0, k, ilp, a)
    _count(fma_chain, ilp)
    return out


def psin_chain(x: torch.Tensor, x0: torch.Tensor, k: int, ilp: int = 1) -> torch.Tensor:
    """``k`` polynomial-sine steps per element (``ilp`` 1 or 4 chains) ->
    float32 of ``x``'s shape; CPU tensors take :func:`psin_chain_plain`,
    CUDA tensors launch the kernel, as :func:`fma_chain`."""
    if ilp not in _ILP:
        raise ValueError(f"ilp must be 1 or 4, got {ilp}")
    if x.device.type == "cpu":
        return psin_chain_plain(x, x0, k, ilp)
    _check(x, x0, k)
    out = _launch("roofline_psin_chain", _HEAD + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                  x, x0, k, ilp)
    _count(psin_chain, ilp)
    return out


def _count(wrapper, ilp: int) -> None:
    counter = "launches" if ilp == 1 else "launches_ilp4"
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


fma_chain.launches = fma_chain.launches_ilp4 = 0
psin_chain.launches = psin_chain.launches_ilp4 = 0
