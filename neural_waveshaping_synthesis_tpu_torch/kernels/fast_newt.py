"""FastNEWT table lookup: the CUDA kernel, its plain PyTorch version and
the wrapper that chooses between them.

Counterpart of the JAX ``kernels/fast_newt.py`` ``fast_newt_lookup_pallas``
(and of the XLA ``models/newt.py`` ``fast_newt_lookup``, the same
arithmetic). FastNEWT bakes each of the C learned shapers into an (S, C)
table (``NEWT.bake_lookup_table``) and replaces the shaper MLP by a
per-channel linear interpolation into it:

    idx   = S * (x - min) / (max - min)     # S, not S - 1: the reference's quirk
    lower = clamp(floor(idx), 0, S - 1);  upper = min(lower + 1, S - 1)
    out   = (table[upper] - table[lower]) * (idx - lower) + table[lower]

so below ``min`` the first two entries extrapolate and above ``max`` the
result is ``table[S - 1]``. The range [min, max] is [-3, 3], the
reference's, for the bake and the lookup alike.

* :func:`fast_newt_lookup_plain` is that arithmetic in PyTorch, in the
  kernel's order (the CPU path and the tests use it; ``chip_smoke.py``
  holds the kernel against it on the card, bit for bit);
* :func:`fast_newt_lookup` is the wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor launches ``csrc/fast_newt_lookup.cu`` or raises
  (there is no fallback). ``fast_newt_lookup.launches`` counts the
  launches. Forward only, as in JAX;
* :func:`_lookup_path` chooses the kernel's path for a launch: ``"vec4"``
  (16-B accesses of 4 channels) or ``"scalar"`` (one channel a thread),
  both branches of the one kernel, bit for bit the same.
"""
import ctypes

import torch

from . import _build

TABLE_MIN, TABLE_MAX = -3.0, 3.0
SPAN = TABLE_MAX - TABLE_MIN  # a Python float, rounded once to float32 where used, as in JAX
_MAX_ROWS = 1 << 31  # rows N and table entries S*C: the kernel's 32-bit indices


def fast_newt_lookup_plain(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S, C) table, (..., C) x -> (..., C), in plain PyTorch. The divisor
    is a tensor on x's device, so the card divides (PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal instead)."""
    s, c = table.shape
    span = torch.full((), SPAN, dtype=x.dtype, device=x.device)
    idx = (s * (x - TABLE_MIN)) / span
    lower_f = torch.clamp(torch.floor(idx), 0, s - 1)
    lower = lower_f.to(torch.int64)
    upper = torch.clamp(lower + 1, max=s - 1)
    lo = torch.take_along_dim(table, lower.reshape(-1, c), dim=0).reshape(x.shape)
    hi = torch.take_along_dim(table, upper.reshape(-1, c), dim=0).reshape(x.shape)
    return (hi - lo) * (idx - lower_f) + lo


def _check(table: torch.Tensor, x: torch.Tensor) -> None:
    for name, t in (("table", table), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("table", table), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError(f"the kernel takes both tensors on one CUDA device: "
                         f"table on {table.device}, x on {x.device}")
    if table.dim() != 2 or table.shape[0] < 2 or table.shape[1] < 1:
        raise ValueError(f"table must be (S >= 2, C >= 1), got {tuple(table.shape)}")
    if x.dim() < 1 or x.shape[-1] != table.shape[1]:
        raise ValueError(f"x must be (..., {table.shape[1]}), got {tuple(x.shape)}")
    if table.shape[0] >= 1 << 24:
        raise ValueError("S must stay below 2^24, where float32 indices are exact")
    n_rows = x.numel() // x.shape[-1]
    if n_rows >= _MAX_ROWS or table.numel() >= _MAX_ROWS:
        raise ValueError(f"the kernel indexes rows and table entries in 32 bits: need N and "
                         f"S*C below {_MAX_ROWS}, got N = {n_rows}, S*C = {table.numel()}")


def _lookup_path(x: torch.Tensor, out: torch.Tensor) -> str:
    """The kernel's path for this launch: ``"vec4"`` where C is a multiple
    of 4 and x and out start on 16 bytes (a thread then moves 4 channels by
    one 16-B load and one 16-B store), else ``"scalar"`` (C = 5, or a view
    at an odd storage offset). The table is gathered 4 bytes at a time on
    either path, so its alignment does not matter."""
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return "vec4" if x.shape[-1] % 4 == 0 and aligned else "scalar"


def _launch(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _check(table, x)
    out = torch.empty_like(x)
    s, c = table.shape
    with torch.cuda.device(x.device):
        lib = _build.load("fast_newt_lookup")
        fn = lib.fast_newt_lookup_rows
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(x.device).cuda_stream
        vec4 = _lookup_path(x, out) == "vec4"
        err = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), x.numel() // c, s, c, int(vec4),
                 TABLE_MIN, SPAN, stream)
    if err != 0:
        raise RuntimeError(f"fast_newt_lookup_rows did not launch: CUDA error {err}")
    fast_newt_lookup.launches += 1
    return out


def fast_newt_lookup(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S, C) table, (..., C) x -> (..., C) interpolated lookups.

    x on the CPU takes :func:`fast_newt_lookup_plain` (the table must be
    there too). x on CUDA launches the kernel on the current stream after
    checking device, dtype (float32), shapes and contiguity; what it does
    not take raises, and so does a call that would need a gradient (the
    kernel has none, as the JAX one has none)."""
    if x.device.type == "cpu":
        if table.device != x.device:
            raise ValueError(f"table is on {table.device}, x on {x.device}")
        return fast_newt_lookup_plain(table, x)
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad):
        raise ValueError(
            "the lookup kernel is forward only: call it under torch.no_grad() "
            "or torch.inference_mode()"
        )
    return _launch(table, x)


fast_newt_lookup.launches = 0
