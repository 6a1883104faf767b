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
  launches of its float32 instance, ``.launches_bf16`` those of its bf16-x
  instance. Forward only, as in JAX;
* :func:`_lookup_path` chooses the kernel's path for a launch: ``"vec4"``
  (16-B accesses of 4 channels) or ``"scalar"`` (one channel a thread),
  both branches of the one kernel, bit for bit the same.

The table is float32 always; x is float32 or bfloat16 (NEWT under the
model's ``compute_dtype = "bfloat16"``), and the output float32. On a bf16 x
the index arithmetic runs in bf16 as in the JAX model's lookup (XLA's type
promotion: ``x - min``, ``S * (...)``, ``/ span`` and ``idx - lower`` each
rounded to bf16) and the interpolation in float32 against the table, so the
bf16 index may sit bins away from the float32 one; the kernel's bf16
instance computes the same bits.
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
    by a host scalar multiplies by its reciprocal instead).

    The index is computed in x's dtype (each operation rounded to bf16 for a
    bf16 x, as the JAX lookup does) and its floor clamped in float32 before
    the conversion; ``idx - lower`` takes lower back in x's dtype (a clamped
    4095 is 4096 in bf16, as JAX's ``lower.astype(idx.dtype)``); the result
    is in the table's float32."""
    s, c = table.shape
    span = torch.full((), SPAN, dtype=x.dtype, device=x.device)
    idx = (s * (x - TABLE_MIN)) / span
    lower = torch.clamp(torch.floor(idx).float(), 0, s - 1).to(torch.int64)
    upper = torch.clamp(lower + 1, max=s - 1)
    lo = torch.take_along_dim(table, lower.reshape(-1, c), dim=0).reshape(x.shape)
    hi = torch.take_along_dim(table, upper.reshape(-1, c), dim=0).reshape(x.shape)
    return (hi - lo) * (idx - lower.to(idx.dtype)) + lo


# x's dtype -> the C symbol's suffix of its instance (the table is float32)
_INSTANCES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check(table: torch.Tensor, x: torch.Tensor) -> str:
    """Checks what the kernel takes; -> the suffix of the instance."""
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if x.dtype not in _INSTANCES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
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
    return _INSTANCES[x.dtype]


def _lookup_path(x: torch.Tensor, out: torch.Tensor) -> str:
    """The kernel's path for this launch: ``"vec4"`` where C is a multiple
    of 4, x starts on 4 of its elements (16 bytes for float32, 8 for bf16)
    and the float32 out on 16 bytes (a thread then moves 4 channels by one
    load and one 16-B store), else ``"scalar"`` (C = 5, or a view at an odd
    storage offset). The table is gathered 4 bytes at a time on either path,
    so its alignment does not matter."""
    aligned = x.data_ptr() % (4 * x.element_size()) == 0 and out.data_ptr() % 16 == 0
    return "vec4" if x.shape[-1] % 4 == 0 and aligned else "scalar"


def _launch(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    instance = _check(table, x)
    symbol = "fast_newt_lookup_rows" + instance
    out = torch.empty_like(x, dtype=torch.float32)
    s, c = table.shape
    with torch.cuda.device(x.device):
        lib = _build.load("fast_newt_lookup")
        fn = getattr(lib, symbol)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(x.device).cuda_stream
        vec4 = _lookup_path(x, out) == "vec4"
        err = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), x.numel() // c, s, c, int(vec4),
                 TABLE_MIN, SPAN, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} did not launch: CUDA error {err}")
    counter = "launches" + instance
    setattr(fast_newt_lookup, counter, getattr(fast_newt_lookup, counter) + 1)
    return out


def fast_newt_lookup(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S, C) table, (..., C) x -> (..., C) interpolated lookups.

    x on the CPU takes :func:`fast_newt_lookup_plain` (the table must be
    there too). x on CUDA launches the kernel on the current stream after
    checking device, dtype (a float32 table; a float32 or bfloat16 x: its
    two instances), shapes and contiguity; what it does not take raises, and
    so does a call that would need a gradient (the kernel has none, as the
    JAX one has none). The output is float32."""
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
fast_newt_lookup.launches_bf16 = 0
