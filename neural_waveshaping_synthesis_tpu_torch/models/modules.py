"""Core learned modules (counterpart of the JAX ``models/modules.py``).

Parameters keep the JAX package's layouts, so one parameter tree drives
both sides of a parity test:

  * dense ``w`` is (in, out) and ``b`` (out,): ``y = x @ w + b``;
  * LayerNorm ``scale``/``bias`` are (C,);
  * the shaper's layer ``w`` is (C, W_in, W_out) and ``b`` (C, W_out);
  * the GRU's ``w_ih`` is (in, 3H), ``w_hh`` (H, 3H), gates (r, z, n).

Each module's ``load_params(tree)`` copies a tree of that layout in (see
``convert/checkpoint.py``) and its ``params()`` returns one, made of the
module's own parameters (views, so autograd and in-place updates reach
them). The GRU runs as ``nn.GRU`` (cuDNN on the
card), so its weights are stored transposed inside and transposed back
on the way in; the JAX package likewise left its GRU to the compiler.
Fresh modules are built on the CPU (move them with ``.to(device)``) and
draw torch's default initialisation, uniform within +-1/sqrt(fan_in),
from the CPU ``generator`` they are given.
"""
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import minigin as gin
from ..ops.fastmath import fast_sin

Params = Dict


def _uniform(shape, bound, generator) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    return nn.Parameter(t.uniform_(-bound, bound, generator=generator))


@torch.no_grad()
def _load(dst: torch.Tensor, src) -> None:
    src = torch.as_tensor(src, dtype=dst.dtype)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


# ---------------------------------------------------------------------------
# dense, FiLM, LayerNorm
# ---------------------------------------------------------------------------
def cast_params(p, dtype: torch.dtype):
    """A parameter tree with every leaf cast to ``dtype`` inside autograd, so
    gradients reach the float32 leaves; a leaf already of ``dtype`` is
    itself (float32 stays the same tensors)."""
    if isinstance(p, dict):
        return {k: cast_params(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [cast_params(v, dtype) for v in p]
    return p.to(dtype)


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., in) -> (..., out): ``x @ w + b``.

    Mixed precision, as JAX ``dense_apply``: the output takes ``x``'s dtype
    and the product is summed in at least float32: ``x``, ``w`` and ``b`` are
    widened to float32 (for float32 a no-op) and the sum rounded once to
    ``x``'s dtype. (A bfloat16 ``matmul`` and then a float32 bias, as the
    harmonic mixer's, would round twice and return float32.)"""
    acc = torch.promote_types(x.dtype, torch.float32)
    return (torch.matmul(x.to(acc), p["w"].to(acc)) + p["b"].to(acc)).to(x.dtype)


def film(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Feature-wise linear modulation: gamma * x + beta."""
    return gamma * x + beta


def layer_norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in float32 (population
    variance, as ``jnp.var``); scaled by the (possibly bfloat16) scale and
    bias in float32 and returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * p["scale"] + p["bias"]).to(x.dtype)


class Dense(nn.Module):
    def __init__(self, in_size: int, out_size: int, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_size)
        self.w = _uniform((in_size, out_size), bound, generator)
        self.b = _uniform((out_size,), bound, generator)

    def params(self) -> Params:
        return {"w": self.w, "b": self.b}

    def load_params(self, p: Params) -> None:
        _load(self.w, p["w"])
        _load(self.b, p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In ``x``'s dtype: a bfloat16 ``x`` takes ``w`` and ``b`` rounded
        to bfloat16 (NEWT's mixer under the model's ``compute_dtype``)."""
        return dense_apply(cast_params(self.params(), x.dtype), x)


class LayerNorm(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def params(self) -> Params:
        return {"scale": self.scale, "bias": self.bias}

    def load_params(self, p: Params) -> None:
        _load(self.scale, p["scale"])
        _load(self.bias, p["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_apply({"scale": self.scale, "bias": self.bias}, x)


# ---------------------------------------------------------------------------
# TimeDistributedMLP
# ---------------------------------------------------------------------------
@gin.configurable
class TimeDistributedMLP(nn.Module):
    """Per-timestep MLP: ``depth`` dense layers with LayerNorm and
    LeakyReLU(0.01) between them; depth >= 3 as in the reference."""

    def __init__(
        self, in_size: int, hidden_size: int, out_size: int, depth: int = 3,
        generator=None,
    ):
        super().__init__()
        if depth < 3:
            raise ValueError("Depth must be at least 3")
        self.dense = nn.ModuleList()
        self.norms = nn.ModuleList()
        for i in range(depth):
            ins = in_size if i == 0 else hidden_size
            outs = hidden_size if i < depth - 1 else out_size
            self.dense.append(Dense(ins, outs, generator))
            if i < depth - 1:
                self.norms.append(LayerNorm(outs))

    def params(self) -> Params:
        layers = []
        for i, dense in enumerate(self.dense):
            layer = {"dense": dense.params()}
            if i < len(self.norms):
                layer["norm"] = self.norms[i].params()
            layers.append(layer)
        return {"layers": layers}

    def load_params(self, p: Params) -> None:
        for i, layer in enumerate(p["layers"]):
            self.dense[i].load_params(layer["dense"])
            if i < len(self.norms):
                self.norms[i].load_params(layer["norm"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T, out), in ``x``'s dtype (the parameters cast
        to it, as JAX casts NEWT's tree under ``compute_dtype``)."""
        return mlp_apply(cast_params(self.params(), x.dtype), x)


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """:class:`TimeDistributedMLP` on a parameter tree of its layout."""
    for layer in p["layers"]:
        x = dense_apply(layer["dense"], x)
        if "norm" in layer:
            x = F.leaky_relu(layer_norm_apply(layer["norm"], x), negative_slope=0.01)
    return x


# ---------------------------------------------------------------------------
# TrainableNonlinearity — the bank of learned scalar waveshapers
# ---------------------------------------------------------------------------
_ACTIVATIONS = {"sine": fast_sin, "sine_exact": torch.sin, "relu": torch.relu}


def shaper_apply(
    p: Params,
    x: torch.Tensor,
    nonlinearity: str = "sine",
    final_nonlinearity: str = "sine",
) -> torch.Tensor:
    """(B, T, C) -> (B, T, C), each channel through its own scalar MLP:
    the JAX einsum form, ``h <- act(einsum("btcw,cwv->btcv", h, w) + b)``.
    A float32 ``x`` with bfloat16 parameters runs in float32, as
    ``jnp.einsum`` promotes (NEWT under bfloat16 at a non-integer hop, whose
    FiLM lerp is float32); torch's einsum would refuse the pair."""
    act, final_act = _ACTIVATIONS[nonlinearity], _ACTIVATIONS[final_nonlinearity]
    h = (x * p["input_scale"])[..., None]  # (B, T, C, 1)
    layers = p["layers"]
    for i, layer in enumerate(layers):
        w = layer["w"]
        dt = torch.promote_types(h.dtype, w.dtype)
        h = torch.einsum("btcw,cwv->btcv", h.to(dt), w.to(dt)) + layer["b"]
        h = act(h) if i < len(layers) - 1 else final_act(h)
    return h[..., 0]


class TrainableNonlinearity(nn.Module):
    """C independent scalar shaping functions, each a width-W MLP
    1 -> W -> ... -> 1 (``input_scale`` drawn randn*10, as the reference)."""

    def __init__(
        self, channels: int, width: int, depth: int = 3,
        nonlinearity: str = "sine", final_nonlinearity: str = "sine",
        generator=None,
    ):
        super().__init__()
        self.channels, self.width, self.depth = channels, width, depth
        self.nonlinearity, self.final_nonlinearity = nonlinearity, final_nonlinearity
        scale = torch.randn(channels, generator=generator) * 10.0
        self.input_scale = nn.Parameter(scale)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for i in range(depth):
            w_in = 1 if i == 0 else width
            w_out = width if i < depth - 1 else 1
            bound = 1.0 / math.sqrt(w_in)
            self.weights.append(_uniform((channels, w_in, w_out), bound, generator))
            self.biases.append(_uniform((channels, w_out), bound, generator))

    def params(self) -> Params:
        """The parameters as a tree in the JAX layout (views, not copies)."""
        return {
            "input_scale": self.input_scale,
            "layers": [{"w": w, "b": b} for w, b in zip(self.weights, self.biases)],
        }

    def load_params(self, p: Params) -> None:
        _load(self.input_scale, p["input_scale"])
        for i, layer in enumerate(p["layers"]):
            _load(self.weights[i], layer["w"])
            _load(self.biases[i], layer["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return shaper_apply(self.params(), x, self.nonlinearity, self.final_nonlinearity)

    def bake_table(self, table_size: int, table_min: float, table_max: float) -> torch.Tensor:
        """Each channel's shaper sampled on a uniform grid of ``table_size``
        points over [table_min, table_max] -> contiguous (table_size, C),
        on the parameters' device: the FastNEWT lookup table, ``input_scale``
        included (the grid goes in as the shaper's input)."""
        grid = torch.linspace(
            table_min, table_max, table_size, device=self.input_scale.device
        )
        return self(grid[None, :, None].expand(1, table_size, self.channels))[0].contiguous()


# ---------------------------------------------------------------------------
# GRU + ControlModule
# ---------------------------------------------------------------------------
class GRU(nn.Module):
    """Single-layer batch-first GRU with torch gate order (r, z, n).

    Loads JAX-layout weights (``w_ih`` (in, 3H), ``w_hh`` (H, 3H)) into
    an ``nn.GRU``, which runs the recurrence (cuDNN on the card)."""

    def __init__(self, input_size: int, hidden_size: int, generator=None):
        super().__init__()
        self.rnn = nn.GRU(input_size, hidden_size, batch_first=True)
        bound = 1.0 / math.sqrt(hidden_size)
        with torch.no_grad():
            for w in self.rnn.parameters():
                w.uniform_(-bound, bound, generator=generator)

    def params(self) -> Params:
        rnn = self.rnn
        return {"w_ih": rnn.weight_ih_l0.T, "w_hh": rnn.weight_hh_l0.T,
                "b_ih": rnn.bias_ih_l0, "b_hh": rnn.bias_hh_l0}

    def load_params(self, p: Params) -> None:
        _load(self.rnn.weight_ih_l0, torch.as_tensor(p["w_ih"]).T)
        _load(self.rnn.weight_hh_l0, torch.as_tensor(p["w_hh"]).T)
        _load(self.rnn.bias_ih_l0, p["b_ih"])
        _load(self.rnn.bias_hh_l0, p["b_hh"])

    def forward(
        self, x: torch.Tensor, h0: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, in) -> ((B, T, H), final h (B, H))."""
        ys, h_n = self.rnn(x, None if h0 is None else h0[None])
        return ys, h_n[0]


@gin.configurable
class ControlModule(nn.Module):
    """GRU(control_size -> hidden) + dense projection to the embedding."""

    def __init__(
        self, control_size: int = 2, hidden_size: int = 128, embedding_size: int = 128,
        generator=None,
    ):
        super().__init__()
        self.gru = GRU(control_size, hidden_size, generator)
        self.proj = Dense(hidden_size, embedding_size, generator)

    def params(self) -> Params:
        return {"gru": self.gru.params(), "proj": self.proj.params()}

    def load_params(self, p: Params) -> None:
        self.gru.load_params(p["gru"])
        self.proj.load_params(p["proj"])

    def forward(
        self, control: torch.Tensor, h0: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, control_size) -> ((B, T, E), final GRU state (B, H))."""
        ys, h_final = self.gru(control, h0)
        return self.proj(ys), h_final


__all__: List[str] = [
    "Dense",
    "LayerNorm",
    "TimeDistributedMLP",
    "TrainableNonlinearity",
    "GRU",
    "ControlModule",
    "cast_params",
    "dense_apply",
    "film",
    "layer_norm_apply",
    "mlp_apply",
    "shaper_apply",
]
