"""CREPE pitch estimator (counterpart of the JAX ``models/crepe.py``; the
reference calls torchcrepe 0.0.12: full model, hop 128, 50-2000 Hz,
Viterbi decoding, periodicity as confidence).

* :class:`Crepe`, the CNN of Kim et al. (2018) as an ``nn.Module`` whose
  ``state_dict`` is torchcrepe's (``conv{i}``, ``conv{i}_BN``,
  ``classifier``), so a torchcrepe ``full.pth`` / ``tiny.pth`` loads as it
  is: six (width, 1) convolutions, the first with stride 4, keras 'same'
  pads, ReLU, batch norm (eps 1e-3) and a (2, 1) max-pool each, then a
  time-major flatten, a linear layer and a sigmoid over 360 pitch bins;
* :func:`frame_audio`: centred zero-padded 1024-sample windows, each
  normalised to zero mean and unit std;
* :func:`viterbi_decode`: the band-limited transition prior, a forward
  max-plus recursion keeping argmax pointers, and the backtrack;
  :func:`argmax_decode` and :func:`local_average_cents` (CREPE's
  +-4-bin weighted average);
* :func:`predict`: windows in batches through the CNN, the frequency mask,
  the decoder, periodicity read at the decoded bin.

Weights: ``Crepe().load_state_dict(torch.load(pth))`` for torchcrepe's
files, :func:`from_jax_params` for the JAX package's parameter tree
(numpy arrays, ``convert_torchcrepe_state_dict``'s layout) and
:func:`load_params_npz` for its ``.npz`` cache; :func:`load_weights`
takes either file. The repo holds no pretrained weights.

Everything runs on the tensor's device. The Viterbi recursion is
sequential over frames: on the card it costs three launches a frame (the
scores, their max with its argmax, the observation), where JAX's
``lax.scan`` compiles it into one program; the backtrack composes the
pointer maps by doubling (log2(T) gathers) instead of T sequential steps.
"""
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

WINDOW_SIZE = 1024
N_BINS = 360
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191


def bins_to_cents(bins):
    return CENTS_PER_BIN * bins + CENTS_OFFSET


def cents_to_frequency(cents):
    return 10.0 * 2.0 ** (cents / 1200.0)


def frequency_to_bins(freq):
    cents = 1200.0 * torch.log2(torch.as_tensor(freq) / 10.0)
    return (cents - CENTS_OFFSET) / CENTS_PER_BIN


# capacity multipliers per CREPE size: filters = mult * [32, 4, 4, 4, 8, 16]
CAPACITIES = {"full": 32, "large": 24, "medium": 16, "small": 8, "tiny": 4}
_BASE_FILTERS = (32, 4, 4, 4, 8, 16)
_WIDTHS = (512, 64, 64, 64, 64, 64)
_STRIDES = (4, 1, 1, 1, 1, 1)
# keras 'same' padding for these widths and strides at input length 1024
_PADS = ((254, 254), (31, 32), (31, 32), (31, 32), (31, 32), (31, 32))
_BN_EPS = 1e-3  # keras BatchNormalization epsilon, kept by torchcrepe


class Crepe(nn.Module):
    """The CREPE CNN: ``forward`` maps normalised (B, 1024) windows to
    (B, 360) sigmoid pitch-bin probabilities, batch norm on its running
    statistics (inference only). The layers are torchcrepe's modules, so
    its state dict loads as it is."""

    def __init__(self, capacity: str = "full"):
        super().__init__()
        if capacity not in CAPACITIES:
            raise ValueError(f"unknown CREPE capacity {capacity!r}: one of {sorted(CAPACITIES)}")
        self.capacity = capacity
        self.filters = tuple(CAPACITIES[capacity] * f for f in _BASE_FILTERS)
        in_ch = 1
        for i, (out_ch, width, stride) in enumerate(zip(self.filters, _WIDTHS, _STRIDES), start=1):
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, out_ch, (width, 1), (stride, 1)))
            self.add_module(f"conv{i}_BN", nn.BatchNorm2d(out_ch, eps=_BN_EPS, momentum=0.0))
            in_ch = out_ch
        self.classifier = nn.Linear(4 * self.filters[-1], N_BINS)
        self.eval()

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        """The (width, 1) kernels run on the card as 1-D convolutions on
        their ``weight[..., 0]`` views: for the (W, 1) 2-D layout cuDNN
        picks FFT and complex-GEMM algorithms, up to 7x slower on an H100.
        On the CPU they stay 2-D: there oneDNN's 1-D convolution of the
        1024-channel layer is 12x farther from the float64 result
        (``scripts/torch_crepe_layouts.py``)."""
        x = windows[:, None, :]  # (B, 1, W)
        for i, (lo, hi) in enumerate(_PADS, start=1):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"conv{i}_BN")
            x = F.pad(x, (lo, hi))
            if x.is_cuda:
                x = F.conv1d(x, conv.weight[..., 0], conv.bias, stride=conv.stride[0])
            else:
                x = conv(x[..., None])[..., 0]
            x = F.batch_norm(F.relu(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=bn.eps)
            x = F.max_pool1d(x, 2, 2)
        # torchcrepe flattens time-major: (B, C, W=4) -> (B, 4 * C)
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def from_jax_params(params: Dict, capacity: Optional[str] = None) -> Crepe:
    """The JAX package's CREPE parameter tree (``{"layers": [{"w", "b",
    "bn_scale", "bn_bias", "bn_mean", "bn_var"}] * 6, "classifier": {"w",
    "b"}}``, numpy arrays; conv weights (width, in, out), classifier (in,
    360)) -> a :class:`Crepe` holding them. ``capacity`` defaults to the
    one the first layer's width implies."""
    layers = params["layers"]
    if capacity is None:
        mult = np.shape(layers[0]["w"])[-1] // _BASE_FILTERS[0]
        capacity = {m: c for c, m in CAPACITIES.items()}[mult]
    model = Crepe(capacity)

    def t(v):
        return torch.tensor(np.asarray(v, np.float32))

    sd = {}
    for i, layer in enumerate(layers, start=1):
        sd[f"conv{i}.weight"] = t(layer["w"]).permute(2, 1, 0)[..., None]
        sd[f"conv{i}.bias"] = t(layer["b"])
        sd[f"conv{i}_BN.weight"] = t(layer["bn_scale"])
        sd[f"conv{i}_BN.bias"] = t(layer["bn_bias"])
        sd[f"conv{i}_BN.running_mean"] = t(layer["bn_mean"])
        sd[f"conv{i}_BN.running_var"] = t(layer["bn_var"])
    sd["classifier.weight"] = t(params["classifier"]["w"]).T
    sd["classifier.bias"] = t(params["classifier"]["b"])
    return _load(model, sd)


def _load(model: Crepe, state_dict: Dict) -> Crepe:
    """Load torchcrepe's layout, with or without batch norm's
    ``num_batches_tracked`` counters (eval mode never reads them)."""
    missing, unexpected = model.load_state_dict(
        {k: torch.as_tensor(v).contiguous() for k, v in state_dict.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"not a CREPE {model.capacity!r} state dict: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def load_params_npz(path: str) -> Dict:
    """The JAX package's ``.npz`` cache of converted weights
    (``save_params_npz``: ``layers/<i>/<name>``, ``classifier/<name>``) ->
    its parameter tree of numpy arrays."""
    with np.load(path) as z:
        n_layers = 1 + max(int(k.split("/")[1]) for k in z.files if k.startswith("layers/"))
        layers = [{k.split("/")[2]: z[k] for k in z.files if k.startswith(f"layers/{i}/")}
                  for i in range(n_layers)]
        classifier = {k.split("/")[1]: z[k] for k in z.files if k.startswith("classifier/")}
    return {"layers": layers, "classifier": classifier}


def load_weights(path: str, capacity: str = "full") -> Crepe:
    """A :class:`Crepe` from a torchcrepe ``.pth`` state dict or the JAX
    package's ``.npz`` cache (whose capacity its shapes give)."""
    if path.endswith(".npz"):
        return from_jax_params(load_params_npz(path))
    return _load(Crepe(capacity), torch.load(path, map_location="cpu", weights_only=True))


# ---------------------------------------------------------------------------
# framing (torchcrepe's preprocess)
# ---------------------------------------------------------------------------
def frame_audio(audio: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(T,) audio -> (1 + T // hop, 1024) centred zero-padded windows, each
    mean/std normalised (std floored at 1e-10)."""
    padded = F.pad(audio, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    frames = padded.unfold(-1, WINDOW_SIZE, hop_length)
    mean = frames.mean(dim=-1, keepdim=True)
    std = frames.std(dim=-1, keepdim=True, correction=0)
    return (frames - mean) / torch.clamp(std, min=1e-10)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
def _freq_mask(fmin: float, fmax: float) -> np.ndarray:
    bins = np.arange(N_BINS)
    freqs = cents_to_frequency(bins_to_cents(bins))
    return ((freqs >= fmin) & (freqs <= fmax)).astype(np.float32)


def _log_transition(window: int, device) -> torch.Tensor:
    """log of the row-normalised band prior max(window - |i-j|, 0); the
    1e-20 keeps the band's outside finite (-46), as in JAX."""
    idx = torch.arange(N_BINS, device=device)
    diff = torch.abs(idx[:, None] - idx[None, :]).to(torch.float32)
    transition = torch.clamp(window - diff, min=0.0)
    return torch.log(transition / transition.sum(dim=1, keepdim=True) + 1e-20)


def viterbi_decode(probs: torch.Tensor, window: int = 12) -> torch.Tensor:
    """Most likely bin path through a (T, 360) posteriorgram -> (T,) int64,
    on the posteriorgram's device, with a uniform initial distribution.

    ``torch.max`` over a dimension returns the first index of a tie, as
    ``jnp.argmax`` does, so ties go as in JAX. ``ptrs[t - 1, j]`` is the
    best predecessor (at frame t - 1) of state j at frame t."""
    log_trans = _log_transition(window, probs.device)
    obs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-12)
    log_obs = torch.log(obs + 1e-20)
    t = probs.shape[0]

    delta = log_obs[0] - math.log(float(N_BINS))
    scores = torch.empty((N_BINS, N_BINS), dtype=delta.dtype, device=delta.device)
    best = torch.empty_like(delta)
    ptrs = torch.empty((max(t - 1, 0), N_BINS), dtype=torch.int64, device=delta.device)
    for i in range(1, t):
        torch.add(delta[:, None], log_trans, out=scores)  # scores[i, j] = delta[i] + log_trans[i, j]
        torch.max(scores, dim=0, out=(best, ptrs[i - 1]))
        delta = best + log_obs[i]
    last = torch.argmax(delta).reshape(1)
    if t == 1:
        return last

    # backtrack: maps[t] composes the pointers from frame t + 1 to the last
    # frame, doubling the span each pass: maps[t] <- maps[t] o maps[t + d]
    maps, d = ptrs, 1
    while d < t - 1:
        maps = torch.cat([torch.gather(maps[:-d], 1, maps[d:]), maps[-d:]])
        d *= 2
    return torch.cat([torch.index_select(maps, 1, last)[:, 0], last])


def argmax_decode(probs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(probs, dim=-1)


def local_average_cents(probs: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """CREPE's sub-bin refinement: the probability-weighted mean of cents
    over a +-4-bin neighbourhood of the decoded bin."""
    offsets = torch.arange(-4, 5, device=probs.device)
    idx = torch.clamp(bins[:, None] + offsets[None, :], 0, N_BINS - 1)
    w = torch.gather(probs, -1, idx)
    cents = bins_to_cents(idx.to(torch.float32))
    return (w * cents).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)


# ---------------------------------------------------------------------------
# top-level predict
# ---------------------------------------------------------------------------
def predict(
    model: Crepe,
    audio: torch.Tensor,
    sample_rate: float = 16000,
    hop_length: int = 128,
    fmin: float = 50.0,
    fmax: float = 2000.0,
    batch_size: int = 2048,
    decoder: str = "viterbi",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pitch-track mono 16-kHz audio on the model's device -> (f0 Hz,
    periodicity), each (1 + T // hop,), there.

    cuDNN may run float32 convolutions in TF32 on the card (PyTorch's
    default): TF32 is turned off for the CNN, so the card computes the
    float32 function the CPU does."""
    if sample_rate != 16000:
        raise ValueError("CREPE operates at 16 kHz; resample first")
    device = next(model.parameters()).device
    frames = frame_audio(torch.as_tensor(audio, dtype=torch.float32).to(device), hop_length)
    mask = torch.from_numpy(_freq_mask(fmin, fmax)).to(device)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.no_grad():
            probs = torch.cat([model(frames[s : s + batch_size]) * mask
                               for s in range(0, frames.shape[0], batch_size)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32

    if decoder == "viterbi":
        bins = viterbi_decode(probs)
    elif decoder == "argmax":
        bins = argmax_decode(probs)
    else:
        raise ValueError(f"unknown decoder {decoder!r}")
    f0 = cents_to_frequency(local_average_cents(probs, bins))
    periodicity = torch.gather(probs, -1, bins[:, None])[:, 0]
    return f0, periodicity
