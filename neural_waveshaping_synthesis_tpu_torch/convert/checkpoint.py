"""Carry weights into the port, and out of it.

* :func:`load_checkpoint` reads a reference PyTorch Lightning ``.ckpt``
  (without ``pytorch_lightning`` installed: a stub meta-path finder
  satisfies the pickle's class references) and maps its 52 tensors into
  the JAX package's parameter layout, with the ``data_mean.npy`` /
  ``data_std.npy`` normalisation statistics beside it.
* :func:`params_from_jax` takes the JAX package's parameter tree (numpy
  arrays or anything ``torch.as_tensor`` takes) and returns the same
  tree of float32 CPU tensors.

* :func:`save_reference_checkpoint` writes the other direction: a
  parameter tree (``NeuralWaveshaping.params()``) as a reference-format
  PL ``.ckpt`` with the 52-tensor state_dict naming, which
  :func:`load_checkpoint`, the JAX package and the reference all load.

The port's state is a nested dict of tensors in the JAX layouts, which
``NeuralWaveshaping.load_params`` copies in —

  reference (torch) layout             port / JAX layout
  ------------------------------------------------------------------
  Conv1d(k=1) weight (out, in, 1)      dense w (in, out)      [transpose]
  GRU weight_ih_l0 (3H, in)            gru w_ih (in, 3H)      [transpose]
  grouped Conv1d (C*W_out, W_in, 1)    (C, W_in, W_out)       [reshape+transpose]
  LayerNorm weight/bias (C,)           scale/bias (C,)        [copy]
  reverb.ir (1, N)                     ir (N,)                [squeeze]

This module keeps its own copy of the JAX package's converters
(``convert/from_torch.py``, ``convert/to_torch.py``): the port imports
nothing of that package.
"""
import importlib.abc
import importlib.machinery
import math
import os
import sys
import types
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class _StubLoader(importlib.abc.Loader):
    def create_module(self, spec):
        mod = types.ModuleType(spec.name)
        mod.__path__ = []

        def getattr_(attr, _name=spec.name):
            # dunder lookups (__file__, __spec__, ...) must fail as on a real
            # module: inspect walks sys.modules and reads them
            if attr.startswith("__"):
                raise AttributeError(attr)
            return type(attr, (dict,), {"__module__": _name})

        mod.__getattr__ = getattr_
        return mod

    def exec_module(self, module):
        pass


class _StubFinder(importlib.abc.MetaPathFinder):
    """Satisfies pickle references to pytorch_lightning.* container
    classes (AttributeDict etc.) with dict subclasses."""

    def find_spec(self, name, path=None, target=None):
        if name == "pytorch_lightning" or name.startswith("pytorch_lightning."):
            return importlib.machinery.ModuleSpec(name, _StubLoader())
        return None


# Keys a Lightning checkpoint uses for the training state, under which the
# port's Trainer saves its own (see ``Trainer.save_checkpoint``).
TRAINING_STATE_KEYS = ("optimizer_states", "lr_schedulers", "val_loss")


def load_lightning_checkpoint(path: str) -> Dict:
    """Load a PL checkpoint file into a plain dict of numpy arrays.

    The file is unpickled (``weights_only=False``): load only checkpoints
    from a source you trust, such as the ones this repository ships.
    Without ``pytorch_lightning`` installed, stub modules stand in for it
    during the unpickling only: left in place, they would answer every
    later ``import pytorch_lightning`` (torch probes for it) with a module
    that is not one. Whether the package is installed is asked of the path
    finder alone, not by importing it: another stub finder on
    ``sys.meta_path`` (the JAX package's loader leaves one) would answer the
    import with a stub that stays."""
    finder = None
    if importlib.machinery.PathFinder.find_spec("pytorch_lightning") is None:
        finder = _StubFinder()
        sys.meta_path.insert(0, finder)
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if finder is not None:
            sys.meta_path.remove(finder)
            for name in [n for n in sys.modules if n.split(".")[0] == "pytorch_lightning"]:
                del sys.modules[name]
    state = {k: v.detach().numpy() for k, v in ckpt["state_dict"].items()}
    out = {
        "state_dict": state,
        "hyper_parameters": dict(ckpt.get("hyper_parameters") or {}),
        "epoch": ckpt.get("epoch"),
        "global_step": ckpt.get("global_step"),
    }
    # the training state a port checkpoint carries beside the weights
    # (training/trainer.py), where present
    out.update({k: ckpt[k] for k in TRAINING_STATE_KEYS if k in ckpt})
    return out


def _dense(sd, prefix):
    """torch Conv1d(k=1) (out, in, 1) -> {w: (in, out), b: (out,)}."""
    return {"w": sd[f"{prefix}.weight"][:, :, 0].T, "b": sd[f"{prefix}.bias"]}


def _layer_norm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _td_mlp(sd, prefix, depth):
    """TimeDistributedMLP: torch Sequential indices 0,3,6,... are convs;
    1,4,7,... are TimeDistributedLayerNorm."""
    layers = []
    for i in range(depth):
        layer = {"dense": _dense(sd, f"{prefix}.net.{i * 3}")}
        if i < depth - 1:
            layer["norm"] = _layer_norm(sd, f"{prefix}.net.{i * 3 + 1}.layer_norm")
        layers.append(layer)
    return {"layers": layers}


def _grouped_shaper(sd, prefix, channels, depth):
    """TrainableNonlinearity: grouped Conv1d weights (C*W_out, W_in, 1),
    output channel o in group o // W_out -> (C, W_in, W_out)."""
    params = {"input_scale": sd[f"{prefix}.input_scale"][0, :, 0]}
    layers = []
    for i in range(depth):
        w = sd[f"{prefix}.net.{i * 2}.weight"]  # conv, act, conv, act, ...
        b = sd[f"{prefix}.net.{i * 2}.bias"]
        w_out, w_in = w.shape[0] // channels, w.shape[1]
        layers.append({
            "w": w[:, :, 0].reshape(channels, w_out, w_in).transpose(0, 2, 1),
            "b": b.reshape(channels, w_out),
        })
    params["layers"] = layers
    return params


def convert_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """Reference state_dict (52 tensors of the shipped architecture: 64
    shapers of depth 4, MLPs of depth 4) -> numpy tree in the JAX layout."""
    return {
        "embedding": {
            "gru": {
                "w_ih": sd["embedding.gru.weight_ih_l0"].T,
                "w_hh": sd["embedding.gru.weight_hh_l0"].T,
                "b_ih": sd["embedding.gru.bias_ih_l0"],
                "b_hh": sd["embedding.gru.bias_hh_l0"],
            },
            "proj": _dense(sd, "embedding.proj"),
        },
        "harmonic_mixer": _dense(sd, "harmonic_mixer"),
        "newt": {
            "mlp": _td_mlp(sd, "newt.mlp", 4),
            "shaping_fn": _grouped_shaper(sd, "newt.shaping_fn", 64, 4),
            "mixer": _dense(sd, "newt.mixer.0"),
        },
        "h_generator": _td_mlp(sd, "h_generator", 4),
        "reverb": {"ir": sd["reverb.ir"][0]},
    }


def params_from_jax(tree) -> Dict:
    """A JAX-layout parameter tree (nested dicts/lists of arrays) -> the
    same tree of contiguous float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32))


def load_checkpoint(
    ckpt_path: str, stats_dir: Optional[str] = None
) -> Tuple[Dict, Dict, Optional[np.ndarray], Optional[np.ndarray]]:
    """-> (port state, hparams, data_mean, data_std).

    The normalisation statistics are read from ``data_mean.npy`` /
    ``data_std.npy`` in ``stats_dir`` (default: beside the checkpoint);
    each is None when its file is absent."""
    ckpt = load_lightning_checkpoint(ckpt_path)
    params = params_from_jax(convert_state_dict(ckpt["state_dict"]))
    stats_dir = stats_dir or os.path.dirname(ckpt_path)
    stats = []
    for name in ("data_mean.npy", "data_std.npy"):
        path = os.path.join(stats_dir, name)
        stats.append(np.load(path) if os.path.exists(path) else None)
    return params, ckpt["hyper_parameters"], stats[0], stats[1]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _to_conv1d(prefix: str, dense: Dict, out: Dict) -> None:
    """dense {w: (in, out), b: (out,)} -> torch Conv1d (out, in, 1)."""
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(dense["w"]).T)[:, :, None]
    out[f"{prefix}.bias"] = _np(dense["b"])


def _to_td_mlp(prefix: str, mlp: Dict, out: Dict) -> None:
    depth = len(mlp["layers"])
    for i, layer in enumerate(mlp["layers"]):
        _to_conv1d(f"{prefix}.net.{i * 3}", layer["dense"], out)
        if i < depth - 1:
            norm = f"{prefix}.net.{i * 3 + 1}.layer_norm"
            out[f"{norm}.weight"] = _np(layer["norm"]["scale"])
            out[f"{norm}.bias"] = _np(layer["norm"]["bias"])


def _to_grouped_shaper(prefix: str, shaper: Dict, out: Dict) -> None:
    """(C, W_in, W_out) planes -> grouped Conv1d (C*W_out, W_in, 1)."""
    out[f"{prefix}.input_scale"] = _np(shaper["input_scale"])[None, :, None]
    for i, layer in enumerate(shaper["layers"]):
        w, b = _np(layer["w"]), _np(layer["b"])
        c, w_in, w_out = w.shape
        out[f"{prefix}.net.{i * 2}.weight"] = np.ascontiguousarray(
            w.transpose(0, 2, 1).reshape(c * w_out, w_in)
        )[:, :, None]
        out[f"{prefix}.net.{i * 2}.bias"] = b.reshape(c * w_out)


def params_to_reference_state_dict(
    params: Dict, n_harmonics: int = 101, ir_window: int = 256
) -> Dict[str, np.ndarray]:
    """Parameter tree (JAX layout; tensors or arrays) -> the reference's
    state_dict as numpy arrays, with its recomputed non-learnable buffers
    (harmonic_axis, rand_phase, window, initial_zero)."""
    sd: Dict[str, np.ndarray] = {}
    gru = params["embedding"]["gru"]
    sd["embedding.gru.weight_ih_l0"] = np.ascontiguousarray(_np(gru["w_ih"]).T)
    sd["embedding.gru.weight_hh_l0"] = np.ascontiguousarray(_np(gru["w_hh"]).T)
    sd["embedding.gru.bias_ih_l0"] = _np(gru["b_ih"])
    sd["embedding.gru.bias_hh_l0"] = _np(gru["b_hh"])
    _to_conv1d("embedding.proj", params["embedding"]["proj"], sd)
    sd["osc.harmonic_axis"] = np.arange(1, n_harmonics + 1, dtype=np.int64)[None, :, None]
    sd["osc.rand_phase"] = np.full((1, n_harmonics, 1), math.tau, np.float32)
    _to_conv1d("harmonic_mixer", params["harmonic_mixer"], sd)
    _to_td_mlp("newt.mlp", params["newt"]["mlp"], sd)
    _to_grouped_shaper("newt.shaping_fn", params["newt"]["shaping_fn"], sd)
    _to_conv1d("newt.mixer.0", params["newt"]["mixer"], sd)
    _to_td_mlp("h_generator", params["h_generator"], sd)
    k = np.arange(ir_window)  # torch.hann_window's periodic default
    sd["noise_synth.window"] = (0.5 - 0.5 * np.cos(2.0 * np.pi * k / ir_window)).astype(np.float32)
    sd["reverb.ir"] = _np(params["reverb"]["ir"])[None, :]
    sd["reverb.initial_zero"] = np.zeros((1, 1), np.float32)
    return sd


def save_reference_checkpoint(
    params: Dict,
    path: str,
    hparams: Optional[Dict] = None,
    step: int = 0,
    epoch: int = 0,
    extra: Optional[Dict] = None,
) -> None:
    """Write a reference-format ``.ckpt``: the PL dict format with plain
    containers only, so no ``pytorch_lightning`` is needed to read it.
    ``extra`` adds top-level keys (the Trainer's training state). The file
    is written beside ``path`` and renamed into place, so a reader never
    sees half of one."""
    sd = params_to_reference_state_dict(params)
    ckpt = {
        "state_dict": {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
        "hyper_parameters": hparams
        or {
            "n_waveshapers": 64,
            "control_hop": 128,
            "sample_rate": 16000,
            "learning_rate": 0.001,
            "lr_decay": 0.9,
            "lr_decay_interval": 10000,
        },
        "epoch": epoch,
        "global_step": step,
        "pytorch-lightning_version": "1.1.2",
        **(extra or {}),
    }
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
