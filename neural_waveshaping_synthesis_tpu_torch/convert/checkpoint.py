"""Carry weights into the port.

* :func:`load_checkpoint` reads a reference PyTorch Lightning ``.ckpt``
  (without ``pytorch_lightning`` installed: a stub meta-path finder
  satisfies the pickle's class references) and maps its 52 tensors into
  the JAX package's parameter layout, with the ``data_mean.npy`` /
  ``data_std.npy`` normalisation statistics beside it.
* :func:`params_from_jax` takes the JAX package's parameter tree (numpy
  arrays or anything ``torch.as_tensor`` takes) and returns the same
  tree of float32 CPU tensors.

Both return the port's state: a nested dict of tensors in the JAX
layouts, which ``NeuralWaveshaping.load_params`` copies in —

  reference (torch) layout             port / JAX layout
  ------------------------------------------------------------------
  Conv1d(k=1) weight (out, in, 1)      dense w (in, out)      [transpose]
  GRU weight_ih_l0 (3H, in)            gru w_ih (in, 3H)      [transpose]
  grouped Conv1d (C*W_out, W_in, 1)    (C, W_in, W_out)       [reshape+transpose]
  LayerNorm weight/bias (C,)           scale/bias (C,)        [copy]
  reverb.ir (1, N)                     ir (N,)                [squeeze]

This module keeps its own copy of the JAX package's converter
(``convert/from_torch.py``): the port imports nothing of that package.
"""
import importlib.abc
import importlib.machinery
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


def load_lightning_checkpoint(path: str) -> Dict:
    """Load a PL checkpoint file into a plain dict of numpy arrays.

    The file is unpickled (``weights_only=False``): load only checkpoints
    from a source you trust, such as the ones this repository ships."""
    try:
        import pytorch_lightning  # noqa: F401
    except ImportError:
        if not any(isinstance(f, _StubFinder) for f in sys.meta_path):
            sys.meta_path.insert(0, _StubFinder())
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = {k: v.detach().numpy() for k, v in ckpt["state_dict"].items()}
    return {
        "state_dict": state,
        "hyper_parameters": dict(ckpt.get("hyper_parameters") or {}),
        "epoch": ckpt.get("epoch"),
        "global_step": ckpt.get("global_step"),
    }


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
