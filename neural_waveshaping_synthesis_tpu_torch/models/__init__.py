"""The NEWT synthesizer and its submodules, as ``nn.Module``s whose
parameters keep the JAX package's layouts."""
from .generators import FIRNoiseSynth, HarmonicOscillator, Reverb
from .modules import (
    GRU,
    ControlModule,
    Dense,
    LayerNorm,
    TimeDistributedMLP,
    TrainableNonlinearity,
    dense_apply,
    film,
    layer_norm_apply,
    shaper_apply,
)
from .neural_waveshaping import NeuralWaveshaping
from .newt import NEWT

__all__ = [
    "FIRNoiseSynth",
    "HarmonicOscillator",
    "Reverb",
    "GRU",
    "ControlModule",
    "Dense",
    "LayerNorm",
    "TimeDistributedMLP",
    "TrainableNonlinearity",
    "dense_apply",
    "film",
    "layer_norm_apply",
    "shaper_apply",
    "NeuralWaveshaping",
    "NEWT",
]
