"""Serving entry points of the port: resynthesis of control signals and
timbre transfer of audio."""
from .resynthesis import Synthesizer
from .timbre_transfer import (
    ControlAdjustments,
    adjust_controls,
    extract_features,
    stream_timbre_transfer,
    timbre_transfer,
)

__all__ = [
    "Synthesizer",
    "ControlAdjustments",
    "adjust_controls",
    "extract_features",
    "stream_timbre_transfer",
    "timbre_transfer",
]
