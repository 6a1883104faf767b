"""Serving entry points of the port."""
from .resynthesis import Synthesizer, adjust_controls

__all__ = ["Synthesizer", "adjust_controls"]
