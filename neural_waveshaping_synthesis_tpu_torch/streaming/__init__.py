"""Live streaming synthesis: buffer-by-buffer rendering with carried state
(:class:`StreamingSynth`, :class:`StreamState`) and its pipelined front end
(:class:`PipelinedStreamer`)."""
from .pipeline import PipelinedStreamer
from .synth import StreamingSynth, StreamState, segment_interp

__all__ = ["PipelinedStreamer", "StreamingSynth", "StreamState", "segment_interp"]
